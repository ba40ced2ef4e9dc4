"""Offline dataset validator.

The port's copy of ``nrse_tpu/utils/preprocess_audio_files.py:21-88``, on
the port's ``audio/io.py``: ``preprocess_audio_files`` scans a corpus and
flags files that are too short (< 0.1 s), hold NaN or Inf, or are
near-silent (``check_abnormal_values``), as the reference's
``src/utils/preprocess_audio_files.py:5,52`` does; the log scraper and the
list pruner are the reference's ``labels/processed/
remove_problematic_files.py``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from nrse_tpu_torch.audio.io import get_audio_files, load_audio
from nrse_tpu_torch.utils.logging_utils import logger


def check_abnormal_values(waveform: np.ndarray) -> Optional[str]:
    """Reason string when a decoded waveform is unhealthy, else None."""
    if np.isnan(waveform).any():
        return "contains NaN"
    if np.isinf(waveform).any():
        return "contains Inf"
    if np.abs(waveform).max() < 1e-6:
        return "near-silent"
    return None


def preprocess_audio_files(directory: str, min_duration_s: float = 0.1,
                           ) -> Tuple[List[str], Dict[str, str]]:
    """Scan a corpus; returns (healthy_files, {bad_file: reason})."""
    files = get_audio_files(directory)
    good: List[str] = []
    bad: Dict[str, str] = {}
    for path in files:
        try:
            wav, sr = load_audio(path)
        except Exception as e:
            bad[path] = f"decode error: {e}"
            continue
        if wav.shape[-1] < min_duration_s * sr:
            bad[path] = f"too short ({wav.shape[-1] / sr:.3f}s)"
            continue
        reason = check_abnormal_values(wav)
        if reason:
            bad[path] = reason
            continue
        good.append(path)
    logger.info(
        f"scanned {len(files)} files: {len(good)} healthy, {len(bad)} flagged"
    )
    for path, reason in bad.items():
        logger.warning(f"flagged {path}: {reason}")
    return good, bad


def scrape_problematic_files_from_logs(log_paths: List[str]) -> List[str]:
    """Extract filenames from 'Error loading audio file <path>' log lines
    (equivalent of ``remove_problematic_files.py:116-146``)."""
    pattern = re.compile(r"Error loading audio file ([^\s:]+)")
    found: List[str] = []
    for log_path in log_paths:
        if not os.path.exists(log_path):
            continue
        with open(log_path, errors="replace") as f:
            for line in f:
                m = pattern.search(line)
                if m:
                    found.append(m.group(1))
    return sorted(set(found))


def prune_label_list(list_path: str, out_path: str,
                     problematic: List[str]) -> int:
    """Remove label-list lines referencing known-bad files; returns kept."""
    bad_basenames = {os.path.basename(p) for p in problematic}
    kept = 0
    with open(list_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            path = line.split(";")[0].strip()
            if os.path.basename(path) in bad_basenames:
                continue
            fout.write(line)
            kept += 1
    return kept
