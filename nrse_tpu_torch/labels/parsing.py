"""MSP-Podcast labels: the two emotion orderings, semicolon label lists
and the consensus CSV.

The port's copy of ``nrse_tpu/labels/parsing.py:33-290``:

  * ``VALID_EMOTIONS_MAP`` — the NRSE ordering A,H,S,F,U,D,C,N of the SER
    trainers (reference ``src/data/emotion_dataset.py:13-22``), and
    ``EMOTIONS_MAP``, the same with X → 8 and O → 9;
  * ``BASELINE_EMOTIONS_MAP`` — the Odyssey-2024 challenge ordering
    A,S,H,U,F,D,C,N (``baseline/eval_cat_ser_weighted_with_list.py:
    86-96``);
  * the list parser (reference ``baseline/eval_cat_ser_weighted_with_list.
    py:57-120``; list fixtures under ``labels/*.txt``): one row per line,
    ``path; EmoClass; A:x; V:y; D:z;``, the emotion indexed in the
    challenge ordering unless another map is given;
  * :func:`clean_filename`, the offline scorer's normalisation of
    augmented file names (``src/metrics/categorical_metrics.py:51-58``);
  * the label tools' helpers (``labels/tools.py``): writing a list back,
    dropping the X/O rows of a list or of ``labels_consensus.csv``, and
    semicolon lists → the baseline's one-hot CSV with the split looked up
    by base name.  The JAX package reads and writes the CSVs with pandas,
    which the card's machine lacks; here the ``csv`` module does, and the
    files hold the same table (a kept consensus row keeps its text as it
    was; pandas writes its numbers back in its own format).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# NRSE ordering (reference src/data/emotion_dataset.py:13-22)
VALID_EMOTIONS_MAP: Dict[str, int] = {
    "A": 0,  # Anger
    "H": 1,  # Happiness
    "S": 2,  # Sadness
    "F": 3,  # Fear
    "U": 4,  # Surprise
    "D": 5,  # Disgust
    "C": 6,  # Contempt
    "N": 7,  # Neutral
}
INVALID_EMOTIONS_MAP: Dict[str, int] = {
    "X": 8,  # No agreement
    "O": 9,  # Other
}
EMOTIONS_MAP: Dict[str, int] = {**VALID_EMOTIONS_MAP, **INVALID_EMOTIONS_MAP}

# Odyssey-2024 challenge ordering (reference baseline/...:86-96)
BASELINE_EMOTIONS_MAP: Dict[str, int] = {
    "A": 0,  # Anger
    "S": 1,  # Sadness
    "H": 2,  # Happiness
    "U": 3,  # Surprise
    "F": 4,  # Fear
    "D": 5,  # Disgust
    "C": 6,  # Contempt
    "N": 7,  # Neutral
}


@dataclass
class LabelEntry:
    """One row of a semicolon label list."""

    path: str
    emo_class: str
    emotion: int  # index in the chosen ordering, -1 if unknown/invalid
    arousal: Optional[float] = None
    valence: Optional[float] = None
    dominance: Optional[float] = None
    extra: Dict[str, float] = field(default_factory=dict)


def parse_label_list(
    list_path: str,
    audio_dir: Optional[str] = None,
    emotion_map: Optional[Dict[str, int]] = None,
    drop_invalid: bool = False,
) -> List[LabelEntry]:
    """Parse a semicolon label list into LabelEntry rows.

    Format per line: ``path; EmoClass; A:x; V:y; D:z;``.  Unknown emotion
    codes map to index -1 (reference parity:
    ``baseline/eval_cat_ser_weighted_with_list.py:97``).  With
    ``drop_invalid`` the X/O rows are removed, reproducing the
    ``labels/processed`` filtering (``labels/processed/process_txt_label.py``).
    """
    emotion_map = emotion_map or BASELINE_EMOTIONS_MAP
    entries: List[LabelEntry] = []
    with open(list_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            if len(parts) < 2:
                continue
            path = parts[0].strip()
            if audio_dir and not os.path.isabs(path):
                path = os.path.join(audio_dir, path)
            emo = parts[1].strip()
            if drop_invalid and emo in INVALID_EMOTIONS_MAP:
                continue
            entry = LabelEntry(path=path, emo_class=emo,
                               emotion=emotion_map.get(emo, -1))
            for seg in parts[2:]:
                seg = seg.strip()
                if not seg or ":" not in seg:
                    continue
                key, value = seg.split(":", 1)
                key, value = key.strip(), value.strip()
                try:
                    fval = float(value)
                except ValueError:
                    entry.extra[key] = value
                    continue
                if key == "A":
                    entry.arousal = fval
                elif key == "V":
                    entry.valence = fval
                elif key == "D":
                    entry.dominance = fval
                else:
                    entry.extra[key] = fval
            entries.append(entry)
    return entries


def clean_filename(filename: str) -> str:
    """The base ``.wav`` name of a path: the directory and an ``_snrN_...``
    suffix stripped."""
    base = os.path.basename(filename)
    if "_snr" in base:
        base = base.split("_snr")[0] + ".wav"
    return base


def write_label_list(entries: Sequence[LabelEntry], out_path: str) -> None:
    """Write entries back in the semicolon list format."""
    with open(out_path, "w") as f:
        for e in entries:
            f.write(f"{e.path}; {e.emo_class}; A:{e.arousal}; V:{e.valence}; "
                    f"D:{e.dominance};\n")


def parse_consensus_csv(labels_file: str, split: Optional[str] = None,
                        categorical_only: bool = True,
                        emotion_map: Optional[Dict[str, int]] = None
                        ) -> List[Dict[str, str]]:
    """The rows of ``labels_consensus.csv`` as dicts of their text, of
    ``split`` if given, whose ``EmoClass`` is in the emotion map (the
    valid 8 with ``categorical_only``, else all 10), as the reference's
    ``EmotionDataset`` filters them (``src/data/emotion_dataset.py:
    77-86``)."""
    emotion_map = emotion_map or (
        VALID_EMOTIONS_MAP if categorical_only else EMOTIONS_MAP)
    with open(labels_file, newline="") as f:
        return [r for r in csv.DictReader(f)
                if (not split or r["Split_Set"] == split)
                and r["EmoClass"] in emotion_map]


def _write_csv(out_path: str, header: Sequence[str], rows) -> None:
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def filter_consensus_csv(in_path: str, out_path: str) -> int:
    """Drop the X/O rows of a consensus CSV; returns the rows kept
    (``labels/processed/process_csv_label.py:15-58``)."""
    with open(in_path, newline="") as f:
        header = next(csv.reader(f))
    rows = parse_consensus_csv(in_path, categorical_only=True)
    _write_csv(out_path, header, ([r[k] for k in header] for r in rows))
    return len(rows)


def filter_label_list(in_path: str, out_path: str) -> int:
    """Drop the X/O lines of a semicolon list; returns the lines kept
    (``labels/processed/process_txt_label.py:14-60``)."""
    entries = parse_label_list(in_path, drop_invalid=True)
    write_label_list(entries, out_path)
    return len(entries)


def base_filename_candidates(filename: str) -> List[str]:
    """Candidate base names of an augmented MSP-PODCAST file name
    (``MSP-PODCAST_0133_0459_snr2_IPb6u22cLIo.wav``): utterance IDs have 3
    or 4 underscore segments, so both are returned
    (``labels/processed/reformat_txt_baseline_gt.py:30-59``)."""
    if "_snr" not in filename:
        return [filename]
    segments = os.path.basename(filename).split("_snr")[0].split("_")
    if len(segments) < 3:
        return [filename]
    candidates = ["_".join(segments[:3]) + ".wav"]
    if len(segments) >= 4:
        candidates.append("_".join(segments[:4]) + ".wav")
    return candidates


def emotion_to_one_hot(emo_class: str,
                       emotion_map: Optional[Dict[str, int]] = None,
                       num_classes: int = 8) -> np.ndarray:
    """One-hot encoding of an emotion code, all zeros for an unknown one
    (``labels/processed/reformat_txt_baseline_gt.py:10-28``)."""
    emotion_map = emotion_map or BASELINE_EMOTIONS_MAP
    one_hot = np.zeros(num_classes, dtype=np.float32)
    idx = emotion_map.get(emo_class, -1)
    if 0 <= idx < num_classes:
        one_hot[idx] = 1.0
    return one_hot


def reformat_lists_to_onehot_csv(list_paths: Sequence[str],
                                 consensus_csv: Optional[str], out_csv: str,
                                 preserve_path: bool = False) -> int:
    """Semicolon label lists → the baseline's one-hot CSV, ``FileName,
    A,S,H,U,F,D,C,N`` (the challenge's column order) and, given a
    consensus CSV with ``Split_Set``, the split of each row's base name
    (``labels/processed/reformat_txt_baseline_gt.py:61-139``).  Returns
    the rows written."""
    split_lookup: Dict[str, str] = {}
    if consensus_csv:
        with open(consensus_csv, newline="") as f:
            reader = csv.DictReader(f)
            if "Split_Set" in (reader.fieldnames or ()):
                split_lookup = {r["FileName"]: r["Split_Set"] for r in reader}
    codes = list(BASELINE_EMOTIONS_MAP)
    rows = []
    for list_path in list_paths:
        for e in parse_label_list(list_path,
                                  emotion_map=BASELINE_EMOTIONS_MAP):
            one_hot = emotion_to_one_hot(e.emo_class)
            split = None
            for cand in base_filename_candidates(e.path):
                split = split_lookup.get(os.path.basename(cand))
                if split is not None:
                    break
            row = [e.path if preserve_path else os.path.basename(e.path)]
            row += [repr(float(one_hot[BASELINE_EMOTIONS_MAP[c]]))
                    for c in codes]
            if split_lookup:
                row.append("" if split is None else split)
            rows.append(row)
    header = ["FileName"] + codes + (["Split_Set"] if split_lookup else [])
    _write_csv(out_csv, header, rows)
    return len(rows)
