"""Offline vocal-separation preprocessor that builds the clean corpus.

The port's copy of ``nrse_tpu/data/preprocess/demucs_speech_separation.py:
32-118``, on the port's ``audio/io.py`` and ``audio/resample.py``
(capability parity with the reference's
``src/data/preprocess/demucs_speech_speration.py:13-113``): separate the
vocals of podcast audio with the ``htdemucs_ft`` model (44.1 kHz), gate
the noise floor at 0.005 (``:89-90``) and save 16 kHz PCM16 WAVs, the
"clean" corpus the BYOL dataset trains on.

An offline host tool, off the card's path.  The separation needs the
``demucs`` package and its weights, which this repository's machines do
not have: ``separate=True`` then raises an ``ImportError`` naming demucs
(``demucs_available()`` decides), and ``separate=False`` runs the gate,
the resampling and the PCM16 export alone, for a corpus that is already
speech-dominant.  ``separate=None`` picks whichever is available.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from nrse_tpu_torch.audio.io import get_audio_files, load_audio, save_wav
from nrse_tpu_torch.audio.resample import resample
from nrse_tpu_torch.utils.logging_utils import logger

NOISE_FLOOR = 0.005  # reference gate threshold (:89-90)


def demucs_available() -> bool:
    try:
        import demucs  # noqa: F401

        return True
    except ImportError:
        return False


def _separate_vocals(waveform: np.ndarray, sr: int) -> np.ndarray:
    """Run htdemucs_ft vocal separation (requires demucs + torch)."""
    import torch
    from demucs.apply import apply_model
    from demucs.pretrained import get_model

    model = get_model("htdemucs_ft")
    model.eval()
    wav = torch.from_numpy(waveform).float()
    if wav.ndim == 1:
        wav = wav[None]
    if wav.shape[0] == 1:
        wav = wav.repeat(2, 1)  # demucs expects stereo
    with torch.no_grad():
        sources = apply_model(model, wav[None], split=True, overlap=0.25)[0]
    vocals_idx = model.sources.index("vocals")
    return sources[vocals_idx].mean(0).numpy()


def noise_floor_gate(waveform: np.ndarray,
                     threshold: float = NOISE_FLOOR) -> np.ndarray:
    """Zero out samples below the noise floor (reference ``:89-90``)."""
    return np.where(np.abs(waveform) < threshold, 0.0, waveform)


def _require_demucs() -> None:
    if not demucs_available():
        raise ImportError("separate=True needs the demucs package (and its "
                          "htdemucs_ft weights), which is not installed; "
                          "pass separate=False to gate and resample only")


def process_file(in_path: str, out_path: str, target_sr: int = 16000,
                 separate: Optional[bool] = None) -> bool:
    """One file → a gated 16 kHz PCM16 WAV; False (logged) where it
    fails, but ``separate=True`` without demucs raises."""
    if separate is None:
        separate = demucs_available()
    if separate:
        _require_demucs()
    try:
        wav, sr = load_audio(in_path)
        mono = wav.mean(axis=0)
        if separate:
            if sr != 44100:  # htdemucs operates at 44.1 kHz
                mono = resample(mono[None], sr, 44100)[0]
                sr = 44100
            mono = _separate_vocals(mono, sr)
        gated = noise_floor_gate(mono)
        if sr != target_sr:
            gated = resample(gated[None], sr, target_sr)[0]
        save_wav(out_path, gated.astype(np.float32), target_sr)
        return True
    except Exception as e:
        logger.error(f"preprocess failed for {in_path}: {e}")
        return False


def process_folder(in_dir: str, out_dir: str, target_sr: int = 16000,
                   separate: Optional[bool] = None) -> List[str]:
    """Process every audio file under ``in_dir`` → ``out_dir`` (flat)."""
    if separate:
        _require_demucs()
    os.makedirs(out_dir, exist_ok=True)
    if separate is None:
        separate = demucs_available()
        if not separate:
            logger.warning(
                "demucs not installed — running gate+resample only "
                "(corpus assumed speech-dominant)"
            )
    done = []
    for path in get_audio_files(in_dir):
        out_path = os.path.join(
            out_dir, os.path.splitext(os.path.basename(path))[0] + ".wav"
        )
        if process_file(path, out_path, target_sr, separate):
            done.append(out_path)
    logger.info(f"preprocessed {len(done)} files into {out_dir}")
    return done


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    args = p.parse_args()
    process_folder(args.input_dir, args.output_dir, args.sample_rate)
