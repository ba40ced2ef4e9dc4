"""Host-side audio I/O.

The port's copy of ``nrse_tpu/audio/io.py`` (capability parity with the
reference's ``src/utils/audio_utils.py:9-74``: ``load_and_process_audio``
decodes, downmixes to mono, resamples, crops or pads to a fixed length and
returns None on NaN or silent output; ``get_audio_files`` scans a directory
recursively, its paths sorted where JAX's keep the filesystem's order).
Decode runs in the port's native C++ runtime (``runtime/native.py``) where
it builds; the pure-Python WAV parser here is the fallback and the single
source of truth for semantics.
"""

from __future__ import annotations

import os
import random
import struct
import wave
from typing import List, Optional, Tuple

import numpy as np

from nrse_tpu_torch.audio.resample import resample
from nrse_tpu_torch.runtime.native import native_available, native_decode_wav
from nrse_tpu_torch.utils.logging_utils import logger

AUDIO_EXTENSIONS = {".wav", ".flac", ".mp3"}


def get_audio_files(directory: str) -> List[str]:
    """Recursively list audio files (reference ``audio_utils.py:67-74``),
    their paths sorted.

    A recorded deviation from the JAX package and the reference, which
    return ``os.walk``'s order: that is the filesystem's, unsorted, and
    not the same from one machine to the next (on ext4 a hash order
    seeded per filesystem; on a 9p mount it differed between machines and
    between corpora written anew on them, though not with the order the
    files were written in).  The datasets index this
    list (BYOL's validation split and noise pick, the SER trainers' noise
    pick), so the same corpus, config and seed trained differently from
    one machine to the next; sorted, they train the same everywhere."""
    return sorted(
        os.path.join(root, f)
        for root, _, files in os.walk(directory)
        for f in files
        if os.path.splitext(f)[1].lower() in AUDIO_EXTENSIONS
    )


def _decode_wav(file_path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to float32 [channels, samples] without torchaudio.

    Supports PCM 8/16/24/32-bit and IEEE float via struct parsing (the
    native C++ decoder mirrors this logic).
    """
    with open(file_path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {file_path}")
        fmt = None
        data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", chunk_hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), os.SEEK_CUR)
                continue
            if csize & 1:
                f.seek(1, os.SEEK_CUR)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {file_path}")

    (audio_format, channels, sr, _byte_rate, _block_align, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 3:  # IEEE float
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
    elif audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype=np.int32).astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}: {file_path}")
    else:
        raise ValueError(f"unsupported WAV format {audio_format}: {file_path}")

    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), int(sr)


def load_audio(file_path: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file to float32 [channels, samples] + sample rate.

    Tries the native C++ decoder first, then the pure-Python WAV parser.
    Non-WAV formats require the native decoder (documented corpus
    assumption; the reference corpus is WAV).
    """
    ext = os.path.splitext(file_path)[1].lower()
    if ext == ".wav" and native_available():
        try:
            return native_decode_wav(file_path)
        except ValueError:
            pass  # the Python parser reports what is wrong with the file
    if ext != ".wav":
        raise ValueError(
            f"non-WAV decode requires the native runtime (got {ext}); "
            "preprocess the corpus to 16 kHz WAV"
        )
    return _decode_wav(file_path)


def save_wav(file_path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write mono/stereo float32 [-1,1] audio as PCM16 WAV (test fixtures)."""
    x = np.asarray(waveform, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    pcm = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(file_path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())


def load_and_process_audio(
    file_path: str,
    sample_rate: int = 16000,
    max_audio_length: float = 5.0,
    random_crop: bool = True,
    rng: Optional[random.Random] = None,
) -> Optional[np.ndarray]:
    """Decode → mono → resample → crop/pad → validate, or None on failure.

    Semantics parity with reference ``audio_utils.py:9-64``: mono downmix by
    channel mean, resample to ``sample_rate``, random-crop (or head-crop) long
    audio, zero-pad short audio, reject NaN or near-silent output.  Returns a
    float32 array of shape ``[1, max_samples]``.
    """
    try:
        max_samples = int(max_audio_length * sample_rate)
        waveform, sr = load_audio(file_path)

        if waveform.shape[0] > 1:
            waveform = waveform.mean(axis=0, keepdims=True)

        if sr != sample_rate:
            waveform = resample(waveform, sr, sample_rate)

        n = waveform.shape[1]
        if n > max_samples:
            if random_crop:
                start = (rng or random).randint(0, n - max_samples)
            else:
                start = 0
            waveform = waveform[:, start : start + max_samples]
        elif n < max_samples:
            waveform = np.pad(waveform, ((0, 0), (0, max_samples - n)))

        if np.isnan(waveform).any():
            logger.warning(f"NaN values detected in processed audio: {file_path}")
            return None
        if np.max(np.abs(waveform)) < 1e-8:
            logger.warning(f"Audio values too small (near zero): {file_path}")
            return None
        return waveform.astype(np.float32)
    except Exception as e:  # the reference's None-on-failure contract
        logger.error(f"Error loading audio file {file_path}: {e}")
        return None
