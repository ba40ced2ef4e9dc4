"""The one generator of the benchmark's traffic: seeded, speech-like clips
and noise, at the lengths a traffic file states.

A traffic file (``traffic/<name>.json``) names groups of clips, each with
a ``count``, a ``kind`` (``speech`` or ``noise``) and the ``seconds`` of
its clips as a uniform range.  Every seed gets the same set of lengths
(the range's ``count`` midpoint quantiles), in an order of its own; the
seed also draws the content and, where the file gives ``label_shares``,
the classes, whose counts are fixed by the shares.  Speech-like content is
a voiced source (harmonics of a wandering pitch under a syllable-rate
envelope with pauses) cut at a random offset from one bank per seed, at a
random gain; noise is white noise with a random spectral tilt.
"""

from __future__ import annotations

import os
import wave
from typing import Dict, List, Tuple

import numpy as np

SAMPLE_RATE = 16000
BANK_SECONDS = 64.0


def lengths(group: Dict, rng: np.random.Generator, sr: int) -> np.ndarray:
    lo, hi = group["seconds"]
    n = int(group["count"])
    q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return rng.permutation(np.round(q * sr).astype(np.int64))


def speech_bank(rng: np.random.Generator, sr: int) -> np.ndarray:
    n = int(BANK_SECONDS * sr)
    t = np.arange(n) / sr
    f0 = 140.0 + 45.0 * np.sin(2 * np.pi * 0.31 * t + rng.uniform(0, 6.3)) \
        + 20.0 * np.sin(2 * np.pi * 1.7 * t + rng.uniform(0, 6.3))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(h * phase + rng.uniform(0, 6.3)) / h
                 for h in range(1, 11))
    env = (0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6.3))) ** 2
    pause = (np.sin(2 * np.pi * 0.23 * t + rng.uniform(0, 6.3)) > -0.7)
    x = voiced * env * pause + 0.02 * rng.standard_normal(n)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def noise_clip(rng: np.random.Generator, n: int) -> np.ndarray:
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.maximum(np.arange(spec.shape[0]), 1.0)
    x = np.fft.irfft(spec * f ** -rng.uniform(0.0, 1.5), n)
    return (rng.uniform(0.1, 0.5) * x / np.abs(x).max()).astype(np.float32)


def clips(traffic: Dict, seed: int) -> Dict[str, List[np.ndarray]]:
    """Every group's clips, by group name."""
    sr = int(traffic.get("sample_rate", SAMPLE_RATE))
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x5EED])
    bank = speech_bank(rng, sr)
    out: Dict[str, List[np.ndarray]] = {}
    for group in traffic["groups"]:
        made = []
        for n in lengths(group, rng, sr):
            if group["kind"] == "noise":
                made.append(noise_clip(rng, int(n)))
                continue
            idx = (rng.integers(0, bank.shape[0]) + np.arange(n)) \
                % bank.shape[0]
            made.append((bank[idx] * rng.uniform(0.3, 1.0)).astype(
                np.float32))
        out[group["name"]] = made
    return out


def labels(traffic: Dict, count: int, seed: int) -> np.ndarray:
    """``count`` class indices with the traffic's ``label_shares``: fixed
    counts per class, in an order drawn from the seed."""
    shares = np.asarray(traffic["label_shares"], np.float64)
    exact = shares / shares.sum() * count
    per = np.floor(exact).astype(np.int64)
    per[np.argsort(per - exact)[:count - per.sum()]] += 1
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x1AB])
    return rng.permutation(np.repeat(np.arange(len(shares)), per))


def write_wav(path: str, x: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    pcm = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_group(root: str, name: str, made: List[np.ndarray]
                ) -> Tuple[str, List[str]]:
    """Write a group's clips as ``<root>/<name>/<name>_<i>.wav``; returns
    the directory and the file names in order."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    files = []
    for i, x in enumerate(made):
        files.append(f"{name}_{i:05d}.wav")
        write_wav(os.path.join(d, files[-1]), x)
    return d, files


def epoch_order(size: int, rows: int, seed: int, block: int = 0
                ) -> np.ndarray:
    """``rows`` corpus indices: whole permutations of the corpus one after
    another, so the first ``size`` rows all differ; each ``block`` of a
    seed draws its own."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x0D, block])
    reps = -(-rows // size)
    return np.concatenate([rng.permutation(size) for _ in range(reps)])[:rows]
