"""Corpus z-normalisation stats and the stat accumulator.

The port's copy of ``nrse_tpu/baseline/wavset.py:22-80`` (equivalents of
the external challenge-repo ``utils`` pieces the reference baseline uses):
``WavNormStats``, the training corpus' waveform mean and std saved to
``train_norm_stat.pkl`` as the pickle of ``(mean, std)`` and applied again
at evaluation (``train_ft_cat_ser_weighted_checkpoint.py:100-111``,
``eval_cat_ser_weighted_with_list.py:224-231``); ``LogManager``, the
named running-stat accumulator.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, Iterable, List

import numpy as np


@dataclass
class WavNormStats:
    mean: float
    std: float

    @classmethod
    def from_waveforms(cls, waveforms: Iterable[np.ndarray]) -> "WavNormStats":
        """Global scalar mean/std over the concatenated training waveforms."""
        total, total_sq, count = 0.0, 0.0, 0
        for w in waveforms:
            w = np.asarray(w, np.float64)
            total += w.sum()
            total_sq += (w**2).sum()
            count += w.size
        mean = total / max(1, count)
        var = total_sq / max(1, count) - mean**2
        return cls(mean=float(mean), std=float(np.sqrt(max(var, 0.0))))

    def apply(self, waveform: np.ndarray) -> np.ndarray:
        return ((waveform - self.mean) / (self.std + 1e-10)).astype(np.float32)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump((self.mean, self.std), f)

    @classmethod
    def load(cls, path: str) -> "WavNormStats":
        """Read a ``train_norm_stat.pkl`` this program or the JAX package
        wrote (the pickle is trusted input)."""
        with open(path, "rb") as f:
            mean, std = pickle.load(f)
        # train_norm_stat.pkl may store scalars or 0-d arrays
        return cls(mean=float(np.asarray(mean)), std=float(np.asarray(std)))


class LogManager:
    """Named running-mean stat accumulator (external LogManager parity)."""

    def __init__(self):
        self._stats: Dict[str, List[float]] = {}

    def alloc_stat_type_list(self, names: Iterable[str]) -> None:
        for name in names:
            self._stats.setdefault(name, [])

    def init_stat(self) -> None:
        for name in self._stats:
            self._stats[name] = []

    def add_torch_stat(self, name: str, value) -> None:
        self.add_stat(name, float(value))

    def add_stat(self, name: str, value: float) -> None:
        self._stats.setdefault(name, []).append(float(value))

    def get_stat(self, name: str) -> float:
        vals = self._stats.get(name, [])
        return float(np.mean(vals)) if vals else 0.0

    def print_stat(self) -> None:
        print({k: round(self.get_stat(k), 6) for k in self._stats})
