"""Mock datasets for smoke tests.

The port's copy of ``nrse_tpu/data/mock.py:17-55`` (parity with the
reference's ``test/create_mock_dataset.py:4-25``: random clean tensors
and SNR-scaled noisy versions), plus a variant that writes tiny WAVs
through the port's ``audio/io.py`` so that the whole decode → mix → train
pipeline runs without a corpus.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def create_mock_dataset(num_samples: int = 100,
                        snr_range: List[float] = (0, 5, 10, 15, 20),
                        dim: int = 10, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(clean [N, dim], noisy [N, dim], snrs [N]) random pair tensors."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((num_samples, dim)).astype(np.float32)
    snrs = np.asarray([snr_range[i % len(snr_range)]
                       for i in range(num_samples)], np.float32)
    noise_level = 1.0 / (snrs + 1.0)
    noisy = clean + rng.standard_normal((num_samples, dim)).astype(np.float32) \
        * noise_level[:, None]
    return clean, noisy, snrs


def create_mock_corpus(root: str, n_clean: int = 12, n_noise: int = 4,
                       sample_rate: int = 16000, max_seconds: float = 2.0,
                       seed: int = 0) -> Tuple[str, str]:
    """Write a tiny on-disk clean/noise WAV corpus; returns (clean_dir,
    noise_dir) suitable for ``data.clean_data_path``/``noise_data_path``."""
    from nrse_tpu_torch.audio.io import save_wav

    rng = np.random.default_rng(seed)
    clean_dir = os.path.join(root, "clean")
    noise_dir = os.path.join(root, "noise")
    os.makedirs(clean_dir, exist_ok=True)
    os.makedirs(noise_dir, exist_ok=True)
    for i in range(n_clean):
        dur = rng.uniform(0.4, max_seconds)
        t = np.arange(int(sample_rate * dur)) / sample_rate
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(80, 400) * t)
        x += 0.05 * rng.standard_normal(t.shape)
        save_wav(os.path.join(clean_dir, f"speech_{i}.wav"),
                 x.astype(np.float32), sample_rate)
    for i in range(n_noise):
        n = 0.3 * rng.standard_normal(int(sample_rate * max_seconds / 2))
        save_wav(os.path.join(noise_dir, f"noise_{i}.wav"),
                 n.astype(np.float32), sample_rate)
    return clean_dir, noise_dir
