"""BYOL clean/noisy pair dataset.

The port's copy of ``nrse_tpu/data/noisy_speech_dataset.py:31-169``
(capability parity with the reference's ``src/data/noisy_speech_dataset.py:
12-194``: per item a clean file, a random noise file and a random SNR from
``snr_range``; retry the next file on failure, at most 5 times).  The host
side only decodes — clean and noise waveforms at fixed shapes plus the
sampled SNR; the mixing and normalisation run on the card inside the train
step (``audio/augment.py::make_byol_views``).  ``featurize=True`` keeps the
reference's host-side pipeline (mix, peak-normalise, feature-extract) for
parity checks, with :func:`add_noise_to_speech` in numpy.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from nrse_tpu_torch.audio.io import get_audio_files, load_and_process_audio
from nrse_tpu_torch.runtime.native import native_available, native_load_batch
from nrse_tpu_torch.utils.logging_utils import logger


def fit_noise_to_length(noise: np.ndarray, length: int) -> np.ndarray:
    """Tile or truncate noise ``[..., T]`` to exactly ``length`` samples
    (``nrse_tpu/audio/augment.py:25-34``)."""
    n = noise.shape[-1]
    if n >= length:
        return noise[..., :length]
    reps = length // n + 1
    return np.tile(noise, reps)[..., :length]


def add_noise_to_speech(speech, noise, snr_db) -> Optional[np.ndarray]:
    """Mix ``noise`` into ``speech`` at ``snr_db`` on the host, or None for
    degenerate inputs (NaN, near-silent, exploding scale): the reference's
    contract, as ``nrse_tpu/audio/augment.py:75-112`` keeps it.  Accepts
    ``[1, T]`` arrays; noise is tiled or truncated to the speech length."""
    speech = np.asarray(speech, dtype=np.float32)
    noise = np.asarray(noise, dtype=np.float32)
    if np.isnan(speech).any():
        logger.warning("Original speech contains NaN values!")
        return None
    if np.isnan(noise).any():
        logger.warning("Original noise contains NaN values!")
        return None
    noise = fit_noise_to_length(noise, speech.shape[-1])

    speech_power = float(np.mean(speech**2))
    noise_power = float(np.mean(noise**2))
    if speech_power < 1e-10:
        logger.warning(f"Speech power too small: {speech_power}")
        return None
    if noise_power < 1e-10:
        logger.warning(f"Noise power too small: {noise_power}")
        return None
    snr_linear = 10.0 ** (float(snr_db) / 10.0)
    scaling = float(np.sqrt(speech_power / (noise_power * snr_linear)))
    if not np.isfinite(scaling):
        logger.warning(f"Invalid noise scaling: {scaling}")
        return None
    if scaling > 1e6:
        logger.warning(f"Extremely large noise scaling: {scaling}")
        return None
    noisy = speech + noise * scaling
    if np.isnan(noisy).any():
        logger.warning("Resulting noisy speech contains NaN values!")
        return None
    return noisy


class NoiseRobustSpeechDataset:
    def __init__(self,
                 clean_data_path: str,
                 noise_data_path: str,
                 sample_rate: int = 16000,
                 max_audio_length: float = 5.0,
                 snr_range: Optional[List[float]] = None,
                 feature_extractor=None,
                 featurize: bool = False):
        self.sample_rate = sample_rate
        self.max_samples = int(max_audio_length * sample_rate)
        self.snr_range = snr_range or [0, 5, 10, 15, 20]
        self.feature_extractor = feature_extractor
        self.featurize = featurize

        self.clean_files = get_audio_files(clean_data_path)
        self.noise_files = get_audio_files(noise_data_path)
        print(
            f"Found {len(self.clean_files)} clean files and "
            f"{len(self.noise_files)} noise files."
        )

    def __len__(self) -> int:
        return len(self.clean_files)

    def readahead_paths(self, indices) -> List[str]:
        """Files an upcoming batch will read: the loader advises the kernel
        (POSIX_FADV_WILLNEED) a few batches ahead so a cold-cache first
        epoch overlaps disk latency with decode and compute.  Clean files
        only: the noise pool is small and hot after the first batches, and
        the per-item noise pick depends on the item RNG."""
        return [self.clean_files[int(i)] for i in indices]

    def _load(self, path: str, rng) -> Optional[np.ndarray]:
        pyrng = random.Random(int(rng.integers(0, 2**31)))
        return load_and_process_audio(
            path, sample_rate=self.sample_rate,
            max_audio_length=self.max_samples / self.sample_rate,
            random_crop=True, rng=pyrng,
        )

    def sample_batch(self, indices, item_rngs) -> Optional[Dict[str, np.ndarray]]:
        """Vectorised batch assembly via the native C++ loader.

        Decodes, resamples and crops the whole clean+noise batch with the
        multithreaded native runtime; items the native decoder rejects go
        to the per-item Python path (which carries the reference's retry
        semantics).  Returns None when the native runtime is absent
        (``HostDataLoader`` then uses per-item ``sample``).
        """
        if self.featurize or not native_available():
            return None  # the parity path stays per-item

        clean_paths = [self.clean_files[int(i)] for i in indices]
        noise_idx = [int(r.integers(0, len(self.noise_files))) for r in item_rngs]
        noise_paths = [self.noise_files[j] for j in noise_idx]
        seeds = np.asarray(
            [r.integers(1, 2**62) for r in item_rngs], np.uint64
        )
        clean, clean_len = native_load_batch(
            clean_paths, self.sample_rate, self.max_samples, True, seeds
        )
        noise, noise_len = native_load_batch(
            noise_paths, self.sample_rate, self.max_samples, True, seeds + 1
        )
        snr = np.asarray(
            [self.snr_range[int(r.integers(0, len(self.snr_range)))]
             for r in item_rngs], np.float32,
        )
        batch = {"clean": clean, "noise": noise, "snr": snr}
        # per-item path for native failures (retry semantics live there)
        bad = np.nonzero((clean_len < 0) | (noise_len < 0))[0]
        for j in bad:
            item = self.sample(int(indices[j]), item_rngs[j])
            for k in batch:
                batch[k][j] = item[k]
        return batch

    def sample(self, idx: int, rng: np.random.Generator
               ) -> Dict[str, np.ndarray]:
        """One training item with the reference's retry semantics
        (``__getitem__``, ``noisy_speech_dataset.py:54-116``)."""
        max_attempts = 5
        for attempt in range(max_attempts):
            clean = self._load(self.clean_files[idx], rng)
            if clean is None:
                logger.warning(
                    f"Invalid clean speech file, trying next (attempt {attempt+1})"
                )
                idx = (idx + 1) % len(self.clean_files)
                continue
            noise_idx = int(rng.integers(0, len(self.noise_files)))
            noise = self._load(self.noise_files[noise_idx], rng)
            if noise is None:
                logger.warning(
                    f"Invalid noise file, trying another (attempt {attempt+1})"
                )
                continue
            snr = float(self.snr_range[int(rng.integers(0, len(self.snr_range)))])

            # degenerate-power guard so the on-device mix is always valid
            if float(np.mean(clean**2)) < 1e-10 or float(np.mean(noise**2)) < 1e-10:
                continue

            if not self.featurize:
                return {
                    "clean": clean[0].astype(np.float32),
                    "noise": noise[0].astype(np.float32),
                    "snr": np.float32(snr),
                }

            # host-side parity path (reference :89-148)
            noisy = add_noise_to_speech(clean, noise, snr)
            if noisy is None:
                continue
            clean_n = clean / (np.abs(clean).max() + 1e-8)
            noisy_n = noisy / (np.abs(noisy).max() + 1e-8)
            fe = self.feature_extractor
            if fe is not None:
                clean_n = fe(clean_n.squeeze(), self.sample_rate)["input_values"]
                noisy_n = fe(noisy_n.squeeze(), self.sample_rate)["input_values"]
            return {
                "clean_input_values": clean_n.squeeze().astype(np.float32),
                "noisy_input_values": noisy_n.squeeze().astype(np.float32),
                "snr": np.float32(snr),
            }
        raise RuntimeError(
            f"failed to assemble a valid item after {max_attempts} attempts "
            f"(started at index {idx})"
        )
