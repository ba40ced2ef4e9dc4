"""Polyphase sample-rate conversion on the host.

The port's copy of ``nrse_tpu/audio/resample.py:22-34`` (the numpy path;
the JAX package's on-device ``resample_jax`` is not needed here): it
replaces the reference's ``torchaudio.transforms.Resample``
(``src/utils/audio_utils.py:35``) during decode, when a file is not
already at the target rate.
"""

from __future__ import annotations

import math

import numpy as np


def _gcd_ratio(orig_sr: int, new_sr: int):
    g = math.gcd(int(orig_sr), int(new_sr))
    return new_sr // g, orig_sr // g  # up, down


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample on host. x: [..., samples] float32."""
    if orig_sr == new_sr:
        return x
    from scipy.signal import resample_poly

    up, down = _gcd_ratio(orig_sr, new_sr)
    return resample_poly(x, up, down, axis=-1).astype(np.float32)
