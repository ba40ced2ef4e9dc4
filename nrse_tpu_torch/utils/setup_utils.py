"""Deterministic seeding.

Port of ``nrse_tpu/utils/setup_utils.py:20-40`` (parity with the
reference's ``src/utils/setup_utils.py:4``: the torch, CUDA and numpy
seeds).  :func:`set_seed` seeds Python's ``random``, numpy and torch (the
card's generators too) and returns the seed, the root of a trainer's
``models.wavlm.TrainRNG`` streams, where the JAX version returns a root
``jax.random`` key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> int:
    """Seed the host's and torch's generators; returns ``seed``."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
