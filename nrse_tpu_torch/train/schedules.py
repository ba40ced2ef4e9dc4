"""Learning-rate schedules as plain functions of the step.

Port of ``nrse_tpu/train/schedules.py:14-40`` with optax's
``cosine_decay_schedule`` semantics, evaluated in float32 as optax
evaluates it: ``init · ((1 − α)·½(1 + cos(π·min(t, T)/T)) + α)``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0
                 ) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule(init_value, decay_steps, alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        t = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t
                                              / f32(decay_steps)))
        decayed = (f32(1.0) - f32(alpha)) * cosine + f32(alpha)
        return float(f32(init_value) * decayed)

    return schedule


def cosine_annealing(base_lr: float, total_steps: int, eta_min: float = 0.0
                     ) -> Callable[[int], float]:
    """torch ``CosineAnnealingLR`` as the JAX package builds it."""
    return cosine_decay(base_lr, max(1, total_steps),
                        eta_min / base_lr if base_lr else 0.0)
