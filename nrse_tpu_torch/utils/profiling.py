"""Throughput accounting and the profiler's trace.

Counterpart of ``nrse_tpu/utils/profiling.py:18-84``: a per-step
audio-seconds-per-second-per-chip counter (:class:`ThroughputMeter`), a
smoothed step timer (:class:`StepTimer`), and :func:`profile_trace`, which
writes a Chrome trace of what runs inside it through ``torch.profiler``
(the JAX package's ``jax.profiler.trace``), with the card's activity
where there is a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class ThroughputMeter:
    """Audio-seconds ingested per wall-second per chip, from construction
    (or :meth:`reset`) to now."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = max(1, n_chips)
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._audio_seconds = 0.0
        self._steps = 0

    def update(self, batch_size: int, clip_seconds: float):
        self._audio_seconds += batch_size * clip_seconds
        self._steps += 1

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def audio_sec_per_sec_per_chip(self) -> float:
        dt = self.elapsed
        if dt <= 0:
            return 0.0
        return self._audio_seconds / dt / self.n_chips

    @property
    def step_time(self) -> float:
        return self.elapsed / max(1, self._steps)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace what runs inside into ``log_dir/trace_<time>.json`` (Chrome
    trace format; CPU activity, and CUDA's where a card is present); a
    no-op for a falsy ``log_dir``.  Yields the profiler (or None)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


class StepTimer:
    """Per-step wall-clock timer with exponential smoothing."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.smoothed = None
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.smoothed = (
                dt if self.smoothed is None
                else self.alpha * dt + (1 - self.alpha) * self.smoothed
            )
        self._last = now
        return dt
