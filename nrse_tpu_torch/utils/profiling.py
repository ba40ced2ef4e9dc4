"""Throughput accounting and the profiler's trace.

Counterpart of ``nrse_tpu/utils/profiling.py:18-84``: a per-step
audio-seconds-per-second-per-chip counter (:class:`ThroughputMeter`), a
smoothed step timer (:class:`StepTimer`), and :func:`profile_trace`, which
writes a Chrome trace of what runs inside it through ``torch.profiler``
(the JAX package's ``jax.profiler.trace``), with the card's activity
where there is a card.  :data:`PROFILE_GROUPS` and :func:`group_of` sort
the card's kernels by name into the groups the profiles report (the
port's kernels, the libraries', copies), for ``chip_smoke.py`` and
``tools/port_analyze_profile.py``.
"""

from __future__ import annotations

import contextlib
import os
import re
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


COPIES = "dtype/layout copies"
# kernel name patterns → the groups the profiles report, first match wins
# (the fold of reduction partials, ln_fold_kernel, is shared by K6's and
# K7's backward and counts as K7's)
PROFILE_GROUPS = (
    ("K6 (fused conv frontend)", "k6_|K6RowSource"),
    ("K7 (channel LayerNorm)", "ln_row_|ln_fold"),
    # flash_attention_fwd_wgmma_kernel
    ("K5 (flash attention)", "flash_attention_fwd"),
    # flash_attention_bwd_{delta,dq_wgmma,dkv_wgmma}_kernel and the fold
    ("K5 backward (delta, dq, dk/dv, dbias fold)",
     "flash_attention_bwd|flash_dbias_fold"),
    ("kernel A (block attention)", "block_attention_fwd"),
    ("K3 (block attention backward)",
     "attention_bwd_dkdv|attention_bwd_dq|dbias_sum|dout_prep"),
    ("kernel B and K2 (fused FFN GEMMs)",
     "nrse::gemm|nrse::wg|dh2_kernel|colsum|transpose_cast"),
    ("K1 (dropout)", "dropout_kernel"),
    ("K4 (AdamW)", "adamw_ema"),
    ("cuDNN convs", "conv|cudnn|implicit|winograd|fft"),
    ("cuBLAS (projections, heads)", "gemm|cutlass|xmma|nvjet|cublas"),
    ("LayerNorm", "layer_norm|LayerNorm"),
    (COPIES, "copy|Copy|cast"),
    ("reductions", "reduce|Reduce|softmax|Softmax"),
    ("elementwise", "elementwise|Elementwise|vectorized"),
)


def group_of(name: str) -> str:
    """The :data:`PROFILE_GROUPS` group of a kernel name (first match), or
    ``other``."""
    return next((g for g, pat in PROFILE_GROUPS if re.search(pat, name)),
                "other")
