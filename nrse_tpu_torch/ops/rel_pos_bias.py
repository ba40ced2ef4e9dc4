"""WavLM bucketed relative position bias.

Port of ``nrse_tpu/ops/rel_pos_bias.py:27-77``: the T5-style bidirectional
bucketing HF ``WavLMAttention`` uses (``num_buckets=320``,
``max_distance=800``), computed once per length in numpy, and the gather of
the ``[num_buckets, H]`` table into the batch-shared ``[H, T, T]`` bias.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def relative_position_buckets(query_length: int, key_length: int,
                              num_buckets: int = 320,
                              max_distance: int = 800) -> np.ndarray:
    """``[T_q, T_k]`` int64 bucket indices.

    Half the buckets encode the sign (key after query), half the
    magnitude; magnitudes below ``num_buckets // 4`` are exact, larger
    ones are log-spaced up to ``max_distance``.  The cached array is
    read-only, so no caller can change what the next one gets.
    """
    half = num_buckets // 2
    max_exact = half // 2
    rel = (np.arange(key_length, dtype=np.int64)[None, :]
           - np.arange(query_length, dtype=np.int64)[:, None])
    rel_abs = np.abs(rel)
    with np.errstate(divide="ignore"):
        log_ratio = np.log(np.maximum(rel_abs / max_exact, 1e-20))
    large = (max_exact + log_ratio / math.log(max_distance / max_exact)
             * (half - max_exact)).astype(np.int64)
    large = np.minimum(large, half - 1)
    buckets = (rel > 0) * half + np.where(rel_abs < max_exact, rel_abs, large)
    buckets.setflags(write=False)
    return buckets


def compute_position_bias(rel_attn_embed: torch.Tensor, query_length: int,
                          key_length: int, num_buckets: int = 320,
                          max_distance: int = 800) -> torch.Tensor:
    """Gather the ``[num_buckets, H]`` table into ``[H, T_q, T_k]`` on the
    table's device and in its dtype."""
    buckets = torch.from_numpy(relative_position_buckets(
        query_length, key_length, num_buckets, max_distance).copy())
    values = rel_attn_embed[buckets.to(rel_attn_embed.device)]  # [Tq,Tk,H]
    return values.permute(2, 0, 1).contiguous()
