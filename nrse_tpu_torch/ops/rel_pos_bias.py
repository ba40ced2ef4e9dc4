"""WavLM bucketed relative position bias.

Port of ``nrse_tpu/ops/rel_pos_bias.py:27-141``: the T5-style
bidirectional bucketing HF ``WavLMAttention`` uses (``num_buckets=320``,
``max_distance=800``), computed once per length in numpy, and the gather of
the ``[num_buckets, H]`` table into the batch-shared ``[H, T, T]`` bias
(the block attention's form, T ≤ 384) or into its Toeplitz generator
``[H, 2T]`` (the flash attention's form, T > 384): the bucket depends only
on the offset ``k − q``, so one vector per head determines the whole
``[T, T]`` bias.
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
    rel = (np.arange(key_length, dtype=np.int64)[None, :]
           - np.arange(query_length, dtype=np.int64)[:, None])
    return _buckets(rel, num_buckets, max_distance)


def _buckets(rel: np.ndarray, num_buckets: int,
             max_distance: int) -> np.ndarray:
    """The bucket of each offset ``rel = k − q``, as a read-only array."""
    half = num_buckets // 2
    max_exact = half // 2
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


@lru_cache(maxsize=32)
def bucket_of_relative_position(seq_length: int, num_buckets: int = 320,
                                max_distance: int = 800) -> np.ndarray:
    """``[2T]`` int64: the bucket of the offset ``rel = k − q`` at index
    ``T − 1 + rel`` (``rel ∈ [−(T−1), T−1]``; the last slot repeats the
    final bucket and is never addressed).  Read-only, as
    :func:`relative_position_buckets`."""
    t = seq_length
    rel = np.concatenate([np.arange(-(t - 1), t, dtype=np.int64),
                          np.array([t - 1], dtype=np.int64)])
    return _buckets(rel, num_buckets, max_distance)


def rel_bias_vector(rel_attn_embed: torch.Tensor, seq_length: int,
                    num_buckets: int = 320,
                    max_distance: int = 800) -> torch.Tensor:
    """Gather the ``[num_buckets, H]`` table into the Toeplitz generator
    ``[H, 2T]`` on the table's device and in its dtype:
    ``bias[h, q, k] == rel_bias_vector(...)[h, T − 1 + k − q]``."""
    buckets = torch.from_numpy(bucket_of_relative_position(
        seq_length, num_buckets, max_distance).copy())
    return rel_attn_embed[buckets.to(rel_attn_embed.device)].t().contiguous()


def dense_bias_from_rel(bias_rel: torch.Tensor,
                        seq_length: int) -> torch.Tensor:
    """Expand the generator ``[H, 2T]`` to the dense ``[H, T, T]``
    (``out[h, q, k] = bias_rel[h, T − 1 + k − q]``): the plain flash
    attention's bias; the K5 kernels never form it."""
    return bias_rel[:, _toeplitz_index(seq_length, bias_rel.device)]


def fold_dense_bias(dense: torch.Tensor, seq_length: int) -> torch.Tensor:
    """The adjoint of :func:`dense_bias_from_rel`: ``[H, T, T]`` → ``[H,
    2T]``, entry ``T − 1 + k − q`` the sum of ``dense[h, q, k]`` over its
    diagonal (the last entry, never addressed, is 0)."""
    h, t = dense.shape[0], seq_length
    idx = _toeplitz_index(t, dense.device).reshape(-1)
    out = torch.zeros(h, 2 * t, dtype=dense.dtype, device=dense.device)
    return out.index_add_(1, idx, dense.reshape(h, t * t))


def _toeplitz_index(t: int, device) -> torch.Tensor:
    """``[T, T]`` generator index ``T − 1 + k − q`` of each (q, k)."""
    ar = torch.arange(t, device=device)
    return (t - 1) + ar[None, :] - ar[:, None]
