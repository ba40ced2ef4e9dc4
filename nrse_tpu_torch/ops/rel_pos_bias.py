"""WavLM bucketed relative position bias.

Port of ``nrse_tpu/ops/rel_pos_bias.py:27-141``: the T5-style
bidirectional bucketing HF ``WavLMAttention`` uses (``num_buckets=320``,
``max_distance=800``), computed once per length in numpy, and the gather of
the ``[num_buckets, H]`` table into the batch-shared ``[H, T, T]`` bias
(the block attention's form, T ≤ 384) or into its Toeplitz generator
``[H, 2T]`` (the flash attention's form, T > 384): the bucket depends only
on the offset ``k − q``, so one vector per head determines the whole
``[T, T]`` bias.

Both gathers give the table its gradient in a fixed order, so a step
gives the same bits from one call to the next: the dense bias's gradient
is summed along its diagonals into the generator's (a sum over one axis
of a skewed view), and the generator's into the table by a product with
the buckets' one-hot matrix.  The backward of a plain index
(``index_put_`` with accumulation) adds in thread order on the CPU.

The generator's bucket index is copied to the table's device once per
length and device, and kept: a copy from the host inside the forward
would make it wait for the device, and could not be captured into a
CUDA graph (``runtime.graphs``).
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
    table's device and in its dtype.  A square bias goes through the
    generator (:func:`rel_bias_vector`, then :func:`dense_bias_from_rel`),
    whose gradients are summed in a fixed order."""
    if query_length == key_length:
        return dense_bias_from_rel(rel_bias_vector(
            rel_attn_embed, query_length, num_buckets, max_distance),
            query_length)
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


class _BucketGather(torch.autograd.Function):
    """``table[buckets].t()``: ``[num_buckets, H]`` → ``[H, 2T]``; the
    backward sums the gradient per bucket as one product with the one-hot
    ``[2T, num_buckets]`` matrix."""

    @staticmethod
    def forward(ctx, table, buckets):
        ctx.save_for_backward(buckets)
        ctx.num_buckets = table.shape[0]
        return table[buckets].t().contiguous()

    @staticmethod
    def backward(ctx, grad):
        (buckets,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(buckets, ctx.num_buckets)
        return torch.matmul(grad, onehot.to(grad.dtype)).t(), None


class _ToeplitzExpand(torch.autograd.Function):
    """``[H, 2T]`` → ``[H, T, T]``, ``out[h, q, k] = g[h, T − 1 + k −
    q]``; the backward sums each diagonal (:func:`_diagonal_sums`)."""

    @staticmethod
    def forward(ctx, bias_rel, seq_length):
        return bias_rel[:, _toeplitz_index(seq_length, bias_rel.device)]

    @staticmethod
    def backward(ctx, grad):
        return _diagonal_sums(grad), None


def _diagonal_sums(dense: torch.Tensor) -> torch.Tensor:
    """``[H, T, T]`` → ``[H, 2T]``: entry ``T − 1 + k − q`` the sum of
    ``dense[h, q, k]`` over its diagonal, the last entry 0.  The rows
    reversed and padded with T zeros, ``[H, T, 2T]``, read as rows of
    ``2T − 1`` put each diagonal in one column, which one sum over the rows
    adds in a fixed order."""
    h, t, _ = dense.shape
    z = torch.cat([dense.flip(1), torch.zeros_like(dense)], dim=2)
    z = z.reshape(h, 2 * t * t)[:, :t * (2 * t - 1)].reshape(h, t, 2 * t - 1)
    return torch.nn.functional.pad(z.sum(1), (0, 1))


def rel_bias_vector(rel_attn_embed: torch.Tensor, seq_length: int,
                    num_buckets: int = 320,
                    max_distance: int = 800) -> torch.Tensor:
    """Gather the ``[num_buckets, H]`` table into the Toeplitz generator
    ``[H, 2T]`` on the table's device and in its dtype:
    ``bias[h, q, k] == rel_bias_vector(...)[h, T − 1 + k − q]``."""
    return _BucketGather.apply(rel_attn_embed, _buckets_on(
        rel_attn_embed.device, seq_length, num_buckets, max_distance))


@lru_cache(maxsize=32)
def _buckets_on(device: torch.device, seq_length: int, num_buckets: int,
                max_distance: int) -> torch.Tensor:
    """:func:`bucket_of_relative_position` on ``device``, made once (it is
    only read) and outside inference mode, so that a training forward may
    save it for its backward after a serving forward made it."""
    with torch.inference_mode(False):
        return torch.from_numpy(bucket_of_relative_position(
            seq_length, num_buckets, max_distance).copy()).to(device)


def dense_bias_from_rel(bias_rel: torch.Tensor,
                        seq_length: int) -> torch.Tensor:
    """Expand the generator ``[H, 2T]`` to the dense ``[H, T, T]``
    (``out[h, q, k] = bias_rel[h, T − 1 + k − q]``): the block attention's
    bias and the plain flash attention's; the K5 kernels never form it."""
    return _ToeplitzExpand.apply(bias_rel, seq_length)


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
