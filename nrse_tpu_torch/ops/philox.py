"""The dropout-RNG contract shared by every kernel of the port, and its
plain twin.

The TPU kernels draw their masks from the TPU's hardware PRNG, seeded per
(row block, f block) (``nrse_tpu/ops/kernel_rng.py``); that works there
only because a forward and its backward share one grid.  The Hopper
kernels tile differently from one another (kernel B's forward and K2's
backward do not share tiles), so here the mask of an element depends only
on (seed, site, element index):

  * generator: Philox4x32-10 (Salmon et al., SC'11; Random123's
    ``philox4x32_10``), written out by hand in ``csrc/philox.cuh`` and
    bit for bit the same here;
  * key: the seed pair ``(k0, k1)``; one draw serves four consecutive
    elements: element ``i`` takes output word ``i mod 4`` of the draw at
    the counter ``(g lo, g hi, site, 0)``, ``g = ⌊i / 4⌋``, with ``i`` the
    flat element index over the real, unpadded ``[N, C]`` (or ``[N, F]``)
    tensor;
  * keep rule (``kernel_rng.keep_mask``'s): ``u24 = bits >> 8``, keep iff
    ``u24 · 2⁻²⁴ ≥ p``, the kept value scaled by ``1 / (1 − p)`` in
    float32 (:func:`keep_scale`), then cast;
  * seeds: one pair per (step, tower, layer, site), derived on the host
    from the root seed by :func:`stream_seed`; the kernels read their pair
    from device memory (a 2-element int32 tensor holding the two words,
    :func:`seed_tensor`, in training a row of ``models.wavlm.SeedTable``),
    so a launch captured into a CUDA graph draws whatever pair the tensor
    holds when it is replayed;
  * windows: a shard ``[N, W_local]`` holding columns ``[c0, c0 +
    W_local)`` of a whole ``[N, W_global]`` tensor (tensor parallelism
    splits a layer's heads or FFN columns so) gives its element ``(row,
    col)`` the index ``row·W_global + c0 + col``, so it draws exactly its
    slice of the whole tensor's mask.  ``window = (W_global, c0)``;
    ``W_local``, ``W_global`` and ``c0`` are multiples of 4, so a group of
    four is one group of the whole.  Without a window (or with
    ``(W_local, 0)``) the index is the tensor's own flat index.

The contract reproduces the distribution of the TPU's dropout, not its
bits, as the JAX package's own ``rbg`` precedent does; parity tests
against JAX therefore feed explicit masks.  The functions here run on any
device: the CPU paths take their masks from them, so a seed gives the
same mask on the CPU and on the card.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57     # Philox multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85     # Weyl key increments
ROUNDS = 10
MASK32 = 0xFFFFFFFF
U24 = 2.0 ** -24


def _mulhilo(a: int, b):
    """``(hi, lo)`` 32-bit halves of ``a · b`` for a 32-bit constant ``a``
    and ``b`` a python int or an int64 tensor of 32-bit values.  The
    product is split at 16 bits so every partial stays below 2⁴⁸: int64
    never overflows."""
    lo_part = b * (a & 0xFFFF)
    hi_part = b * (a >> 16)
    lo = (lo_part + ((hi_part & 0xFFFF) << 16)) & MASK32
    hi = (hi_part + (lo_part >> 16)) >> 16
    return hi, lo


def philox4x32(k0: int, k1: int, c0, c1, c2, c3):
    """Philox4x32-10 of the counter ``(c0, c1, c2, c3)`` (python ints or
    int64 tensors holding 32-bit values) under the key ``(k0, k1)``;
    returns the four output words in the counter's type."""
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & MASK32
        k1 = (k1 + W1) & MASK32
    return c0, c1, c2, c3


def stream_seed(root: int, *ids: int) -> Tuple[int, int]:
    """The seed pair of one random stream: the first two Philox words of
    the counter ``ids`` (at most 4, e.g. step, tower, layer, site; each
    < 2³²) under the key made of the 64-bit ``root``."""
    if len(ids) > 4:
        raise ValueError(f"at most 4 stream ids, got {len(ids)}")
    c = [int(i) & MASK32 for i in ids] + [0] * (4 - len(ids))
    out = philox4x32(root & MASK32, (root >> 32) & MASK32, *c)
    return int(out[0]), int(out[1])


def seed_tensor(pair: Tuple[int, int], device=None) -> torch.Tensor:
    """A seed pair as the kernels read it: the words ``(k0, k1)`` in a
    2-element int32 tensor on ``device`` (one copy to a card)."""
    words = np.array([int(pair[0]) & MASK32, int(pair[1]) & MASK32],
                     np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def check_seed(seed: torch.Tensor, device) -> None:
    """Raise unless ``seed`` is a contiguous 2-element int32 tensor on
    ``device`` (a kernel loads it as one 8-byte word)."""
    if not isinstance(seed, torch.Tensor) or seed.dtype != torch.int32 \
            or seed.shape != (2,) or not seed.is_contiguous() \
            or seed.device != torch.device(device):
        raise ValueError(
            "a dropout seed is a contiguous 2-element int32 tensor on the "
            f"kernel's device {device} (philox.seed_tensor or a SeedTable "
            f"row), got {seed!r}")
    if seed.device.type == "cuda" and seed.data_ptr() % 8:
        raise ValueError("a dropout seed on the card must be 8-byte aligned")


def seed_pair(seed: torch.Tensor) -> Tuple[int, int]:
    """The ``(k0, k1)`` a seed tensor holds, read on the host (the plain
    versions' key; on a card the read waits for it)."""
    k0, k1 = (int(w) & MASK32 for w in seed.tolist())
    return k0, k1


@functools.lru_cache(maxsize=64)
def keep_scale(p: float) -> float:
    """``1 / (1 − p)`` rounded as float32 arithmetic rounds it."""
    return float(np.float32(1.0) / (np.float32(1.0) - np.float32(p)))


def _group_bits(seed: Tuple[int, int], site: int,
                g: torch.Tensor) -> torch.Tensor:
    """The four output words of each group index in ``g`` (int64), as
    ``g``'s shape plus a last axis of 4."""
    words = philox4x32(int(seed[0]), int(seed[1]), g & MASK32, g >> 32,
                       torch.full_like(g, int(site)), torch.zeros_like(g))
    return torch.stack(words, dim=-1)


def _keep(bits: torch.Tensor, p: float) -> torch.Tensor:
    """The keep rule on Philox words: float32 ``{0, 1/(1−p)}``."""
    u = (bits >> 8).to(torch.float32) * U24
    keep = u >= torch.tensor(p, dtype=torch.float32)
    return keep.to(torch.float32) * keep_scale(p)


def keep_mask(seed: Tuple[int, int], site: int, p: float, count: int,
              start: int = 0, device=None) -> torch.Tensor:
    """The float32 ``{0, 1/(1−p)}`` mask of the ``count`` elements from
    flat index ``start`` (a 1-D tensor): exactly what the kernels apply.
    ``start`` and ``count`` need not be multiples of 4: the groups that
    hold the range are drawn whole and cut to it."""
    first = start >> 2
    g = torch.arange(first, ((start + count + 3) >> 2), dtype=torch.int64,
                     device=device)
    off = start - 4 * first
    bits = _group_bits(seed, site, g).reshape(-1)[off:off + count]
    return _keep(bits, p)


def check_window(window: Optional[Tuple[int, int]],
                 width: int) -> Optional[Tuple[int, int]]:
    """``window`` (``(W_global, c0)``) checked for a shard ``width``
    columns wide; None for no window or one of the shard's own width.
    Raises where the shard does not fit or a size is not a multiple of
    4."""
    if window is None:
        return None
    w_global, c0 = int(window[0]), int(window[1])
    if w_global % 4 or c0 % 4 or width % 4 or c0 < 0 \
            or c0 + width > w_global:
        raise ValueError(f"dropout window (W_global={w_global}, c0={c0}) "
                         f"does not hold a shard of {width} columns, or a "
                         "size is not a multiple of 4")
    return None if w_global == width else (w_global, c0)


def dump_mask(seed: Tuple[int, int], site: int, shape, p: float,
              device=None, window=None) -> torch.Tensor:
    """:func:`keep_mask` over a whole tensor of ``shape``; with a
    ``window`` (``(W_global, c0)``, see the module docstring) over the
    shard ``shape`` is of, its last axis the shard's columns."""
    shape = tuple(int(d) for d in shape)
    window = check_window(window, shape[-1])
    if window is None:
        n = int(np.prod(shape))
        return keep_mask(seed, site, p, n, device=device).reshape(shape)
    w_global, c0 = window
    rows = int(np.prod(shape[:-1]))
    first = (torch.arange(rows, dtype=torch.int64, device=device) * w_global
             + c0) >> 2
    g = first[:, None] + torch.arange(shape[-1] >> 2, dtype=torch.int64,
                                      device=device)[None, :]
    return _keep(_group_bits(seed, site, g).reshape(shape), p)
