"""Flash gated attention for long sequences (K5's wrapper), differentiable.

Port of ``nrse_tpu/ops/flash_attention.py:880-981``
(``flash_gated_attention`` and its custom VJP): gated-bias attention at
any T, the position bias given as its Toeplitz generator ``bias_rel [H,
2T]`` (entry ``[h, T − 1 + k − q]``, ``ops.rel_pos_bias.rel_bias_vector``),
so the ``[H, T, T]`` bias is never formed.  The model routes T > 384
frames (clips over 7.7 s) here; shorter ones go to ``ops.block_attention``.

:func:`flash_gated_attention` is a ``torch.autograd.Function``.  For CUDA
tensors its forward is K5's forward kernel, ``csrc/flash_attention_fwd.cu``
(bf16 q/k/v with D = 64, a bf16 ``bias_rel``), which saves the output and
the per-row ``lse``; its backward is K5's dq and dk/dv kernels,
``csrc/flash_attention_bwd.cu``, which recompute the scores and
probabilities from them and return the gradients of q, k, v, the gate and
the generator (the diagonal sums of ``gate·ds`` folded onto it in a fixed
order, so two calls give the same bits).  The kernels run on wgmma fed by
TMA; :func:`k5_plan` and :func:`map_geometry` give their grids, stages,
shared memory and tensor-map geometry, which the C entries check and build
their maps from.  They replace both the TPU's kernels and their streamed
variants, whose split at t_pad > 3072 a Hopper kernel does not need.  For
CPU tensors the Function runs the plain versions,
:func:`flash_attention_plain_fwd` and :func:`flash_attention_plain_bwd`:
the block attention's plain forward and backward (``ops.attention``) on
the padded keys and the dense bias, the dense ``dbias`` folded back onto
the generator.  The kernels keep their arithmetic but for one rounding
(K5's forward rounds ``p`` to bf16 against the running row max of its
online softmax, the plain version against the true row max; in float32 on
the CPU the two are the same).  There is no fallback from one to the
other.  The raw CUDA entries refuse inputs that require grad under
autograd (``ops/_guard.py``); the Function calls them with grad mode off.

Keys are padded as the JAX wrapper pads them (``:944-972``): T rounds up
to ``t_pad = 128·⌈T/128⌉`` with zero keys and values, an additive mask of
−1e9 and the generator read at ``min(T − 1 + k − q, 2T − 1)`` (its edge
pad).  A row with any valid key is unchanged by them (its ``p`` there
underflows to 0); a row whose keys are all padded is the mean of v over
the T keys scaled by T / t_pad, as in JAX.  Its saved ``lse`` rounds to
−1e9, so the backward recomputes ``p = 1`` for every one of the t_pad
keys, on both sides alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.ops.attention import (
    NEG_INF,
    gated_bias_attention_bwd,
    gated_bias_attention_fwd,
    mask_add,
)
from nrse_tpu_torch.ops.rel_pos_bias import (  # noqa: F401 (re-exported)
    dense_bias_from_rel,
    fold_dense_bias,
)
from nrse_tpu_torch.runtime import cuda_build

HEAD_DIM = 64
# the longest sequence the kernels take: the dq kernel's gate·ds windows
# grow as T² (4.3 GB at B = 1, H = 16); 65536 frames are 21.8 minutes of
# audio
MAX_T = 65536
# JAX's padding of the keys (its LANE and block size)
KEY_PAD = 128
SMEM_LIMIT = 232_448  # shared memory a block may have on an H100
_TILE_BYTES = 64 * HEAD_DIM * 2  # a bf16 box of 64 rows: 8 KB

# The forward: a block per 128-query tile (two consumer warpgroups of 64
# queries), persistent; keys in stages of 128 (K and V boxes, the bias
# slice of 255 f32 and the key mask's 128 f32).  Q and the output's staging
# tile 16 KB each.
FWD_QUERIES = 128
FWD_KEYS = 128
FWD_STAGES = 3
FWD_SMEM = (1024 + 2 * 2 * _TILE_BYTES
            + FWD_STAGES * (2 * 2 * _TILE_BYTES + 4 * 2 * FWD_KEYS
                            + 4 * FWD_KEYS)
            + 8 * (2 + 2 * FWD_STAGES))
# The dq kernel, persistent over 128-query tiles (Q and dO, 16 KB each);
# keys in stages of 64 (K and V, the key mask's 64 f32 and the bias slice
# of 191 f32, padded to 192); a 64 x 72 f32 gate·ds tile and an 8 KB dq
# staging box a consumer.
DQ_QUERIES = 128
DQ_KEYS = 64
DQ_STAGES = 4
GDS_LD = 72
DQ_SMEM = (1024 + 2 * 2 * _TILE_BYTES
           + DQ_STAGES * (2 * _TILE_BYTES + 4 * DQ_KEYS + 4 * 192)
           + 2 * 4 * 64 * GDS_LD + 2 * _TILE_BYTES + 8 * (2 + 2 * DQ_STAGES))
# The dk/dv kernel, persistent over 128-key tiles (K and V, 16 KB each);
# queries in stages of 64 (Q and dO, gate, lse and delta 64 f32 each, the
# bias slice of 191 f32, padded to 192); dk and dv staging boxes of 8 KB a
# consumer.
DKV_KEYS = 128
DKV_QUERIES = 64
DKV_STAGES = 4
DKV_SMEM = (1024 + 2 * 2 * _TILE_BYTES
            + DKV_STAGES * (2 * _TILE_BYTES + 3 * 4 * DKV_QUERIES + 4 * 192)
            + 2 * 2 * _TILE_BYTES + 8 * (2 + 2 * DKV_STAGES))

# The tensor maps each C entry takes, in order: (tensor, rows of a box).
FWD_MAPS = (("q", FWD_QUERIES), ("k", FWD_KEYS), ("v", FWD_KEYS),
            ("out", 64))
DQ_MAPS = (("q", DQ_QUERIES), ("do", DQ_QUERIES), ("k", DQ_KEYS),
           ("v", DQ_KEYS), ("dq", 64))
DKV_MAPS = (("k", DKV_KEYS), ("v", DKV_KEYS), ("q", DKV_QUERIES),
            ("do", DKV_QUERIES), ("dk", 64), ("dv", 64))
MAP_WORDS = 9  # dims, strides (elements) and box, innermost first

# K5 launches made by this wrapper since the counts were last reset: the
# forward, the backward's dq entry (the delta pre-pass, the dq kernel and
# its dbias fold) and its dk/dv kernel
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_length(t: int) -> int:
    """JAX's padded key count: T rounded up to a multiple of 128."""
    return KEY_PAD * _cdiv(t, KEY_PAD)


def k5_plan(b: int, h: int, t: int, sms: int) -> dict:
    """How K5's kernels are launched for ``b`` batches, ``h`` heads and
    ``t`` frames on a card of ``sms`` SMs.  Each kernel walks 128-row
    tiles of every (b, h) over persistent blocks (one an SM: 384 threads
    at 168 registers): the forward's and the dq kernel's tiles of queries
    (the forward's stages 128 keys of the t_pad, the dq kernel's 64), the
    dk/dv kernel's tiles of keys below T (its stages the 64-query tiles
    below T).  Also each kernel's stages and dynamic shared memory, and
    the f32 elements of the dq kernel's gate·ds windows (one of
    ``t_pad + 63`` diagonal sums per (b, h, 64 queries))."""
    t_pad = padded_length(t)
    tiles = b * h * (t_pad // FWD_QUERIES)
    key_tiles = b * h * _cdiv(t, DKV_KEYS)
    windows = t_pad // 64
    return {"t_pad": t_pad,
            "fwd": {"tiles": tiles, "grid": max(1, min(tiles, sms)),
                    "stages": FWD_STAGES, "smem": FWD_SMEM},
            "dq": {"tiles": tiles, "grid": max(1, min(tiles, sms)),
                   "stages": DQ_STAGES, "smem": DQ_SMEM},
            "dkv": {"tiles": key_tiles, "grid": max(1, min(key_tiles, sms)),
                    "stages": DKV_STAGES, "smem": DKV_SMEM},
            "partial": b * h * windows * (t_pad + 63)}


def tma_map(b: int, h: int, t: int, rows: int) -> dict:
    """The 3-D tensor map of a ``[B, H, T, 64]`` bf16 tensor as the kernels
    read or write it: (channel, row, head) innermost first, in boxes of
    ``rows`` rows of one head, so a box never reaches into the next head
    (rows past T read as zeros and are not written)."""
    return {"dims": (HEAD_DIM, t, b * h), "strides": (1, HEAD_DIM, HEAD_DIM * t),
            "box": (HEAD_DIM, rows, 1)}


def map_geometry(b: int, h: int, t: int, maps) -> list:
    """The C entries' map words: for each ``(tensor, rows)`` of ``maps``
    the :func:`tma_map`'s dims, strides and box."""
    words = []
    for _, rows in maps:
        m = tma_map(b, h, t, rows)
        words += [*m["dims"], *m["strides"], *m["box"]]
    return words


@functools.lru_cache(maxsize=64)
def _map_words(b: int, h: int, t: int, maps):
    """:func:`map_geometry` as the C array the entries read (they only read
    it, so one array serves every call of a shape)."""
    words = map_geometry(b, h, t, maps)
    return (ctypes.c_longlong * len(words))(*words)


def _pad_keys(k, v, bias_rel, madd, t: int):
    """The keys as JAX pads them: ``(k, v, bias [H, T, t_pad], madd)`` with
    zero keys and values past T, the mask −1e9 there and the dense bias
    read at ``min(T − 1 + k − q, 2T − 1)``."""
    pad = padded_length(t) - t
    k, v = (F.pad(x, (0, 0, 0, pad)) for x in (k, v))
    return (k, v, bias_rel[:, _padded_index(t, bias_rel.device)],
            F.pad(madd, (0, pad), value=NEG_INF))


def _padded_index(t: int, device) -> torch.Tensor:
    """``[T, t_pad]`` generator index ``min(T − 1 + k − q, 2T − 1)``."""
    q = torch.arange(t, device=device)
    k = torch.arange(padded_length(t), device=device)
    return ((t - 1) + k[None, :] - q[:, None]).clamp_max(2 * t - 1)


def flash_attention_plain_fwd(q, k, v, gate, bias_rel, madd
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: ``(out [B, H, T, D] in v's dtype, lse [B, H, T]
    float32)`` from the ``[B, T]`` additive key mask ``madd``
    (``ops.attention.mask_add``), over the keys padded as JAX pads them."""
    t = q.shape[2]
    kp, vp, bias, maddp = _pad_keys(k, v, bias_rel, madd, t)
    return gated_bias_attention_fwd(q, kp, vp, gate, bias, maddp)


def flash_attention_plain_bwd(q, k, v, gate, bias_rel, madd, out, lse, do):
    """The backward kernels' plain version: ``(dq, dk, dv)`` in q's dtype,
    ``dgate [B, H, T]`` and ``dbias_rel [H, 2T]`` float32, from the
    forward's ``out`` and ``lse`` and the cotangent ``do``; the padded
    keys' ``gate·ds`` folds onto the generator's clamped index."""
    b, h, t, _ = q.shape
    kp, vp, bias, maddp = _pad_keys(k, v, bias_rel, madd, t)
    dq, dk, dv, dgate, dbias = gated_bias_attention_bwd(
        q, kp, vp, gate, bias, maddp, out, lse, do)
    idx = _padded_index(t, q.device).reshape(-1)
    drel = torch.zeros(h, 2 * t, dtype=dbias.dtype, device=dbias.device)
    drel.index_add_(1, idx, dbias.reshape(h, -1))
    return dq, dk[:, :, :t], dv[:, :, :t], dgate, drel


def bwd_delta(do, out) -> torch.Tensor:
    """``delta = rowsum(do ⊙ out)`` ``[B, H, T]`` float32 as the backward's
    pre-pass sums it: 8 threads a row, each the float32 products of 8
    columns in order, then the threads' sums by a fixed tree (pairs, then
    pairs of pairs).  bf16 products are exact in float32, so on the card
    this gives the pre-pass's bits."""
    x = (do.float() * out.float()).unflatten(-1, (8, 8))
    s = x[..., 0]
    for c in range(1, 8):
        s = s + x[..., c]
    while s.shape[-1] > 1:
        s = s[..., 0::2] + s[..., 1::2]
    return s[..., 0]


def _check_inputs(q, k, v, gate, bias_rel, key_padding_mask):
    b, h, t, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    if gate.shape != (b, h, t):
        raise ValueError(f"gate must be [B,H,T]=({b},{h},{t}), got "
                         f"{tuple(gate.shape)}")
    if bias_rel.shape != (h, 2 * t):
        raise ValueError(f"bias_rel must be [H,2T]=({h},{2 * t}), got "
                         f"{tuple(bias_rel.shape)}")
    if key_padding_mask is not None and key_padding_mask.shape != (b, t):
        raise ValueError(f"key_padding_mask must be [B,T]=({b},{t}), got "
                         f"{tuple(key_padding_mask.shape)}")


def _check_cuda(q, k, v, bias_rel, *others):
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype == bias_rel.dtype
            == torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes bf16 q/k/v and bias_rel, got "
                        f"{q.dtype}, {bias_rel.dtype}")
    if t > MAX_T:
        raise ValueError(f"T={t} frames exceeds the flash kernel's limit of "
                         f"{MAX_T}")
    if any(x.device != q.device for x in (k, v, bias_rel, *others)):
        raise ValueError("the attention's tensors must share a device")


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _kernel_fwd(q, k, v, gate, bias_rel, madd):
    """K5's forward: ``(out, lse)``; q/k/v bf16 ``[B, H, T, 64]``,
    bias_rel bf16."""
    require_no_grad(q, k, v, gate, bias_rel,
                    what="flash_attention_fwd (the raw K5 entry; gradients "
                         "go through flash_gated_attention)")
    _check_cuda(q, k, v, bias_rel, gate, madd)
    b, h, t, d = q.shape
    q, k, v, bias_rel = (x.contiguous() for x in (q, k, v, bias_rel))
    gate = gate.to(torch.float32).contiguous()
    madd = madd.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    plan = k5_plan(b, h, t, _sms(q.device))["fwd"]
    lib = cuda_build.load()
    with cuda_build.on_device(q.device):
        err = lib.nrse_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
            bias_rel.data_ptr(), madd.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _map_words(b, h, t, FWD_MAPS), b, h, t, d,
            1.0 / d ** 0.5, plan["grid"], plan["smem"], _stream())
    cuda_build.check(err, "flash_attention_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def bwd_inputs(q, k, v, gate, bias_rel, madd, out, lse, do):
    """The backward kernels' inputs from the forward's saved tensors and
    the cotangent: ``(q, k, v, gate, bias_rel, madd, do, lse, out,
    delta)``, contiguous, in the kernels' dtypes; ``delta`` is the f32
    ``[B, H, T]`` buffer :func:`launch_bwd_dq`'s pre-pass fills
    (:func:`bwd_delta`) and :func:`launch_bwd_dkv` reads."""
    q, k, v, bias_rel = (x.contiguous() for x in (q, k, v, bias_rel))
    gate, madd, lse = (x.to(torch.float32).contiguous()
                       for x in (gate, madd, lse))
    do = do.to(q.dtype).contiguous()
    out = out.to(q.dtype).contiguous()
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    return q, k, v, gate, bias_rel, madd, do, lse, out, delta


def launch_bwd_dq(q, k, v, gate, bias_rel, madd, do, lse, out, delta):
    """K5's dq entry on :func:`bwd_inputs`: the delta pre-pass (into
    ``delta``), the dq kernel and its dbias fold: ``(dq, dgate, dbias_rel
    [H, 2T] float32)``."""
    b, h, t, d = q.shape
    plan = k5_plan(b, h, t, _sms(q.device))
    dq = torch.empty_like(q)
    dgate = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    dbias = torch.empty(h, 2 * t, dtype=torch.float32, device=q.device)
    partial = torch.empty(plan["partial"], dtype=torch.float32,
                          device=q.device)
    lib = cuda_build.load()
    with cuda_build.on_device(q.device):
        err = lib.nrse_flash_attention_bwd_dq(
            *(x.data_ptr() for x in (q, k, v, gate, bias_rel, madd, do, lse,
                                     out, delta)),
            dq.data_ptr(), dgate.data_ptr(), partial.data_ptr(),
            dbias.data_ptr(), _map_words(b, h, t, DQ_MAPS), b, h, t, d,
            1.0 / d ** 0.5, plan["dq"]["grid"], plan["dq"]["smem"],
            _stream())
    cuda_build.check(err, "flash_attention_bwd_dq")
    global DQ_LAUNCHES
    DQ_LAUNCHES += 1
    return dq, dgate, dbias


def launch_bwd_dkv(q, k, v, gate, bias_rel, madd, do, lse, out, delta):
    """K5's dk/dv kernel on :func:`bwd_inputs`, after :func:`launch_bwd_dq`
    filled ``delta``: ``(dk, dv)``."""
    b, h, t, d = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    plan = k5_plan(b, h, t, _sms(q.device))["dkv"]
    lib = cuda_build.load()
    with cuda_build.on_device(q.device):
        err = lib.nrse_flash_attention_bwd_dkv(
            *(x.data_ptr() for x in (q, k, v, gate, bias_rel, madd, do, lse,
                                     delta)),
            dk.data_ptr(), dv.data_ptr(), _map_words(b, h, t, DKV_MAPS), b, h,
            t, d, 1.0 / d ** 0.5, plan["grid"], plan["smem"], _stream())
    cuda_build.check(err, "flash_attention_bwd_dkv")
    global DKV_LAUNCHES
    DKV_LAUNCHES += 1
    return dk, dv


def _kernel_bwd(q, k, v, gate, bias_rel, madd, out, lse, do):
    """K5's backward, its dq and dk/dv kernels: ``(dq, dk, dv)`` bf16,
    ``dgate`` and ``dbias_rel [H, 2T]`` float32, from the forward's saved
    tensors."""
    require_no_grad(q, k, v, gate, bias_rel, do,
                    what="flash_attention_bwd (the raw K5 backward entry; "
                         "gradients go through flash_gated_attention)")
    _check_cuda(q, k, v, bias_rel, gate, madd, out, lse, do)
    inputs = bwd_inputs(q, k, v, gate, bias_rel, madd, out, lse, do)
    dq, dgate, dbias = launch_bwd_dq(*inputs)
    dk, dv = launch_bwd_dkv(*inputs)
    return dq, dk, dv, dgate, dbias


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, gate, bias_rel, madd):
        ctx.dtypes = (gate.dtype, bias_rel.dtype)
        if q.device.type == "cuda":
            # saved as the kernels read them: the backward copies nothing
            q, k, v, bias_rel = (x.contiguous() for x in (q, k, v, bias_rel))
            gate = gate.to(torch.float32).contiguous()
            out, lse = _kernel_fwd(q, k, v, gate, bias_rel, madd)
        else:
            out, lse = flash_attention_plain_fwd(q, k, v, gate, bias_rel,
                                                 madd)
        ctx.save_for_backward(q, k, v, gate, bias_rel, madd, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        saved = ctx.saved_tensors
        if saved[0].device.type == "cuda":
            grads = _kernel_bwd(*saved, do)
        else:
            grads = flash_attention_plain_bwd(*saved, do)
        dq, dk, dv, dgate, dbias = grads
        gate_dtype, bias_dtype = ctx.dtypes
        return (dq, dk, dv, dgate.to(gate_dtype), dbias.to(bias_dtype), None)


def flash_gated_attention_lse(q, k, v, gate, bias_rel,
                              key_padding_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, T, D], lse [B, H, T] float32)``; see
    :func:`flash_gated_attention`.  ``out`` is differentiable; ``lse`` is
    not."""
    _check_inputs(q, k, v, gate, bias_rel, key_padding_mask)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device {q.device}")
    b, _, t, _ = q.shape
    madd = mask_add(key_padding_mask, b, t, q.device).contiguous()
    return _FlashAttention.apply(q, k, v, gate, bias_rel, madd)


def flash_gated_attention(q, k, v, gate, bias_rel,
                          key_padding_mask: Optional[torch.Tensor] = None):
    """Gated-bias attention with the Toeplitz position bias, differentiable
    in q, k, v, the gate and the generator.

    Args:
      q, k, v: ``[B, H, T, D]``; on the card bf16 with D = 64.
      gate: ``[B, H, T]`` per-query bias gate.
      bias_rel: ``[H, 2T]`` generator (``rel_pos_bias.rel_bias_vector``);
        bf16 on the card.
      key_padding_mask: optional ``[B, T]`` (1 = valid key).
    Returns ``[B, H, T, D]`` in v's dtype.
    """
    return flash_gated_attention_lse(q, k, v, gate, bias_rel,
                                     key_padding_mask)[0]
