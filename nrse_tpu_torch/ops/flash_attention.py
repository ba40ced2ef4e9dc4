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
the generator (the per-batch diagonal sums of ``gate·ds`` folded onto it in
a fixed order, so two calls give the same bits).  The kernels replace
both the TPU's kernels and their streamed variants, whose split at t_pad >
3072 a Hopper kernel does not need.  For CPU tensors the Function runs the
plain versions, :func:`flash_attention_plain_fwd` and
:func:`flash_attention_plain_bwd`: ``dense_bias_from_rel`` and the block
attention's plain forward and backward (``ops.attention``), the dense
``dbias`` folded back onto the generator.  The kernels keep their
arithmetic but for one rounding (K5's forward rounds ``p`` to bf16 against
the running row max of its online softmax, the plain version against the
true row max; in float32 on the CPU the two are the same).  There is no
fallback from one to the other.  The raw CUDA entries refuse inputs that
require grad under autograd (``ops/_guard.py``); the Function calls them
with grad mode off.

A row whose keys are all padded is the uniform mean of v over the T keys;
the JAX kernel pads T to a multiple of 128 with zero keys and values, so
there it is that mean scaled by T / t_pad (ROADMAP Queue 3).  Its saved
``lse`` rounds to −1e9, so the backward recomputes ``p = 1`` for every
key of it, on both sides alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.ops.attention import (
    gated_bias_attention_bwd,
    gated_bias_attention_fwd,
    mask_add,
)
from nrse_tpu_torch.ops.rel_pos_bias import (
    dense_bias_from_rel,
    fold_dense_bias,
)
from nrse_tpu_torch.runtime import cuda_build

HEAD_DIM = 64
# the kernels hold a tile's bias window (64 + T − 1 bf16 values) in shared
# memory: 65536 frames are 21.8 minutes of audio
MAX_T = 65536
TILE = 64

# K5 launches made by this wrapper since the counts were last reset: the
# forward, the backward's dq kernel (with its dbias fold) and its dk/dv
# kernel
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0


def flash_attention_plain_fwd(q, k, v, gate, bias_rel, madd
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: ``(out [B, H, T, D] in v's dtype, lse [B, H, T]
    float32)`` from the ``[B, T]`` additive key mask ``madd``
    (``ops.attention.mask_add``)."""
    t = q.shape[2]
    return gated_bias_attention_fwd(q, k, v, gate,
                                    dense_bias_from_rel(bias_rel, t), madd)


def flash_attention_plain_bwd(q, k, v, gate, bias_rel, madd, out, lse, do):
    """The backward kernels' plain version: ``(dq, dk, dv)`` in q's dtype,
    ``dgate [B, H, T]`` and ``dbias_rel [H, 2T]`` float32, from the
    forward's ``out`` and ``lse`` and the cotangent ``do``."""
    t = q.shape[2]
    dq, dk, dv, dgate, dbias = gated_bias_attention_bwd(
        q, k, v, gate, dense_bias_from_rel(bias_rel, t), madd, out, lse, do)
    return dq, dk, dv, dgate, fold_dense_bias(dbias, t)


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
    lib = cuda_build.load()
    with torch.cuda.device(q.device):  # the launch goes to the current card
        err = lib.nrse_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
            bias_rel.data_ptr(), madd.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, t, d, 1.0 / d ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "flash_attention_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def partial_elements(b: int, h: int, t: int) -> int:
    """Float32 elements of the dq kernel's gate·ds window scratch: one
    window of ``64·⌈T/64⌉ + 63`` diagonal sums per (b, h, query tile)."""
    nq = -(-t // TILE)
    return b * h * nq * (nq * TILE + TILE - 1)


def bwd_inputs(q, k, v, gate, bias_rel, madd, out, lse, do):
    """The backward kernels' inputs from the forward's saved tensors and
    the cotangent: ``(q, k, v, gate, bias_rel, madd, do, lse, delta)``,
    contiguous, in the kernels' dtypes."""
    q, k, v, bias_rel = (x.contiguous() for x in (q, k, v, bias_rel))
    gate, madd, lse = (x.to(torch.float32).contiguous()
                       for x in (gate, madd, lse))
    do = do.to(q.dtype).contiguous()
    # rowsum(do ⊙ out), a plain reduction, as the JAX package leaves it to
    # XLA (nrse_tpu/ops/flash_attention.py:899-900)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    return q, k, v, gate, bias_rel, madd, do, lse, delta


def launch_bwd_dq(q, k, v, gate, bias_rel, madd, do, lse, delta):
    """K5's dq kernel and its dbias fold on :func:`bwd_inputs`: ``(dq,
    dgate, dbias_rel [H, 2T] float32)``."""
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    dgate = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    dbias = torch.empty(h, 2 * t, dtype=torch.float32, device=q.device)
    partial = torch.empty(partial_elements(b, h, t), dtype=torch.float32,
                          device=q.device)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        err = lib.nrse_flash_attention_bwd_dq(
            *(x.data_ptr() for x in (q, k, v, gate, bias_rel, madd, do, lse,
                                     delta)),
            dq.data_ptr(), dgate.data_ptr(), partial.data_ptr(),
            dbias.data_ptr(), b, h, t, d, 1.0 / d ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "flash_attention_bwd_dq")
    global DQ_LAUNCHES
    DQ_LAUNCHES += 1
    return dq, dgate, dbias


def launch_bwd_dkv(q, k, v, gate, bias_rel, madd, do, lse, delta):
    """K5's dk/dv kernel on :func:`bwd_inputs`: ``(dk, dv)``."""
    b, h, t, d = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        err = lib.nrse_flash_attention_bwd_dkv(
            *(x.data_ptr() for x in (q, k, v, gate, bias_rel, madd, do, lse,
                                     delta)),
            dk.data_ptr(), dv.data_ptr(), b, h, t, d, 1.0 / d ** 0.5,
            torch.cuda.current_stream().cuda_stream)
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
