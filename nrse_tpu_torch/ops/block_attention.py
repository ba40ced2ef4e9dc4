"""Block gated attention for short sequences (kernel A's wrapper).

Port of ``nrse_tpu/ops/block_attention.py:486-577``: the same signature and
``[B, H, T, D]`` layout, consuming the dense ``[H, T, T]`` position bias.
A CUDA tensor goes to the hand-written kernel in
``nrse_tpu_torch/csrc/block_attention_fwd.cu``; a CPU tensor goes to the
plain version, ``ops.attention.gated_bias_attention_lse``.  There is no
fallback from one to the other.

The kernel holds a head's whole K and V and whole score rows on chip, so
it takes T ≤ ``MAX_T`` = 384 frames (≈ 7.7 s of audio), as the TPU kernel
does.  Longer clips need the streaming flash kernel, which is not ported
yet; both paths raise for them, so the CPU tests see the card's contract.
Forward only: the backward kernel and the in-kernel dropout come with
training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nrse_tpu_torch.ops.attention import gated_bias_attention_lse, mask_add
from nrse_tpu_torch.runtime import cuda_build

MAX_T = 384
HEAD_DIM = 64

# Kernel launches made by this wrapper since the count was last reset.
LAUNCHES = 0


def _check_inputs(q, k, v, gate, pos_bias, key_padding_mask):
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    if gate.shape != (b, h, t):
        raise ValueError(f"gate must be [B,H,T]=({b},{h},{t}), got "
                         f"{tuple(gate.shape)}")
    if pos_bias.shape != (h, t, t):
        raise ValueError(f"pos_bias must be dense [H,T,T]=({h},{t},{t}), "
                         f"got {tuple(pos_bias.shape)}")
    if key_padding_mask is not None and key_padding_mask.shape != (b, t):
        raise ValueError(f"key_padding_mask must be [B,T]=({b},{t}), got "
                         f"{tuple(key_padding_mask.shape)}")
    if t > MAX_T:
        raise ValueError(
            f"T={t} frames exceeds the block kernel's limit of {MAX_T}; "
            "the streaming flash-attention kernel is not ported yet")


def _kernel_fwd(q, k, v, gate, pos_bias, key_padding_mask):
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes bf16 q/k/v, got {q.dtype}")
    tensors = (q, k, v, gate, pos_bias)
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v, gate and pos_bias must share a device")
    q, k, v = (x.contiguous() for x in (q, k, v))
    gate = gate.to(torch.float32).contiguous()
    bias = pos_bias.to(torch.float32).contiguous()
    madd = mask_add(key_padding_mask, b, t, q.device).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):  # the launch goes to the current card
        err = lib.nrse_block_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
            bias.data_ptr(), madd.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, t, d, 1.0 / d ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "block_attention_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def block_gated_attention_lse(q, k, v, gate, pos_bias,
                              key_padding_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, T, D], lse [B, H, T] float32)``; see
    :func:`block_gated_attention`."""
    _check_inputs(q, k, v, gate, pos_bias, key_padding_mask)
    if q.device.type == "cuda":
        return _kernel_fwd(q, k, v, gate, pos_bias, key_padding_mask)
    if q.device.type == "cpu":
        return gated_bias_attention_lse(q, k, v, gate, pos_bias,
                                        key_padding_mask)
    raise ValueError(f"no block attention for device {q.device}")


def block_gated_attention(q, k, v, gate, pos_bias,
                          key_padding_mask: Optional[torch.Tensor] = None):
    """Gated-bias attention at T ≤ 384.

    Args:
      q, k, v: ``[B, H, T, D]``; on the card bf16 with D = 64.
      gate: ``[B, H, T]`` per-query bias gate.
      pos_bias: dense ``[H, T, T]`` (``rel_pos_bias.compute_position_bias``).
      key_padding_mask: optional ``[B, T]`` (1 = valid key).
    Returns ``[B, H, T, D]`` in v's dtype.
    """
    return block_gated_attention_lse(q, k, v, gate, pos_bias,
                                     key_padding_mask)[0]
