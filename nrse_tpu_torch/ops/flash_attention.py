"""Flash gated attention for long sequences (K5's wrapper), forward only.

Port of ``nrse_tpu/ops/flash_attention.py:925-981``
(``flash_gated_attention``): gated-bias attention at any T, the position
bias given as its Toeplitz generator ``bias_rel [H, 2T]`` (entry
``[h, T − 1 + k − q]``, ``ops.rel_pos_bias.rel_bias_vector``), so the
``[H, T, T]`` bias is never formed.  The model routes T > 384 frames
(clips over 7.7 s) here; shorter ones go to ``ops.block_attention``.

For a CUDA tensor the wrapper launches K5, ``csrc/flash_attention_fwd.cu``
(it replaces both the TPU's ``_fwd_kernel`` and its streamed variant, whose
split at t_pad > 3072 a Hopper kernel does not need): bf16 q/k/v with
D = 64, a bf16 ``bias_rel``; it writes the output and the per-row ``lse``
(kept for the backward).  For a CPU tensor it runs the plain version,
:func:`flash_attention_plain_fwd`: ``dense_bias_from_rel`` and then the
block attention's plain forward (``ops.attention``), whose arithmetic the
kernel keeps but for one rounding (K5 rounds ``p`` to bf16 against the
running row max of its online softmax, the plain version against the true
row max; in float32 on the CPU the two are the same).  There is no
fallback from one to the other.

The backward (the TPU's ``_bwd_dq_kernel``/``_bwd_dkv_kernel`` and their
streamed variants) is not ported yet: under autograd the wrapper raises
(``ops/_guard.py``) instead of detaching, on both devices, so the CPU
tests see the card's contract.  A row whose keys are all padded is the
uniform mean of v over the T keys; the JAX kernel pads T to a multiple of
128 with zero keys and values, so there it is that mean scaled by
T / t_pad (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.ops.attention import gated_bias_attention_fwd, mask_add
from nrse_tpu_torch.ops.rel_pos_bias import dense_bias_from_rel
from nrse_tpu_torch.runtime import cuda_build

HEAD_DIM = 64
# the kernel holds the query tile's bias window (64 + T − 1 bf16 values) in
# shared memory: 65536 frames are 21.8 minutes of audio
MAX_T = 65536

# K5 launches made by this wrapper since the count was last reset
LAUNCHES = 0


def flash_attention_plain_fwd(q, k, v, gate, bias_rel, madd
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: ``(out [B, H, T, D] in v's dtype, lse [B, H, T]
    float32)`` from the ``[B, T]`` additive key mask ``madd``
    (``ops.attention.mask_add``)."""
    t = q.shape[2]
    return gated_bias_attention_fwd(q, k, v, gate,
                                    dense_bias_from_rel(bias_rel, t), madd)


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


def _kernel_fwd(q, k, v, gate, bias_rel, madd):
    """K5: ``(out, lse)``; q/k/v bf16 ``[B, H, T, 64]``, bias_rel bf16."""
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
    if any(x.device != q.device for x in (k, v, gate, bias_rel, madd)):
        raise ValueError("the attention's tensors must share a device")
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


def flash_gated_attention_lse(q, k, v, gate, bias_rel,
                              key_padding_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, T, D], lse [B, H, T] float32)``; see
    :func:`flash_gated_attention`."""
    _check_inputs(q, k, v, gate, bias_rel, key_padding_mask)
    require_no_grad(q, k, v, gate, bias_rel,
                    what="flash_gated_attention (K5 has no backward yet)")
    b, _, t, _ = q.shape
    madd = mask_add(key_padding_mask, b, t, q.device)
    if q.device.type == "cuda":
        return _kernel_fwd(q, k, v, gate, bias_rel, madd)
    if q.device.type == "cpu":
        return flash_attention_plain_fwd(q, k, v, gate, bias_rel, madd)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_gated_attention(q, k, v, gate, bias_rel,
                          key_padding_mask: Optional[torch.Tensor] = None):
    """Gated-bias attention with the Toeplitz position bias, no gradient.

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
