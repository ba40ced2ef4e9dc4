"""Gated relative-position-bias self-attention in plain PyTorch.

Port of ``nrse_tpu/ops/attention.py:50-98`` and the plain version of
kernel A (``ops/block_attention.py``): ``softmax(q·kᵀ/√d + gate ⊙ bias +
key mask)·v`` with the gate applied to the batch-shared ``[H, T, T]`` bias
in factored form.  The arithmetic follows the TPU block kernel
(``nrse_tpu/ops/block_attention.py:136-158``) step for step, so the CUDA
kernel can be held to it on the card:

  * scores, softmax max and sum in float32, the products of the inputs
    accumulated in float32;
  * padded keys get an additive −1e9, not −inf, so a row whose keys are all
    padded stays finite (``nrse_tpu/ops/attention.py:26``);
  * the unnormalised probabilities are rounded to the input dtype before
    the PV product, which is divided by ``max(Σp, 1e-30)`` afterwards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e9


def mask_add(key_padding_mask: Optional[torch.Tensor], b: int, t: int,
             device) -> torch.Tensor:
    """``[B, T]`` float32 additive key mask: 0 for a valid key (mask 1),
    −1e9 for a padded one.  ``None`` means every key is valid."""
    if key_padding_mask is None:
        return torch.zeros(b, t, dtype=torch.float32, device=device)
    valid = key_padding_mask.to(device=device, dtype=torch.bool)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def gated_bias_attention_lse(q, k, v, gate, pos_bias,
                             key_padding_mask=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, T, D] in v's dtype, lse [B, H, T] float32)``.

    q, k, v: ``[B, H, T, D]``; gate: ``[B, H, T]``; pos_bias: ``[H, T, T]``;
    key_padding_mask: optional ``[B, T]`` (1 = valid key).
    """
    b, h, t, d = q.shape
    scale = 1.0 / d ** 0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + gate.float()[..., None] * pos_bias.float()[None]
    madd = mask_add(key_padding_mask, b, t, q.device)
    scores = scores + madd[:, None, None, :]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(v.dtype)
    return out, (m + torch.log(l))[..., 0]


def gated_bias_attention(q, k, v, gate, pos_bias, key_padding_mask=None):
    """Gated-bias attention output ``[B, H, T, D]`` (see
    :func:`gated_bias_attention_lse`)."""
    return gated_bias_attention_lse(q, k, v, gate, pos_bias,
                                    key_padding_mask)[0]
