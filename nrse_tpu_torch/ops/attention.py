"""Gated relative-position-bias self-attention in plain PyTorch.

Port of ``nrse_tpu/ops/attention.py:50-98`` and the plain versions of
kernel A and K3 (``ops/block_attention.py``): ``softmax(q·kᵀ/√d + gate ⊙
bias + key mask)·v`` with the gate applied to the batch-shared ``[H, T,
T]`` bias in factored form, optionally followed by output dropout, and its
backward.  The arithmetic follows the TPU block kernels
(``nrse_tpu/ops/block_attention.py:136-158`` forward, ``:191-229``
backward) step for step, so the CUDA kernels can be held to it on the
card:

  * scores, softmax max and sum in float32, the products of the inputs
    accumulated in float32;
  * padded keys get an additive −1e9, not −inf, so a row whose keys are all
    padded stays finite (``nrse_tpu/ops/attention.py:26``);
  * the unnormalised probabilities are rounded to the input dtype before
    the PV product, which is divided by ``max(Σp, 1e-30)`` afterwards;
  * dropout multiplies the float32 output by its keep mask before the cast;
  * the backward recomputes the probabilities from the saved ``lse``,
    folds the keep mask into ``do`` before any product, rounds ``p``
    and ``ds`` to the input dtype before the products that take them, and
    sums ``dbias`` over the batch in a fixed grouped order
    (:func:`grouped_dbias`).

The keep mask of the attention output is K1's mask at the same seed over
the merged ``[B, T, C]`` layout (:func:`attention_keep_mask`): the element
``(b, h, t, d)`` draws at flat index ``(b·T + t)·C + h·D + d``, so moving
the dropout into the attention kernel leaves the train step's random
streams as they were.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nrse_tpu_torch.ops import philox

NEG_INF = -1e9
# the plain backward sums gate·ds over groups of DBIAS_GROUP batches in
# batch order, then the groups' sums in order
DBIAS_GROUP = 4


def mask_add(key_padding_mask: Optional[torch.Tensor], b: int, t: int,
             device) -> torch.Tensor:
    """``[B, T]`` float32 additive key mask: 0 for a valid key (mask 1),
    −1e9 for a padded one.  ``None`` means every key is valid."""
    if key_padding_mask is None:
        return torch.zeros(b, t, dtype=torch.float32, device=device)
    valid = key_padding_mask.to(device=device, dtype=torch.bool)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def attention_keep_mask(seed: Tuple[int, int], shape, p: float,
                        device=None) -> torch.Tensor:
    """The float32 ``{0, 1/(1−p)}`` keep mask ``[B, H, T, D]`` of the
    attention output under ``seed``: K1's mask (Philox site 0) over the
    merged ``[B, T, H·D]`` layout, moved to the head layout."""
    b, h, t, d = shape
    return philox.dump_mask(seed, 0, (b, t, h, d), p,
                            device=device).permute(0, 2, 1, 3)


def _scores(q, k, gate, pos_bias, madd):
    """``q·kᵀ/√d + gate ⊙ bias + madd`` in float32, ``[B, H, T, T]``."""
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + gate.float()[..., None] * pos_bias.float()[None]
    return scores + madd[:, None, None, :]


def gated_bias_attention_lse(q, k, v, gate, pos_bias,
                             key_padding_mask=None,
                             dropout_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, T, D] in v's dtype, lse [B, H, T] float32)``.

    q, k, v: ``[B, H, T, D]``; gate: ``[B, H, T]``; pos_bias: ``[H, T, T]``;
    key_padding_mask: optional ``[B, T]`` (1 = valid key); dropout_mask:
    optional float32 ``{0, 1/(1−p)}`` ``[B, H, T, D]`` applied to the
    output before the cast (``lse`` is the softmax's, without dropout).
    """
    b, _, t, _ = q.shape
    return gated_bias_attention_fwd(
        q, k, v, gate, pos_bias, mask_add(key_padding_mask, b, t, q.device),
        dropout_mask)


def gated_bias_attention_fwd(q, k, v, gate, pos_bias, madd,
                             dropout_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gated_bias_attention_lse` from the ``[B, T]`` additive key
    mask ``madd`` (:func:`mask_add`), as the kernel takes it."""
    scores = _scores(q, k, gate, pos_bias, madd)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = acc / l
    if dropout_mask is not None:
        out = out * dropout_mask
    return out.to(v.dtype), (m + torch.log(l))[..., 0]


def gated_bias_attention_bwd(q, k, v, gate, pos_bias, madd, out, lse, do,
                             mask: Optional[torch.Tensor] = None):
    """The backward of :func:`gated_bias_attention_lse` in the TPU
    kernel's arithmetic: ``(dq, dk, dv)`` in q's dtype, ``dgate [B, H, T]``
    float32 and ``dbias [H, T, T]`` float32 summed over the batch.

    madd: ``[B, T]`` additive key mask (:func:`mask_add`); out: the forward
    output *after* dropout; lse: its ``[B, H, T]`` log-sum-exp; do: the
    cotangent of ``out``; mask: the forward's dropout keep mask, if any.
    ``delta = rowsum(do ⊙ out)`` equals ``rowsum((do·mask) ⊙ o)`` for the
    output ``o`` before dropout, so the mask enters once either way.
    """
    mm = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    if mask is not None:
        do = (do.float() * mask).to(mm)
    p = torch.exp(_scores(q, k, gate, pos_bias, madd) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta)
    pb, dsb = p.to(mm).float(), ds.to(mm).float()
    dv = torch.matmul(pb.transpose(-1, -2), do.float()).to(mm)
    dq = (torch.matmul(dsb, k.float()) * scale).to(mm)
    dk = (torch.matmul(dsb.transpose(-1, -2), q.float()) * scale).to(mm)
    dgate = (ds * pos_bias.float()[None]).sum(-1)
    return dq, dk, dv, dgate, grouped_dbias(gate, ds, DBIAS_GROUP)


def grouped_dbias(gate, ds, group: int) -> torch.Tensor:
    """``dbias [H, T, T] = Σ_b gate[b]·ds[b]`` in a fixed order: each
    group of ``group`` batches summed in batch order into a partial, then
    the partials in group order (float32)."""
    contrib = gate.float()[..., None] * ds
    dbias = None
    for g0 in range(0, contrib.shape[0], group):
        part = contrib[g0]
        for b in range(g0 + 1, min(g0 + group, contrib.shape[0])):
            part = part + contrib[b]
        dbias = part if dbias is None else dbias + part
    return dbias


def gated_bias_attention(q, k, v, gate, pos_bias, key_padding_mask=None):
    """Gated-bias attention output ``[B, H, T, D]`` (see
    :func:`gated_bias_attention_lse`)."""
    return gated_bias_attention_lse(q, k, v, gate, pos_bias,
                                    key_padding_mask)[0]
