"""Masked attentive statistics pooling, batched.

Port of ``nrse_tpu/ops/asp_pooling.py:25-68`` (capability parity with the
reference's ``src/models/pool.py:11-58``: a tanh(Linear)·w attention over
the valid frames of each utterance, output concat(μ, σ) of the
attention-weighted statistics; the frame count from the waveform mask at
a 20 ms frame shift).  Padding frames get a −1e9 logit, so their softmax
weight is exactly 0 and one batched pass matches the reference's
per-utterance loop up to summation order.  The statistics are taken in
float32 whatever the frames' dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def frame_lengths_from_mask(mask: torch.Tensor, sample_rate: int = 16000,
                            frame_shift_s: float = 0.02) -> torch.Tensor:
    """Waveform mask ``[B, T_wav]`` → frame counts ``[B]`` (int64):
    ``(wav_len − 1) // 320 + 1`` at 16 kHz and 20 ms, the reference's
    formula (``pool.py:16-18``), not the conv stack's output length."""
    wav_lens = mask.to(torch.int64).sum(dim=1)
    hop = int(sample_rate * frame_shift_s)
    return torch.div(wav_lens - 1, hop, rounding_mode="floor") + 1


def frame_mask_from_wav_mask(mask: torch.Tensor, num_frames: int,
                             sample_rate: int = 16000,
                             frame_shift_s: float = 0.02) -> torch.Tensor:
    """Waveform mask ``[B, T_wav]`` → boolean frame mask
    ``[B, num_frames]``."""
    lengths = frame_lengths_from_mask(mask, sample_rate, frame_shift_s)
    idx = torch.arange(num_frames, device=mask.device)
    return idx[None, :] < lengths[:, None]


def attentive_stats_pool(x: torch.Tensor, frame_mask: torch.Tensor,
                         w_attn: torch.Tensor, b_attn: torch.Tensor,
                         v_attn: torch.Tensor,
                         var_floor: float = 1e-5) -> torch.Tensor:
    """``[B, 2·D]`` float32 = concat(μ, σ) of the attention-weighted
    frames.

    x: ``[B, T, D]`` in the working dtype; frame_mask: ``[B, T]`` bool;
    w_attn ``[D, D]`` (flax's ``[in, out]``), b_attn ``[D]``: the tanh
    projection; v_attn ``[D, 1]``: the attention vector; all in x's dtype.
    The softmax and the statistics run in float32, σ = √max(E[x²] − μ²,
    var_floor) as the JAX op computes it.  The JAX op takes the statistics
    in x's dtype; in bf16, E[x²] − μ² cancels, and its gradient turned a
    SER fine-tune step's gradient cosine against float32 from 0.998 into
    0.973 (PERF.md, PR 5; ROADMAP Queue 3).
    """
    h = torch.tanh(x @ w_attn + b_attn)
    logits = (h @ v_attn)[..., 0]
    logits = torch.where(frame_mask, logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits.float(), dim=1)[..., None]
    x = x.float()
    mu = (x * w).sum(dim=1)
    var = (x * x * w).sum(dim=1) - mu * mu
    sigma = torch.sqrt(torch.clamp(var, min=var_floor))
    return torch.cat([mu, sigma], dim=1)
