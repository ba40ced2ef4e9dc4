"""The SER heads' pooling layer.

Port of ``nrse_tpu/models/emotion.py:33-65``: attentive statistics
pooling with the flax parameter names and layouts (``sap_linear_kernel``
``[in, out]``, ``sap_linear_bias``, ``attention`` ``[in, 1]``), so the
converter copies the JAX leaves as they are, and the math of
``ops.asp_pooling``.  The SER classifier (``EmotionClassifier``) and its
freeze helpers come with their trainer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nrse_tpu_torch.ops.asp_pooling import (
    attentive_stats_pool,
    frame_mask_from_wav_mask,
)


class AttentiveStatisticsPooling(nn.Module):
    """ASP over ``[B, T, D]`` frames → ``[B, 2·D]`` float32; float32
    parameters, cast to the frames' dtype at their use."""

    def __init__(self, input_size: int, device=None):
        super().__init__()
        d = input_size
        self.sap_linear_kernel = nn.Parameter(torch.empty(d, d,
                                                          device=device))
        self.sap_linear_bias = nn.Parameter(torch.zeros(d, device=device))
        self.attention = nn.Parameter(torch.empty(d, 1, device=device))

    def forward(self, x: torch.Tensor,
                wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``wav_mask``: ``[B, T_wav]`` waveform mask (frames from the
        reference's 20 ms formula), or already ``[B, T]`` frames, or None
        (every frame valid)."""
        b, t, _ = x.shape
        if wav_mask is None:
            frame_mask = torch.ones(b, t, dtype=torch.bool, device=x.device)
        elif wav_mask.shape[1] == t:
            frame_mask = wav_mask.to(torch.bool)
        else:
            frame_mask = frame_mask_from_wav_mask(wav_mask, t)
        dt = x.dtype
        return attentive_stats_pool(x, frame_mask,
                                    self.sap_linear_kernel.to(dt),
                                    self.sap_linear_bias.to(dt),
                                    self.attention.to(dt))
