"""Waveform feature normalisation (the HF feature extractor's
``do_normalize``) on device tensors.

Port of ``nrse_tpu/audio/features.py:20-37``.
"""

from __future__ import annotations

from typing import Optional

import torch


def zero_mean_unit_var(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       eps: float = 1e-7) -> torch.Tensor:
    """Per-utterance z-normalisation over the last axis with the biased
    variance.  With ``mask`` (1 = valid) the statistics cover the valid
    samples only and the padding stays exactly zero."""
    if mask is None:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps)
    mask = mask.to(x.dtype)
    count = torch.clamp_min(mask.sum(-1, keepdim=True), 1.0)
    mean = (x * mask).sum(-1, keepdim=True) / count
    var = (((x - mean) * mask) ** 2).sum(-1, keepdim=True) / count
    return (x - mean) / torch.sqrt(var + eps) * mask
