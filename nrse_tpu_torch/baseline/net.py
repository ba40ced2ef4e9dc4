"""The baseline's classifier head.

Port of ``nrse_tpu/baseline/net.py:23-40``: ``EmotionRegression``,
``num_layers`` × [Dense → LayerNorm → ReLU → Dropout] → Dense(out), in
float32 whatever the input's dtype; the dropout draws from a
``models.wavlm.TrainRNG`` stream.  The LayerNorm is flax's, with eps
1e-6 (torch's default is 1e-5).  Submodule names follow the flax ones
(``fc_i``, ``norm_i``, ``out``), so the converter maps the JAX tree by
name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nrse_tpu_torch.models.wavlm import STREAM_HEAD_DROPOUT, TrainRNG

# flax LayerNorm's default epsilon
LAYER_NORM_EPS = 1e-6


class EmotionRegression(nn.Module):
    """MLP emotion head: input_dim → hidden (× num_layers) → output_dim."""

    def __init__(self, input_dim: int, hidden_dim: int = 1024,
                 num_layers: int = 1, output_dim: int = 8,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        dims = [input_dim] + [hidden_dim] * num_layers
        for i in range(num_layers):
            self.add_module(f"fc_{i}", nn.Linear(dims[i], hidden_dim,
                                                 device=device))
            self.add_module(f"norm_{i}", nn.LayerNorm(
                hidden_dim, eps=LAYER_NORM_EPS, device=device))
        self.out = nn.Linear(dims[-1], output_dim, device=device)

    def head_keep(self, rng: TrainRNG, batch: int) -> torch.Tensor:
        """The dropout keep masks of a training forward on ``batch`` rows,
        ``[num_layers, batch, hidden_dim]`` bool on the CPU, drawn as
        :meth:`forward` draws them: ``rng``'s head stream, one draw a
        layer, in order."""
        gen = rng.generator(STREAM_HEAD_DROPOUT)
        keep = torch.zeros(self.num_layers, batch, self.hidden_dim,
                           dtype=torch.bool)
        for i in range(self.num_layers):
            keep[i] = torch.rand((batch, self.hidden_dim),
                                 generator=gen) >= self.dropout
        return keep

    def forward(self, x: torch.Tensor, rng: Optional[TrainRNG] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """In training mode with ``dropout`` > 0, the masks come from
        ``rng``'s head stream (a seeded CPU generator, never torch's
        global one), which training mode then requires; ``keep``: those
        masks as :meth:`head_keep` draws them, already on the device (a
        trainer's staged buffer), or None to draw them here."""
        drop = self.training and self.dropout > 0.0
        if drop and rng is None:
            raise ValueError("EmotionRegression in training mode needs rng "
                             "(a TrainRNG) for its dropout")
        gen = rng.generator(STREAM_HEAD_DROPOUT) \
            if drop and keep is None else None
        h = x.float()
        for i in range(self.num_layers):
            h = F.relu(getattr(self, f"norm_{i}")(getattr(self, f"fc_{i}")(h)))
            if drop:  # flax's Dropout: keep with 1 − p, scale by 1/(1 − p)
                k = keep[i] if keep is not None else (
                    torch.rand(h.shape, generator=gen) >= self.dropout
                ).to(h.device)
                h = torch.where(k, h / (1.0 - self.dropout),
                                torch.zeros_like(h))
        return self.out(h)
