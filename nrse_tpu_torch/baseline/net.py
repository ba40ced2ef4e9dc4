"""The baseline's classifier head.

Port of ``nrse_tpu/baseline/net.py:23-40``: ``EmotionRegression``,
``num_layers`` × [Dense → LayerNorm → ReLU → Dropout] → Dense(out), in
float32 whatever the input's dtype.  The LayerNorm is flax's, with eps
1e-6 (torch's default is 1e-5).  Submodule names follow the flax ones
(``fc_i``, ``norm_i``, ``out``), so the converter maps the JAX tree by
name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# flax LayerNorm's default epsilon
LAYER_NORM_EPS = 1e-6


class EmotionRegression(nn.Module):
    """MLP emotion head: input_dim → hidden (× num_layers) → output_dim."""

    def __init__(self, input_dim: int, hidden_dim: int = 1024,
                 num_layers: int = 1, output_dim: int = 8,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        dims = [input_dim] + [hidden_dim] * num_layers
        for i in range(num_layers):
            self.add_module(f"fc_{i}", nn.Linear(dims[i], hidden_dim,
                                                 device=device))
            self.add_module(f"norm_{i}", nn.LayerNorm(
                hidden_dim, eps=LAYER_NORM_EPS, device=device))
        self.out = nn.Linear(dims[-1], output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        for i in range(self.num_layers):
            h = getattr(self, f"norm_{i}")(getattr(self, f"fc_{i}")(h))
            h = F.dropout(F.relu(h), self.dropout, self.training)
        return self.out(h)
