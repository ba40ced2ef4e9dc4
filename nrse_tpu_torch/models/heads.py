"""BYOL projection and prediction heads, in float32.

Port of ``nrse_tpu/models/heads.py:25-74``: Projection = Linear → BN →
ReLU → Linear → BN; Prediction = Linear → BN → ReLU → Linear → BN → ReLU →
Linear.  Submodule names follow the flax ones (``dense_0``, ``bn_0``, ...)
so the converter maps the trees one to one.

The BatchNorm is written by hand because flax's and torch's differ
(``BatchNorm``):
  * the running variance advances with the *biased* batch variance,
    ``E[x²] − E[x]²`` clipped at 0 (flax ``use_fast_variance=True``), where
    ``torch.nn.BatchNorm1d`` uses the unbiased one (36/35 larger at batch
    36); both normalise with the biased one;
  * flax's ``momentum=0.9`` keeps 0.9 of the running value, which is
    torch's ``momentum=0.1``.

Under data parallelism the batch statistics are the global batch's, as
GSPMD gives the JAX package (``nrse_tpu/models/heads.py:9-13``): Σx, Σx²
and the count are summed across the ranks with a gradient
(``parallel.distributed.all_reduce_sum``), so the running statistics
advance alike on every rank.  :func:`use_mesh` gives a tower's BatchNorms
the mesh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nrse_tpu_torch.parallel.distributed import all_reduce_sum


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the batch of
    ``[B, D]``: batch statistics in training mode (and the running ones
    advanced), running statistics in eval mode."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.mesh = None  # a parallel.mesh.DataMesh: global statistics
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x):
        x = x.float()
        if self.training:
            d = x.shape[1]
            count = torch.full((1,), x.shape[0], dtype=x.dtype,
                               device=x.device)
            sums = all_reduce_sum(
                torch.cat([x.sum(0), (x * x).sum(0), count]), self.mesh)
            mean = sums[:d] / sums[2 * d]
            var = torch.clamp_min(sums[d:2 * d] / sums[2 * d] - mean * mean,
                                  0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class ProjectionHead(nn.Module):
    """Linear → BN → ReLU → Linear → BN."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 device=None):
        super().__init__()
        self.dense_0 = nn.Linear(in_dim, hidden_dim, device=device)
        self.dense_1 = nn.Linear(hidden_dim, output_dim, device=device)
        self.bn_0 = BatchNorm(hidden_dim, device=device)
        self.bn_1 = BatchNorm(output_dim, device=device)

    def forward(self, x):
        h = F.relu(self.bn_0(self.dense_0(x.float())))
        return self.bn_1(self.dense_1(h))


class PredictionHead(nn.Module):
    """Linear → BN → ReLU → Linear → BN → ReLU → Linear."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 device=None):
        super().__init__()
        self.dense_0 = nn.Linear(in_dim, hidden_dim, device=device)
        self.dense_1 = nn.Linear(hidden_dim, hidden_dim, device=device)
        self.dense_2 = nn.Linear(hidden_dim, output_dim, device=device)
        self.bn_0 = BatchNorm(hidden_dim, device=device)
        self.bn_1 = BatchNorm(hidden_dim, device=device)

    def forward(self, x):
        h = F.relu(self.bn_0(self.dense_0(x.float())))
        h = F.relu(self.bn_1(self.dense_1(h)))
        return self.dense_2(h)


def use_mesh(module: nn.Module, mesh) -> None:
    """Every BatchNorm of ``module`` takes its training statistics over
    the ranks of ``mesh`` (None: its own rows)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
