"""BYOL dual-tower model for noise-robust speech embeddings.

Port of ``nrse_tpu/models/byol.py:36-320``: the online tower (WavLM
encoder → masked-mean pooled embedding → projector → predictor) and the
target tower (encoder → projector), whose weights start as a real copy of
the online tower's and then follow it by EMA; the loss
``2 − 2·cos(pred, proj)`` with the reference's guards.  The heads run in
float32 on ``pooled.float()``.  Submodule names (``encoder``,
``projector``, ``predictor``) follow the JAX trees, so the online and the
target parameters line up in order: the target's are a prefix of the
online tower's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nrse_tpu_torch.models.heads import PredictionHead, ProjectionHead
from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMConfig, WavLMModel
from nrse_tpu_torch.parallel.distributed import all_reduce_sum

ONLINE, TARGET = 0, 1  # TrainRNG towers


class TargetNetwork(nn.Module):
    """Encoder → projector.  Returns ``(proj, pooled)``."""

    def __init__(self, config: WavLMConfig, projection_dim: int = 1024,
                 device=None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = WavLMModel(config, device, compute_dtype)
        self.projector = ProjectionHead(config.hidden_size, projection_dim,
                                        projection_dim, device)

    def forward(self, input_values, rng: Optional[TrainRNG] = None):
        _, pooled = self.encoder(input_values, rng=rng)
        pooled = pooled.float()
        return self.projector(pooled), pooled


class OnlineNetwork(TargetNetwork):
    """Encoder → projector → predictor.  Returns ``(pred, proj, pooled)``."""

    def __init__(self, config: WavLMConfig, projection_dim: int = 1024,
                 prediction_dim: int = 2048, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(config, projection_dim, device, compute_dtype)
        self.predictor = PredictionHead(projection_dim, prediction_dim,
                                        projection_dim, device)

    def heads(self, pooled):
        """``(pred, proj)`` from a pooled embedding."""
        proj = self.projector(pooled.float())
        return self.predictor(proj), proj

    def forward(self, input_values, rng: Optional[TrainRNG] = None):
        _, pooled = self.encoder(input_values, rng=rng)
        pooled = pooled.float()
        pred, proj = self.heads(pooled)
        return pred, proj, pooled


def make_target(online: OnlineNetwork) -> TargetNetwork:
    """The target tower as a real copy of the online encoder and projector
    (``nrse_tpu/models/byol.py:163-181``)."""
    enc = online.encoder
    target = TargetNetwork(enc.config, online.projector.bn_1.weight.numel(),
                           device="meta", compute_dtype=enc.compute_dtype)
    sd = {k: v.detach().clone() for k, v in online.state_dict().items()
          if not k.startswith("predictor.")}
    target.load_state_dict(sd, strict=True, assign=True)
    return target.train(online.training)


@torch.no_grad()
def ema_update(target: nn.Module, online: nn.Module, decay: float) -> None:
    """``t ← decay·t + (1 − decay)·o`` over the target's parameters and
    the online ones of the same names (``byol.py:224-237``)."""
    params = dict(online.named_parameters())
    for name, t in target.named_parameters():
        t.copy_(decay * t + (1.0 - decay) * params[name])


def byol_loss_per_sample(online_pred, target_proj) -> torch.Tensor:
    """Per-sample ``2 − 2·cos`` ``[B]`` with the reference's guards: a
    1e-10 offset, norms floored at 1e-10, the similarity clamped to
    [−1, 1]."""
    o = online_pred.float() + 1e-10
    t = target_proj.float() + 1e-10
    o = o / torch.clamp_min(torch.linalg.vector_norm(o, dim=1, keepdim=True),
                            1e-10)
    t = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=1, keepdim=True),
                            1e-10)
    sim = torch.clamp((o * t).sum(1), -1.0, 1.0)
    return 2.0 - 2.0 * sim


def byol_loss(online_pred, target_proj, weights=None,
              mesh=None) -> torch.Tensor:
    """Mean BYOL loss; per-sample ``weights [B]`` (e.g. the views'
    ``valid`` flags) mask degenerate items out.  With a ``mesh`` (a
    ``parallel.mesh.DataMesh``) this rank's part of the global batch's
    loss: its weighted sum over the weight sum of every rank
    (``nrse_tpu/models/byol.py:100-107`` on the global batch), so the
    ranks' parts add up to it whatever ``valid`` holds on each."""
    per_sample = byol_loss_per_sample(online_pred, target_proj)
    w = torch.ones_like(per_sample) if weights is None else \
        weights.to(per_sample.dtype)
    total = all_reduce_sum(w.sum().detach(), mesh)
    return (per_sample * w).sum() / torch.clamp_min(total, 1.0)
