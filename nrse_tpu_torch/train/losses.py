"""Task losses and class weighting of the SER heads.

Port of ``nrse_tpu/train/losses.py:30-95`` (formula parity with the
reference):

  * :func:`compute_class_weights` — ``(total / (count·K))^1.5`` boosted
    rare-class weights (``src/train/categorical_emotions.py:432-443``);
  * :func:`ce_weight_category` — weighted cross-entropy that masks invalid
    labels (< 0 or ≥ K) instead of using ``ignore_index``, zero when no
    label is valid (``src/train/categorical_emotions.py:453-483``); the
    weighted mean ``Σ w_yi·ce_i / Σ w_yi`` of torch's
    ``CrossEntropyLoss(weight=w)``;
  * :func:`focal_loss` — the reference's unused experiment, kept for
    parity (``categorical_emotions.py:446-451``);
  * :func:`ccc_loss` — per dimension ``1 − 2cov / (σp² + σt² + (μp −
    μt)² + 1e-10)``, averaged over A/V/D; 0 for a batch of one
    (``src/train/dimentional_emotions.py:427-450``);
  * :func:`compute_ccc` — the concordance correlation coefficient in numpy
    for epoch metrics (``src/train/dimentional_emotions.py:453-465``), and
    :func:`ccc_moments` / :func:`ccc_from_moments`, the same from sums
    that ranks can pool.

Under data parallelism (a ``mesh``) each rank holds rows of the global
batch, and the losses are those of the global batch, as GSPMD computes
JAX's on the sharded batch (``nrse_tpu/train/losses.py:43-62, 81-94``):
the CE's numerator over the global weight sum; the CCC from the global
means, variances and covariance (CCC is not a mean of per-rank CCCs),
this rank's share being the global value over the world size.  Either way
the ranks' losses add up to the global batch's, and the summed backward
(``parallel.distributed.all_reduce_sum``) gives each rank its rows'
gradient of it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nrse_tpu_torch.parallel.distributed import all_reduce_sum


def compute_class_weights(label_counts: Dict[int, int], num_classes: int,
                          exponent: float = 1.5) -> np.ndarray:
    """Rare-class-boosted float32 weights from a ``{class: count}``
    mapping; 1 for a class that does not occur (or lies outside
    ``[0, num_classes)``)."""
    weights = np.ones(num_classes, dtype=np.float32)
    total = float(sum(label_counts.values()))
    for cls, cnt in label_counts.items():
        if 0 <= cls < num_classes and cnt > 0:
            weights[cls] = (total / (cnt * num_classes)) ** exponent
    return weights


def ce_weight_category(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       mesh=None) -> torch.Tensor:
    """Masked weighted cross-entropy of ``logits [N, K]`` against integer
    ``labels [N]``; a float32 scalar on the logits' device.  With a
    ``mesh``, the denominator is every rank's."""
    num_classes = logits.shape[-1]
    labels = labels.to(device=logits.device, dtype=torch.int64)
    valid = (labels >= 0) & (labels < num_classes)
    safe = labels.clamp(0, num_classes - 1)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, safe[:, None])[:, 0]
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=logits.device)[safe]
    else:
        w = torch.ones_like(nll)
    w = w * valid.float()
    denom = all_reduce_sum(w.sum(), mesh)
    loss = (nll * w).sum() / denom.clamp_min(1e-9)
    return torch.where(denom > 0, loss, torch.zeros_like(loss))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha=None) -> torch.Tensor:
    """Focal loss, the unweighted mean over the batch (torch parity);
    ``alpha`` weights each sample by its class."""
    num_classes = logits.shape[-1]
    labels = labels.to(device=logits.device, dtype=torch.int64)
    safe = labels.clamp(0, num_classes - 1)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    ce = -log_probs.gather(-1, safe[:, None])[:, 0]
    if alpha is not None:
        ce = ce * torch.as_tensor(alpha, dtype=torch.float32,
                                  device=logits.device)[safe]
    pt = torch.exp(-ce)
    return ((1 - pt) ** gamma * ce).mean()


def ccc_loss(predictions: torch.Tensor, targets: torch.Tensor,
             eps: float = 1e-10, mesh=None) -> torch.Tensor:
    """Mean ``1 − CCC`` over the last axis's dimensions (A, V, D) of
    ``[N, 3]`` predictions and targets, in float32; 0 for N ≤ 1.  With a
    ``mesh``, N and the moments are the global batch's (two passes, each
    one sum across the ranks), and the result is this rank's share, the
    global loss over the world size."""
    p = predictions.float()
    t = targets.to(device=p.device, dtype=torch.float32)
    d = p.shape[1]
    count = torch.full((1,), p.shape[0], dtype=torch.float32,
                       device=p.device)
    first = all_reduce_sum(torch.cat([p.sum(0), t.sum(0), count]), mesh)
    n = first[2 * d:].clamp_min(1.0)
    mean_p, mean_t = first[:d] / n, first[d:2 * d] / n
    dp, dt = p - mean_p, t - mean_t
    second = all_reduce_sum(torch.cat([(dp * dp).sum(0), (dt * dt).sum(0),
                                       (dp * dt).sum(0)]), mesh) / n
    var_p, var_t, covar = second[:d], second[d:2 * d], second[2 * d:]
    ccc = 2 * covar / (var_p + var_t + (mean_p - mean_t) ** 2 + eps)
    loss = torch.where(first[2 * d] > 1.0, (1.0 - ccc).mean(), 0.0)
    return loss if mesh is None else loss / mesh.world


def ccc_moments(predictions: np.ndarray, targets: np.ndarray
                ) -> np.ndarray:
    """``[n, Σp, Σt, Σp², Σt², Σpt]`` per column of ``[N, D]`` arrays (a
    ``[6, D]`` float64 array): sums that ranks can add up."""
    p = np.asarray(predictions, np.float64).reshape(len(predictions), -1)
    t = np.asarray(targets, np.float64).reshape(len(targets), -1)
    return np.stack([np.full(p.shape[1], float(len(p))), p.sum(0), t.sum(0),
                     (p * p).sum(0), (t * t).sum(0), (p * t).sum(0)])


def ccc_from_moments(moments: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """:func:`compute_ccc` per column from :func:`ccc_moments` (pooled
    across ranks or not): ``2·cov / (σp² + σt² + (μp − μt)² + eps)``."""
    n, sp, st, spp, stt, spt = np.asarray(moments, np.float64)
    n = np.maximum(n, 1.0)
    mp, mt = sp / n, st / n
    vp, vt = spp / n - mp * mp, stt / n - mt * mt
    cov = spt / n - mp * mt
    return 2 * cov / (vp + vt + (mp - mt) ** 2 + eps)


def compute_ccc(predictions: np.ndarray, targets: np.ndarray,
                eps: float = 1e-10) -> float:
    """Host-side CCC ``2·cov / (σp² + σt² + (μp − μt)² + eps)``."""
    p = np.asarray(predictions, np.float64)
    t = np.asarray(targets, np.float64)
    covar = np.mean((p - p.mean()) * (t - t.mean()))
    return float(
        2 * covar / (p.var() + t.var() + (p.mean() - t.mean()) ** 2 + eps)
    )
