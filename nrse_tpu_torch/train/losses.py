"""Task losses of the SER heads.

Port of ``nrse_tpu/train/losses.py:41-56,87-95`` (formula parity with the
reference):

  * :func:`ce_weight_category` — weighted cross-entropy that masks invalid
    labels (< 0 or ≥ K) instead of using ``ignore_index``, zero when no
    label is valid (``src/train/categorical_emotions.py:453-483``); the
    weighted mean ``Σ w_yi·ce_i / Σ w_yi`` of torch's
    ``CrossEntropyLoss(weight=w)``;
  * :func:`compute_ccc` — the concordance correlation coefficient in numpy
    for epoch metrics (``src/train/dimentional_emotions.py:453-465``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def ce_weight_category(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Masked weighted cross-entropy of ``logits [N, K]`` against integer
    ``labels [N]``; a float32 scalar on the logits' device."""
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
    denom = w.sum()
    loss = (nll * w).sum() / denom.clamp_min(1e-9)
    return torch.where(denom > 0, loss, torch.zeros_like(loss))


def compute_ccc(predictions: np.ndarray, targets: np.ndarray,
                eps: float = 1e-10) -> float:
    """Host-side CCC ``2·cov / (σp² + σt² + (μp − μt)² + eps)``."""
    p = np.asarray(predictions, np.float64)
    t = np.asarray(targets, np.float64)
    covar = np.mean((p - p.mean()) * (t - t.mean()))
    return float(
        2 * covar / (p.var() + t.var() + (p.mean() - t.mean()) ** 2 + eps)
    )
