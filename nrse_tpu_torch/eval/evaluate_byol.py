"""BYOL validation: the loss and the clean↔noisy similarity per SNR.

Port of ``nrse_tpu/eval/evaluate_byol.py:41-120``:
``evaluate_embedding_similarity`` (the mean cosine of the online encoder's
pooled clean and noisy embeddings, per SNR of ``data.snr_range``) and
``validate_model`` (the BYOL loss and those similarities from one pass of
``train.byol_trainer.make_byol_eval_step``).  The per-sample outputs stay
on the device until the pass ends; the means are weighted by the real rows
of each batch (the validation loader pads its last batch).  The t-SNE plot
(``visualize_embeddings``) is not ported: it needs scikit-learn and
matplotlib.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from nrse_tpu_torch.data.loader import DevicePrefetcher
from nrse_tpu_torch.train.byol_trainer import (
    BYOLTrainState,
    make_byol_eval_step,
)


def _run_eval_pass(state: BYOLTrainState, loader, depth: int = 2):
    """``(losses, similarities, snrs)`` of every real row, as numpy."""
    eval_step = make_byol_eval_step()
    losses, sims, snrs = [], [], []
    for batch in DevicePrefetcher(loader, state.params.device, depth):
        count = batch.pop("__count__")
        loss, sim = eval_step(state, batch)
        losses.append(loss[:count])
        sims.append(sim[:count])
        snrs.append(batch["snr"][:count])
    if not losses:
        empty = np.zeros(0, np.float32)
        return empty, empty, empty
    return tuple(torch.cat(x).float().cpu().numpy()
                 for x in (losses, sims, snrs))


def evaluate_embedding_similarity(state: BYOLTrainState, dataloader, config
                                  ) -> Dict[float, float]:
    """Per-SNR mean similarity; 0.0 for an SNR no row has."""
    _, sims, snrs = _run_eval_pass(state, dataloader)
    out = {}
    for snr in config["data"]["snr_range"]:
        mask = snrs == float(snr)
        out[snr] = float(sims[mask].mean()) if mask.any() else 0.0
    return out


def validate_model(state: BYOLTrainState, val_loader, config
                   ) -> Tuple[float, Dict]:
    """``(val_loss, metrics)`` with ``metrics`` holding ``val_loss``,
    ``val_avg_similarity`` (the mean over the SNRs that have rows) and
    ``val_similarities`` (per SNR; SNRs without rows are left out)."""
    losses, sims, snrs = _run_eval_pass(state, val_loader)
    avg_loss = float(losses.mean()) if len(losses) else float("inf")
    similarities = {}
    for snr in config["data"]["snr_range"]:
        mask = snrs == float(snr)
        if mask.any():
            similarities[snr] = float(sims[mask].mean())
    avg_similarity = (sum(similarities.values()) / len(similarities)
                      if similarities else 0.0)
    return avg_loss, {"val_loss": avg_loss,
                      "val_avg_similarity": avg_similarity,
                      "val_similarities": similarities}
