"""Dimensional SER trainer (arousal/valence/dominance CCC regression).

Port of ``nrse_tpu/train/dimentional_emotions.py:43-228`` (the file name's
spelling kept; capability parity with the reference's
``src/train/dimentional_emotions.py:18-303``): the categorical trainer's
two-phase skeleton (``categorical_emotions.train_emotion_task``) with the
CCC loss, the epoch's CCC per dimension (``compute_ccc``'s, from the
moments ``ccc_moments`` sums, which ranks pool) and their mean as the
plateau's and the checkpoints' metric, and a pred-vs-GT scatter plot per
dimension at each new best (drawn only where matplotlib imports; under
data parallelism rank 0 draws its own rows).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from nrse_tpu_torch.train.categorical_emotions import (
    TaskRecipe,
    placed_batches,
    pooled,
    train_emotion_task,
)
from nrse_tpu_torch.train.losses import (
    ccc_from_moments,
    ccc_loss,
    ccc_moments,
)
from nrse_tpu_torch.utils.logging_utils import logger

DIMS = ("arousal", "valence", "dominance")


def plot_scatter(predictions, targets, filename, title="Scatter Plot",
                 x_label="Predicted", y_label="Ground Truth") -> bool:
    """Pred-vs-GT scatter (reference ``dimentional_emotions.py:468-484``);
    False, with one log line, where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        logger.info(f"scatter plot skipped: {e}")
        return False
    plt.figure(figsize=(8, 8))
    plt.scatter(predictions, targets, alpha=0.4)
    lo = min(float(np.min(predictions)), float(np.min(targets)))
    hi = max(float(np.max(predictions)), float(np.max(targets)))
    plt.plot([lo, hi], [lo, hi], "r--")
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.title(title)
    plt.tight_layout()
    plt.savefig(filename)
    plt.close()
    return True


def _validate(model, val_loader, eval_step, device, mesh=None):
    """Full validation pass → ``(ccc loss, {dim: ccc}, preds, targets)``;
    under a ``mesh`` the loss and the CCC are of every rank's rows (each
    batch's loss parts and the moments pooled), ``preds`` and ``targets``
    this rank's."""
    preds, tgts, losses = [], [], []
    for batch in placed_batches(val_loader, device, mesh):
        count = batch.pop("__count__")
        dims = eval_step(model, batch)["dims"][:count]
        t = torch.stack([batch[k][:count] for k in ("A", "V", "D")], dim=1)
        losses.append(ccc_loss(dims, t, mesh=mesh))
        preds.append(dims.cpu().numpy())
        tgts.append(t.cpu().numpy())
    preds, tgts = np.concatenate(preds), np.concatenate(tgts)
    moments = pooled(torch.from_numpy(ccc_moments(preds, tgts)), mesh)
    values = ccc_from_moments(moments.cpu().numpy())
    ccc = {name: float(values[i]) for i, name in enumerate(DIMS)}
    return float(pooled(torch.stack(losses), mesh).mean()), ccc, preds, tgts


def _validate_dimensional(model, val_loader, eval_step, weights, device,
                          mesh=None):
    loss, ccc, preds, tgts = _validate(model, val_loader, eval_step, device,
                                       mesh)
    return loss, float(np.mean(list(ccc.values()))), (ccc, preds, tgts)


def _report(phase, epoch, epochs, train_loss, val_loss, avg, extras, lr):
    ccc = extras[0]
    log = {f"{phase}/train_loss": train_loss, f"{phase}/val_loss": val_loss,
           f"{phase}/val_ccc": avg, f"{phase}/lr": lr, "epoch": epoch}
    for name, v in ccc.items():
        log[f"{phase}/ccc_{name}"] = v
    line = (f"[{phase}] epoch {epoch + 1}/{epochs} "
            f"train_loss={train_loss:.4f} val_ccc={avg:.4f} "
            f"(A={ccc['arousal']:.3f} V={ccc['valence']:.3f} "
            f"D={ccc['dominance']:.3f}) lr={lr:.2e}")
    return log, line


def _on_best(extras, log_dir, wandb) -> None:
    ccc, preds, tgts = extras
    for i, name in enumerate(DIMS):
        path = os.path.join(log_dir, f"val_scatter_{name}.png")
        if plot_scatter(preds[:, i], tgts[:, i], path,
                        title=f"Validation {name} (CCC={ccc[name]:.3f})"):
            wandb.log({f"val_scatter_{name}": wandb.Image(path)})


DIMENSIONAL = TaskRecipe(task="dimensional",
                         project="nrse-emotion-dimensional", metric="ccc",
                         start=-np.inf, validate=_validate_dimensional,
                         report=_report, on_best=_on_best)


def train_dimensional_emotions(config) -> Dict:
    """Train the dimensional regressor; returns ``{"best_ccc", "epochs",
    "state"}`` (``categorical_emotions.train_emotion_task``)."""
    return train_emotion_task(config, DIMENSIONAL)
