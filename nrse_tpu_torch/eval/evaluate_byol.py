"""BYOL validation: the loss, the clean↔noisy similarity per SNR, and the
t-SNE plot of the embeddings.

Port of ``nrse_tpu/eval/evaluate_byol.py:41-161``:
``evaluate_embedding_similarity`` (the mean cosine of the online encoder's
pooled clean and noisy embeddings, per SNR of ``data.snr_range``),
``validate_model`` (the BYOL loss and those similarities from one pass of
``train.byol_trainer.make_byol_eval_step``) and ``visualize_embeddings``
(a t-SNE scatter of the clean and the per-SNR noisy embeddings, saved as a
PNG; scikit-learn and matplotlib are imported inside it, and the card's
machine has neither).  The per-sample outputs stay on the device until the
pass ends; the means are weighted by the real rows of each batch (the
validation loader pads its last batch) and taken in float64 over the
float32 per-sample values.  (JAX's ``validate_model`` takes numpy's mean
of the similarities in the compute dtype, bf16 on the TPU, whose
accumulator rounds: its per-SNR readings there sit above the mean.)  In
a group of ranks each rank
validates its shard and ``validate_model`` pools the sums and counts
(``train_byol.py:190-215`` of the JAX package), so every rank gets the
weighted means of the whole validation set.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from nrse_tpu_torch.data.loader import DevicePrefetcher
from nrse_tpu_torch.parallel.distributed import aggregate_sums, process_count
from nrse_tpu_torch.train.byol_trainer import (
    BYOLTrainState,
    make_byol_eval_step,
)
from nrse_tpu_torch.utils.logging_utils import logger


def _run_eval_pass(state: BYOLTrainState, loader, depth: int = 2,
                   collect_embeddings: bool = False, max_batches: int = 0):
    """``(losses, similarities, snrs, embeddings)`` of every real row of
    the first ``max_batches`` batches (all for 0), as numpy;
    ``embeddings`` is ``(clean [N, C], noisy [N, C])`` of the online
    encoder with ``collect_embeddings``, else None."""
    eval_step = make_byol_eval_step(embeddings=collect_embeddings)
    outs = [[] for _ in range(5 if collect_embeddings else 3)]
    for i, batch in enumerate(DevicePrefetcher(loader, state.params.device,
                                               depth)):
        if max_batches and i >= max_batches:
            break
        count = batch.pop("__count__")
        res = eval_step(state, batch)
        for out, r in zip(outs, (res[0], res[1], batch["snr"], *res[2:])):
            out.append(r[:count])
    if not outs[0]:
        empty = np.zeros(0, np.float32)
        return empty, empty, empty, None
    arrays = [torch.cat(x).float().cpu().numpy() for x in outs]
    return (*arrays[:3], tuple(arrays[3:]) if collect_embeddings else None)


def evaluate_embedding_similarity(state: BYOLTrainState, dataloader, config
                                  ) -> Dict[float, float]:
    """Per-SNR mean similarity; 0.0 for an SNR no row has."""
    _, sims, snrs, _ = _run_eval_pass(state, dataloader)
    out = {}
    for snr in config["data"]["snr_range"]:
        mask = snrs == float(snr)
        out[snr] = float(sims[mask].mean(dtype=np.float64)) if mask.any() \
            else 0.0
    return out


def validate_model(state: BYOLTrainState, val_loader, config
                   ) -> Tuple[float, Dict]:
    """``(val_loss, metrics)`` with ``metrics`` holding ``val_loss``,
    ``val_avg_similarity`` (the mean over the SNRs that have rows) and
    ``val_similarities`` (per SNR; SNRs without rows are left out); in a
    group of ranks, of every rank's rows (pooled sums and counts over the
    data axis, a bin empty here may hold rows elsewhere).  ``val_samples``
    holds what they were taken from: this rank's real rows' ``loss``,
    ``similarity`` and ``snr``, float32 numpy arrays in loader order."""
    losses, sims, snrs, _ = _run_eval_pass(state, val_loader)
    snr_range = config["data"]["snr_range"]
    if process_count() > 1:
        sums = {"loss_sum": losses.sum(dtype=np.float64),
                "loss_cnt": len(losses)}
        for snr in snr_range:
            mask = snrs == float(snr)
            sums[f"snr_{snr}_sum"] = sims[mask].sum(dtype=np.float64)
            sums[f"snr_{snr}_cnt"] = int(mask.sum())
        totals = aggregate_sums(sums, state.mesh)
        avg_loss = totals["loss_sum"] / totals["loss_cnt"] \
            if totals["loss_cnt"] else float("inf")
        similarities = {snr: totals[f"snr_{snr}_sum"]
                        / totals[f"snr_{snr}_cnt"] for snr in snr_range
                        if totals[f"snr_{snr}_cnt"]}
    else:
        avg_loss = float(losses.mean(dtype=np.float64)) if len(losses) \
            else float("inf")
        similarities = {}
        for snr in snr_range:
            mask = snrs == float(snr)
            if mask.any():
                similarities[snr] = float(sims[mask].mean(dtype=np.float64))
    avg_similarity = (sum(similarities.values()) / len(similarities)
                      if similarities else 0.0)
    return avg_loss, {"val_loss": avg_loss,
                      "val_avg_similarity": avg_similarity,
                      "val_similarities": similarities,
                      "val_samples": {"loss": losses, "similarity": sims,
                                      "snr": snrs}}


def visualize_embeddings(state: BYOLTrainState, dataloader, log_dir: str,
                         img_file_name: str, num_samples: int = 100) -> str:
    """A t-SNE scatter of the clean (o) and the per-SNR noisy (x) pooled
    embeddings of the first ``num_samples // batch_size`` batches, saved
    as ``log_dir/img_file_name``; returns its path.  Raises
    ``ImportError`` where scikit-learn or matplotlib is absent."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    batches = max(1, num_samples // max(1, dataloader.batch_size))
    _, _, snrs, (clean, noisy) = _run_eval_pass(
        state, dataloader, collect_embeddings=True, max_batches=batches)
    all_emb = np.concatenate([clean, noisy], axis=0)
    perplexity = min(30, max(2, len(all_emb) // 4))
    tsne = TSNE(n_components=2, random_state=42, perplexity=perplexity)
    pts = tsne.fit_transform(all_emb)
    c_pts, n_pts = pts[: len(clean)], pts[len(clean):]

    os.makedirs(log_dir, exist_ok=True)
    plt.figure(figsize=(10, 8))
    plt.scatter(c_pts[:, 0], c_pts[:, 1], marker="o", color="blue",
                alpha=0.7, label="Clean")
    uniq = sorted(set(snrs.tolist()))
    colors = plt.cm.rainbow(np.linspace(0, 1, len(uniq)))
    for color, snr in zip(colors, uniq):
        idx = snrs == snr
        plt.scatter(n_pts[idx, 0], n_pts[idx, 1], marker="x", color=color,
                    alpha=0.7, label=f"Noisy (SNR={int(snr)}dB)")
    plt.title("t-SNE of speech embeddings (clean vs noisy)")
    plt.legend()
    out_path = os.path.join(log_dir, img_file_name)
    plt.savefig(out_path)
    plt.close()
    logger.info(f"Visualization saved to {out_path}")
    return out_path
