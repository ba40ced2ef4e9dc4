"""Clean-vs-noisy evaluation of a trained emotion classifier.

    python -m nrse_tpu_torch.evaluate_emotion --config <yaml or preset> \
        --checkpoint <checkpoint_dir>/<name> \
        [--task categorical|dimensional] [--device cuda|cpu] \
        [--out-json report.json]

Port of the root ``evaluate_emotion.py:22-145``: restore a checkpoint of
the port's SER trainers (``train.checkpoint``), run the validation split
of the config once clean and once with the training noise mixed in
(``emotion.add_noise_during_training``), and print the same table of
each metric clean, noisy and their difference: accuracy and macro-F1
(numpy, ``eval.metrics``) for ``categorical``, CCC per dimension for
``dimensional``.  Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict

import numpy as np

from nrse_tpu_torch.config.config_utils import load_config, validate_config
from nrse_tpu_torch.data.emotion_dataset import create_emotion_dataloaders
from nrse_tpu_torch.data.loader import DevicePrefetcher
from nrse_tpu_torch.eval.metrics import accuracy, f1_scores
from nrse_tpu_torch.runtime.device import resolve_device
from nrse_tpu_torch.train.categorical_emotions import build_classifier
from nrse_tpu_torch.train.checkpoint import restore_checkpoint
from nrse_tpu_torch.train.emotion_trainer import (
    create_emotion_state,
    make_emotion_eval_step,
)
from nrse_tpu_torch.train.losses import compute_ccc

DIMS = ("arousal", "valence", "dominance")


def evaluate(config, checkpoint_path: str, task: str = "categorical"
             ) -> Dict[str, Dict[str, float]]:
    """``{"clean": metrics, "noisy": metrics}`` of the checkpoint on the
    config's validation split; prints the report."""
    device = resolve_device(config.get("device", "cuda"))
    state = create_emotion_state(build_classifier(config, device, 0,
                                                  pretrained_encoder=False))
    ckpt_dir, name = os.path.split(checkpoint_path.rstrip("/"))
    state, meta = restore_checkpoint(ckpt_dir, name, state)
    print(f"loaded checkpoint {checkpoint_path} (meta: {meta})", flush=True)
    eval_step = make_emotion_eval_step(task)

    def run(add_noise: bool) -> Dict[str, float]:
        cfg = copy.deepcopy(config)
        cfg["emotion"]["add_noise_during_training"] = add_noise
        _, val_loader = create_emotion_dataloaders(cfg)
        preds, labels, dims, tgts = [], [], [], []
        for batch in DevicePrefetcher(val_loader, device):
            count = batch.pop("__count__")
            out = eval_step(state.model, batch)
            if "logits" in out:
                preds.append(out["logits"][:count].argmax(-1).cpu().numpy())
                labels.append(batch["C"][:count].cpu().numpy())
            if "dims" in out:
                dims.append(out["dims"][:count].cpu().numpy())
                tgts.append(np.stack([batch[k][:count].cpu().numpy()
                                      for k in ("A", "V", "D")], 1))
        result = {}
        if preds:
            y_pred, y = np.concatenate(preds), np.concatenate(labels)
            valid = (y >= 0) & (y < 8)
            result["accuracy"] = accuracy(y[valid], y_pred[valid])
            result["macro_f1"] = f1_scores(y[valid], y_pred[valid])["macro"]
        if dims:
            p, g = np.concatenate(dims), np.concatenate(tgts)
            for i, nm in enumerate(DIMS):
                result[f"ccc_{nm}"] = compute_ccc(p[:, i], g[:, i])
        return result

    clean = run(add_noise=False)
    noisy = run(add_noise=True)
    print("\n=== Emotion robustness report ===")
    print(f"{'metric':<16}{'clean':>10}{'noisy':>10}{'delta':>10}")
    for k in clean:
        d = noisy.get(k, float("nan")) - clean[k]
        print(f"{k:<16}{clean[k]:>10.4f}{noisy.get(k, float('nan')):>10.4f}"
              f"{d:>10.4f}", flush=True)
    return {"clean": clean, "noisy": noisy}


def main(argv=None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser(
        description="Clean-vs-noisy report of a trained emotion classifier")
    parser.add_argument("--config", required=True,
                        help="YAML config file, or a preset name")
    parser.add_argument("--checkpoint", required=True,
                        help="a checkpoint directory of the SER trainers "
                             "(e.g. <checkpoint_dir>/best_classifier_model)")
    parser.add_argument("--task", default="categorical",
                        choices=["categorical", "dimensional"])
    parser.add_argument("--device", default=None, help="cuda or cpu")
    parser.add_argument("--out-json", default=None,
                        help="also write the {clean, noisy} report here")
    args = parser.parse_args(argv)
    config = validate_config(load_config(args.config))
    if args.device:
        config["device"] = args.device
    report = evaluate(config, args.checkpoint, args.task)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f)
    return report


if __name__ == "__main__":
    main()
