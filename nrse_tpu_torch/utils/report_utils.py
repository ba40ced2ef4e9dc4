"""What the evidence reports share: presets, the stage configs, the stages
and the clean / snr8 / snr4 readout.

Counterpart of ``tools/transfer_report.py:41-203``: the same configs of
the same stages, built from the port's copies of the presets
(``nrse_tpu_torch/config/presets``), without the TPU-only keys
(``tpu.remat``, ``tpu.frontend_remat``, ``tpu.rng_impl``), and the same
readout.  The stages run in this process through the port's entry points
(``train_byol.main``, ``train_emotion.run``,
``evaluate_emotion.evaluate``), each on the card unless the config says
``device: cpu``; after each one its state and its captured graphs are
freed (``runtime.graphs.release_graphs``), so that one stage's graphs
never hold the card's memory through the next.

The trainers start from seeded random weights, with a warning, where
``emotion.encoder_checkpoint`` names nothing (as the JAX trainers do), so
a leg meant to start from BYOL could silently start from random weights:
:func:`ser_encoder` reads the encoder of a leg's phase-1 checkpoint (the
encoder is frozen there, so it is the encoder the leg started from) and
:func:`same_encoder` holds it to the online encoder of the BYOL
checkpoint, bit for bit.
"""

from __future__ import annotations

import copy
import gc
import os
import subprocess
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nrse_tpu_torch.config.config_utils import PRESET_DIR, validate_config

EVAL_SNRS = (8, 4)


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = bits.astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32)


def bf16_numpy_mean(values) -> float:
    """The mean JAX's ``validate_model`` reads of per-sample similarities
    its bf16 eval step returned (``nrse_tpu/eval/evaluate_byol.py:100``):
    each value rounded to bfloat16, then numpy's mean of a bfloat16 array,
    which adds the values one after another in bfloat16, rounding every
    partial sum, and divides in bfloat16.  Past a sum of a few dozen the
    rounding of each addition no longer averages out, so the reading
    drifts from the mean (up, then down as the sum outgrows the values'
    spacing)."""
    v = to_bf16(np.asarray(values, np.float32).reshape(-1))
    acc = np.zeros(1, np.float32)
    for x in v:
        acc = to_bf16(acc + x)
    return float(to_bf16(acc / np.float32(len(v)))[0])


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or what ran instead."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card (CPU)"
    except (OSError, subprocess.SubprocessError):
        return "no card (CPU)"


def load_preset(name: str) -> Dict:
    """The port's copy of a preset (``nrse_tpu_torch/config/presets``), as
    PyYAML reads it."""
    import yaml

    with open(os.path.join(PRESET_DIR, name)) as f:
        return yaml.safe_load(f)


def symlink_split(audio_dir: str, out_dir: str, prefix: str) -> str:
    """Directory of symlinks to one split's WAVs (BYOL pretrains on the
    Train split only: no self-supervision on evaluation audio)."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(audio_dir)):
        if name.startswith(prefix):
            dst = os.path.join(out_dir, name)
            if not os.path.exists(dst):
                os.symlink(os.path.join(audio_dir, name), dst)
            n += 1
    if not n:
        raise FileNotFoundError(f"no {prefix}* files under {audio_dir}")
    return out_dir


def byol_config(clean_dir: str, noise_dir: str, ckpt_dir: str, epochs: int,
                batch: int, log_dir: str, smoke: bool = False,
                snr_range: Optional[Sequence[float]] = None) -> Dict:
    """The BYOL stage's config (``tools/transfer_report.py:63-92``)."""
    config = load_preset("default_wavlm-large_byol.yaml")
    config["training"].update({
        "batch_size": batch, "num_epochs": epochs,
        "checkpoint_dir": ckpt_dir, "log_dir": log_dir,
        "save_checkpoints": True,
        "early_stopping_patience": epochs,
    })
    config["data"].update({
        "clean_data_path": clean_dir, "noise_data_path": noise_dir,
    })
    if snr_range:
        # pretraining SNRs bracketing the evaluation's (the reference's
        # winning run used snr_range [2, 20])
        config["data"]["snr_range"] = list(snr_range)
    if smoke:
        config["model"]["name"] = "wavlm-tiny"
        config["model"].update({"projection_dim": 32, "prediction_dim": 64})
        config["data"]["max_audio_length"] = 1.0
        config["device"] = "cpu"
        config["tpu"] = {"compute_dtype": "float32",
                         "mesh": {"data": 1, "model": 1}}
    config["logging"].update({
        "wandb_mode": "disabled", "console_level": "WARNING",
        "visualization_interval": epochs + 1,  # no t-SNE plot
    })
    return config


def ser_config(preset: str, labels_csv: str, audio_dir: str, noise_dir: str,
               encoder_ckpt: Optional[str], ckpt_dir: str, epochs: int,
               batch: int, lr: float, categorical: bool, log_dir: str,
               smoke: bool = False, e2e: bool = False, ft_epochs: int = 0,
               ft_lr: float = 5e-6,
               snr_range: Optional[Sequence[float]] = None) -> Dict:
    """A SER leg's config (``tools/transfer_report.py:105-162``): phase 1
    with the encoder frozen and clean training audio; with ``e2e`` also
    phase 2, every encoder parameter trainable from its first epoch
    (``gradual_unfreeze: false``, the reference baseline's
    ``--freeze_ssl=False``) with noise mixed into the training audio."""
    config = load_preset(preset)
    config["training"]["log_dir"] = log_dir
    config["logging"].update({"wandb_mode": "disabled",
                              "console_level": "WARNING"})
    config["data"]["noise_data_path"] = noise_dir
    if snr_range:
        config["data"]["snr_range"] = list(snr_range)
    if smoke:
        config["model"]["name"] = "wavlm-tiny"
        config["model"].update({"projection_dim": 32, "prediction_dim": 64})
        config["data"]["max_audio_length"] = 1.0
        config["device"] = "cpu"
        config["emotion"]["hidden_dim"] = 32
        config["tpu"] = {"compute_dtype": "float32",
                         "mesh": {"data": 1, "model": 1}}
    config["emotion"].update({
        "encoder_checkpoint": encoder_ckpt,
        "checkpoint_dir": ckpt_dir,
        "labels_file": labels_csv,
        "audio_dir": audio_dir,
        "train_dataset_split": "Train",
        "validataion_dataset_split": "Development",
        "batch_size": batch,
        "classifier_epochs": epochs,
        "categorical_only": categorical,
        "learning_rate": lr,
    })
    if e2e:
        config["emotion"].update({
            "unfreeze_encoder": True,
            "gradual_unfreeze": False,
            "fine_tuning_epochs": ft_epochs,
            "fine_tuning_lr": ft_lr,
            "add_noise_during_training": True,
        })
    else:
        config["emotion"].update({
            "unfreeze_encoder": False,           # the frozen readout
            "add_noise_during_training": False,  # train clean, eval noisy
        })
    return config


def emotion_config(preset: str, args, labels_csv: str, audio_dir: str,
                   ckpt_dir: str, log_dir: str, categorical: bool) -> dict:
    """The SER reports' config (``tools/ser_report.py:57-85``,
    ``tools/ccc_report.py:51-76``): the preset, a frozen encoder from
    seeded random weights, clean training audio."""
    config = load_preset(preset)
    config["training"]["log_dir"] = log_dir
    config["logging"].update({"wandb_mode": "disabled",
                              "console_level": "WARNING"})
    config["emotion"].update({
        "encoder_checkpoint": None,       # a frozen random encoder, phase 1
        "checkpoint_dir": ckpt_dir,
        "labels_file": labels_csv,
        "audio_dir": audio_dir,
        "train_dataset_split": "Train",
        "validataion_dataset_split": "Development",
        "batch_size": args.batch,
        "classifier_epochs": args.epochs,
        "unfreeze_encoder": getattr(args, "unfreeze", False),
        "fine_tuning_lr": getattr(args, "ft_lr", 5e-6),
        "fine_tuning_epochs": getattr(args, "ft_epochs", 0),
        "add_noise_during_training": False,
        "categorical_only": categorical,
        "learning_rate": args.lr,
    })
    config["device"] = args.device
    return config


def epochs_table(epochs, metric: str) -> str:
    """A SER trainer's epoch records as markdown table rows: phase,
    epoch, train loss, val loss, ``metric``, data-fed s/step."""
    return "\n".join(
        f"| {e['phase']} | {e['epoch'] + 1} | {e['train_loss']:.4f} | "
        f"{e['val_loss']:.4f} | {e[metric]:.4f} | {e['s_per_step']:.4f} |"
        for e in epochs)


# what a stage's epoch records hold that a rerun must give again (not the
# host clock's readings)
RECORD_KEYS = ("phase", "epoch", "train_loss", "val_loss",
               "val_avg_similarity", "f1", "ccc", "lr", "steps")


def records(epochs) -> list:
    """A stage's epoch records without their times: what two runs of
    one command must give alike."""
    return [{k: e[k] for k in RECORD_KEYS if k in e} for e in epochs]


def checkpoint_digest(path: str) -> str:
    """sha256 of a checkpoint directory's state: every tensor's name,
    dtype, shape and bytes in name order, then the step and the seed."""
    import hashlib

    from nrse_tpu_torch.train.checkpoint import STATE_FILE

    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    h = hashlib.sha256()
    for name in sorted(saved["tensors"]):
        t = saved["tensors"][name].contiguous()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    h.update(f"step {saved['step']} seed {saved['seed']}".encode())
    return h.hexdigest()


def free_card() -> None:
    """Free every captured graph and what the collector can reach, then
    empty the card's cache: the next stage starts from the card alone."""
    from nrse_tpu_torch.runtime.graphs import release_graphs

    gc.collect()
    if torch.cuda.is_available():
        release_graphs()
        gc.collect()
        torch.cuda.empty_cache()


def run_byol(config: Dict, encoder=None) -> Dict:
    """BYOL pretraining through ``train_byol.main``; returns ``{"best":
    the best_val_loss checkpoint, "epochs": the epoch records,
    "captured": whether the last step ran from graphs, "steps"}`` and
    frees the state."""
    from nrse_tpu_torch import train_byol

    out = train_byol.main(config, encoder)
    best = os.path.join(config["training"]["checkpoint_dir"], "best_val_loss")
    if not os.path.isdir(best):
        raise FileNotFoundError(f"BYOL produced no checkpoint at {best}")
    info = {"best": best, "epochs": out["epochs"],
            "captured": out["state"].graphs is not None,
            "steps": sum(e["steps"] for e in out["epochs"])}
    del out
    free_card()
    return info


def train_ser(config: Dict, task: str) -> Dict:
    """One SER leg through ``train_emotion.run`` (``--task task``);
    returns ``{"best": the trainer's best metric, "epochs", "captured":
    whether the last step ran from graphs, "steps"}`` and frees the
    state."""
    from nrse_tpu_torch import train_emotion

    cfg = validate_config(copy.deepcopy(config))
    cfg["task"] = task
    result = train_emotion.run(cfg)[task]
    info = {"best": next(v for k, v in result.items()
                         if k.startswith("best_")),
            "epochs": result["epochs"],
            "captured": result["state"].graphs is not None,
            "steps": sum(e["steps"] for e in result["epochs"])}
    del result
    free_card()
    return info


def robustness_readout(config: Dict, ckpt_path: str, task: str,
                       eval_noise_dir: str, eval_batch: int = 64) -> Dict:
    """``{"clean", "snr8", "snr4"}`` metrics of a checkpoint through
    ``evaluate_emotion.evaluate`` on the validation split, the noisy runs
    mixing the held-out evaluation noise at one SNR each
    (``tools/transfer_report.py:165-203``, in this process: its readouts
    run one process each for a leak of the TPU runtime's)."""
    from nrse_tpu_torch.evaluate_emotion import evaluate

    out = {}
    for snr in EVAL_SNRS:
        cfg = validate_config(copy.deepcopy(config))
        cfg["data"]["noise_data_path"] = eval_noise_dir
        cfg["data"]["snr_range"] = [snr]
        if cfg.get("device") != "cpu":
            cfg["emotion"]["batch_size"] = eval_batch
        report = evaluate(cfg, ckpt_path, task)
        out.setdefault("clean", report["clean"])
        out[f"snr{snr}"] = report["noisy"]
        free_card()
    return out


def ser_encoder(ckpt_path: str, config: Dict) -> Dict[str, torch.Tensor]:
    """The encoder parameters of a SER trainers' checkpoint, by the names
    of ``WavLMModel``'s state dict, read on the CPU in float32."""
    from nrse_tpu_torch.models.emotion import EmotionClassifier
    from nrse_tpu_torch.train.categorical_emotions import (
        NUM_EMOTIONS,
        encoder_config_from,
    )
    from nrse_tpu_torch.train.checkpoint import restore_checkpoint
    from nrse_tpu_torch.train.emotion_trainer import create_emotion_state

    em = config["emotion"]
    model = EmotionClassifier(
        encoder_config_from(config), hidden_dim=em.get("hidden_dim", 1024),
        dropout=em.get("dropout_rate", 0.3), num_emotions=NUM_EMOTIONS,
        device="meta").to_empty(device="cpu")
    state = create_emotion_state(model)
    restore_checkpoint(*os.path.split(os.path.abspath(ckpt_path)), state)
    return {k: p.detach().clone()
            for k, p in state.model.encoder.named_parameters()}


def same_encoder(ckpt_path: str, byol_best: str, config: Dict) -> bool:
    """Whether the encoder of a SER checkpoint equals the online encoder
    of a BYOL checkpoint, every parameter bit for bit."""
    from nrse_tpu_torch.train.categorical_emotions import encoder_config_from
    from nrse_tpu_torch.train.checkpoint import load_byol_encoder

    got = ser_encoder(ckpt_path, config)
    want = load_byol_encoder(byol_best, encoder_config_from(config))
    return got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want)
