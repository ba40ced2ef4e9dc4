"""YAML config loading with CLI overrides.

Port of ``nrse_tpu/config/config_utils.py:26-190`` (API parity with the
reference's ``config/config_utils.py:6,21,39``): :func:`load_config`
reads a YAML file, or a preset of the port's own copies in
``nrse_tpu_torch/config/presets/`` by name, into a nested dict;
:func:`parse_args` has the same fixed override surface (``--config``,
``--device``, ``--batch_size``, ``--epochs``, ``--lr``, ``--task``,
``--resume``); :func:`validate_config` fills the JAX loader's defaults
and accepts both spellings of the validation split (the upstream
``validataion_dataset_split`` and ``validation_dataset_split``);
:func:`get_config` combines them.

Differences from the JAX loader: ``device`` defaults to ``cuda`` (no
probe; an entry point raises when there is no card,
``runtime.device.resolve_device``), and the ``tpu:`` block of the presets
is read and ignored, as every key in it chooses a TPU code path the port
does not have.  PyYAML is imported when a file is read.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

PRESET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "presets")


def preset_path(name: str) -> str:
    """The YAML path of a preset name (e.g. ``dev_wavlm-large_byol``)."""
    if not name.endswith(".yaml"):
        name = name + ".yaml"
    return os.path.join(PRESET_DIR, name)


def load_config(config_path: str) -> Dict[str, Any]:
    """A YAML config file, or a preset of :data:`PRESET_DIR` by name."""
    import yaml

    if not os.path.exists(config_path):
        candidate = preset_path(os.path.basename(config_path))
        if os.path.exists(candidate):
            config_path = candidate
    with open(config_path) as f:
        return yaml.safe_load(f)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="nrse_tpu_torch: noise-robust speech embeddings on one "
                    "GPU")
    parser.add_argument("--config", required=True,
                        help="YAML config file, or a preset name of "
                             "nrse_tpu_torch/config/presets")
    parser.add_argument("--device", default=None, help="cuda or cpu")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="batch size for training")
    parser.add_argument("--epochs", type=int, default=None,
                        help="number of training epochs")
    parser.add_argument("--lr", type=float, default=None,
                        help="learning rate")
    parser.add_argument("--task", default="both",
                        choices=["categorical", "dimensional", "both"],
                        help="which emotion recognition task to train")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "checkpoint_dir")
    return parser.parse_args(argv)


def validate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill the JAX loader's defaults in place (``config_utils.py:
    104-164``) and return ``config``; ``device`` defaults to ``cuda``."""
    config.setdefault("model", {})
    config["model"].setdefault("name", "microsoft/wavlm-large")
    config["model"].setdefault("projection_dim", 1024)
    config["model"].setdefault("prediction_dim", 2048)
    config["model"].setdefault("ema_decay", 0.997)

    tr = config.setdefault("training", {})
    tr.setdefault("batch_size", 36)
    tr.setdefault("num_workers", 8)
    tr.setdefault("num_epochs", 100)
    tr.setdefault("learning_rate", 1.0e-5)
    tr.setdefault("weight_decay", 1.0e-5)
    tr.setdefault("seed", 42)
    tr.setdefault("checkpoint_dir", "checkpoints/byol/default")
    tr.setdefault("log_dir", "outputs/byol/default")
    tr.setdefault("early_stopping_metric", "val_loss")
    tr.setdefault("early_stopping_patience", 5)
    tr.setdefault("early_stopping_min_delta", 0.0)

    d = config.setdefault("data", {})
    d.setdefault("sample_rate", 16000)
    d.setdefault("max_audio_length", 5.0)
    d.setdefault("snr_range", [0, 5, 10, 15, 20])
    d.setdefault("validation_ratio", 0.15)

    lg = config.setdefault("logging", {})
    lg.setdefault("wandb_mode", "disabled")
    lg.setdefault("level", "INFO")
    lg.setdefault("console_level", "ERROR")
    lg.setdefault("metric_logging_interval", 4)
    lg.setdefault("visualization_interval", 2)

    if "emotion" in config:
        em = config["emotion"]
        if "validation_dataset_split" in em \
                and "validataion_dataset_split" not in em:
            em["validataion_dataset_split"] = em["validation_dataset_split"]
        if "validataion_dataset_split" in em:
            em.setdefault("validation_dataset_split",
                          em["validataion_dataset_split"])
        em.setdefault("hidden_dim", 1024)
        em.setdefault("batch_size", tr["batch_size"])
        em.setdefault("dropout_rate", 0.3)
        em.setdefault("categorical_only", True)
        em.setdefault("use_class_weights", True)
        em.setdefault("add_noise_during_training", False)
        em.setdefault("unfreeze_encoder", False)

    config.setdefault("device", "cuda")
    return config


def get_config(argv=None) -> Dict[str, Any]:
    """The YAML config with the command line's overrides on top
    (reference ``config_utils.py:39``)."""
    args = parse_args(argv)
    config = load_config(args.config)
    if args.device is not None:
        config["device"] = args.device
    tr = config.setdefault("training", {})
    if args.batch_size is not None:
        tr["batch_size"] = args.batch_size
    if args.epochs is not None:
        tr["num_epochs"] = args.epochs
    if args.lr is not None:
        tr["learning_rate"] = args.lr
    config["task"] = args.task
    config["resume"] = bool(args.resume)
    return validate_config(config)
