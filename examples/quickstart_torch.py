"""Quickstart on the port: the whole nrse workflow on a mock corpus.

Counterpart of ``examples/quickstart.py``, on ``nrse_tpu_torch``'s entry
points: corpus validation (``utils.preprocess_audio_files``), BYOL
pretraining (``train_byol.main``), categorical SER training from the BYOL
encoder (``train_emotion.main --task categorical``) and the clean-vs-noisy
evaluation (``evaluate_emotion.main``).  The labels CSV is written with
the ``csv`` module.

    python3 examples/quickstart_torch.py [workdir] [--device cuda|cpu] \\
        [--model wavlm-tiny|microsoft/wavlm-large]

Runs on the card unless ``--device cpu`` is given; ``wavlm-tiny`` (the
default) is small enough for the CPU.  The work directory defaults to
``build/quickstart`` of this checkout.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _write_yaml(config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config, f)


def main(workdir: str = os.path.join(ROOT, "build", "quickstart"),
         device: str = "cuda", model: str = "wavlm-tiny") -> dict:
    """Runs the four steps in ``workdir``; returns ``{"byol": train_byol's
    epoch records, "emotion": the trainer's best macro-F1,
    "emotion_epochs": its epoch records, "report": the evaluation's
    {"clean", "noisy"} metrics}``."""
    from nrse_tpu_torch import evaluate_emotion, train_byol, train_emotion
    from nrse_tpu_torch.audio.io import save_wav
    from nrse_tpu_torch.data.mock import create_mock_corpus
    from nrse_tpu_torch.utils.preprocess_audio_files import (
        preprocess_audio_files,
    )
    from nrse_tpu_torch.utils.report_utils import free_card

    os.makedirs(workdir, exist_ok=True)
    here = os.getcwd()
    os.chdir(workdir)
    try:
        # 1. a synthetic corpus (standing in for the Demucs-cleaned speech
        #    and AudioSet noise corpora) and its validation
        clean_dir, noise_dir = create_mock_corpus("corpus", n_clean=12,
                                                  n_noise=4)
        good, bad = preprocess_audio_files(clean_dir)
        print(f"[1] corpus: {len(good)} healthy files, {len(bad)} flagged",
              flush=True)

        # 2. BYOL pretraining
        cfg = {
            "model": {"name": model, "projection_dim": 32,
                      "prediction_dim": 64, "ema_decay": 0.99},
            "training": {"batch_size": 8, "num_workers": 2, "num_epochs": 2,
                         "learning_rate": 1e-3, "weight_decay": 1e-5,
                         "checkpoint_dir": "ckpts/byol", "log_dir": "logs",
                         "seed": 42, "early_stopping_metric": "val_loss",
                         "early_stopping_patience": 5,
                         "early_stopping_min_delta": 0.0},
            "data": {"clean_data_path": clean_dir,
                     "noise_data_path": noise_dir,
                     "sample_rate": 16000, "max_audio_length": 1.0,
                     "snr_range": [0, 5, 10], "validation_ratio": 0.34},
            "logging": {"wandb_mode": "disabled", "level": "ERROR",
                        "console_level": "ERROR",
                        "visualization_interval": 2},
            "tpu": {"mesh": {"data": -1, "model": 1}, "prefetch_depth": 0},
            "device": device,
        }
        print("[2] BYOL pretraining...", flush=True)
        byol = train_byol.main(cfg)["epochs"]
        free_card()

        # 3. SER training on a mock MSP-Podcast layout, from the BYOL
        #    encoder
        rng = np.random.default_rng(0)
        os.makedirs("msp/Audios", exist_ok=True)
        fields = ["FileName", "EmoClass", "EmoAct", "EmoVal", "EmoDom",
                  "Split_Set", "SpkrID", "Gender"]
        rows = []
        for i in range(14):
            name = f"MSP-PODCAST_{1000 + i}_{i:04d}.wav"
            t = np.arange(int(16000 * rng.uniform(0.5, 1.0))) / 16000
            x = 0.4 * np.sin(2 * np.pi * rng.uniform(90, 350) * t)
            save_wav(f"msp/Audios/{name}", x.astype(np.float32), 16000)
            rows.append({"FileName": name,
                         "EmoClass": ["A", "H", "S", "N"][i % 4],
                         "EmoAct": rng.uniform(1, 7),
                         "EmoVal": rng.uniform(1, 7),
                         "EmoDom": rng.uniform(1, 7),
                         "Split_Set": "Development" if i < 10 else "Test1",
                         "SpkrID": i, "Gender": "Male"})
        with open("msp/labels_consensus.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            writer.writerows(rows)

        cfg["emotion"] = {
            "labels_file": "msp/labels_consensus.csv",
            "audio_dir": "msp/Audios",
            "encoder_checkpoint": "ckpts/byol/best_val_loss",
            "checkpoint_dir": "ckpts/emotion",
            "train_dataset_split": "Development",
            "validataion_dataset_split": "Test1",
            "hidden_dim": 32, "batch_size": 4, "learning_rate": 1e-3,
            "fine_tuning_lr": 1e-4, "scheduler_patience": 2,
            "weight_decay": 1e-4, "dropout_rate": 0.1,
            "classifier_epochs": 1, "fine_tuning_epochs": 1, "patience": 5,
            "unfreeze_encoder": False, "add_noise_during_training": True,
            "use_class_weights": True, "categorical_only": True,
        }
        _write_yaml(cfg, "emotion.yaml")
        print("[3] SER training (categorical)...", flush=True)
        emotion = train_emotion.main(["--config", "emotion.yaml", "--device",
                                      device, "--task", "categorical"])
        best_f1 = emotion["categorical"]["best_f1"]
        emotion_epochs = emotion["categorical"]["epochs"]
        del emotion
        free_card()

        # 4. the clean-vs-noisy robustness report
        print("[4] robustness evaluation...", flush=True)
        report = evaluate_emotion.main([
            "--config", "emotion.yaml",
            "--checkpoint", "ckpts/emotion/best_classifier_model",
            "--device", device])
        free_card()
        print("\nQuickstart complete; artifacts in", workdir, flush=True)
        return {"byol": byol, "emotion": best_f1,
                "emotion_epochs": emotion_epochs, "report": report}
    finally:
        os.chdir(here)


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?",
                   default=os.path.join(ROOT, "build", "quickstart"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--model", default="wavlm-tiny",
                   help="wavlm-tiny or microsoft/wavlm-large")
    args = p.parse_args(argv)
    main(os.path.abspath(args.workdir), args.device, args.model)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
