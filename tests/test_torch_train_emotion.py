"""The port's SER entry points on the CPU: ``python -m
nrse_tpu_torch.train_emotion`` and ``python -m
nrse_tpu_torch.evaluate_emotion``.

  1. ``train_emotion.main --task both --device cpu`` on ``conftest.py``'s
     mock MSP-Podcast corpus (the tiny encoder at 0.48 s: 383 frames, the
     block path's plain versions), noise on, one frozen epoch then two of
     gradual unfreezing: each trainer writes ``best_classifier_model`` and
     ``best_fine_tuned_model`` under its own subdirectory; the epochs open
     layers ``[]``, ``[1]``, ``[0, 1]``; the encoder's non-layer
     parameters never move (bit for bit), layer 0 and the heads have moved
     by the end; the Adam count goes on across the phases; the
     confusion-matrix and scatter plots are drawn.
  2. ``evaluate_emotion.main`` on each trainer's best checkpoint: a finite
     clean and noisy report in ``--out-json``.
  3. The encoder from a BYOL checkpoint directory of the port's
     ``train_byol``; a reference ``.pt`` path raises; a preset resolves by
     name; without ``--device`` the entry points ask for the card and raise
     where there is none.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from nrse_tpu_torch import evaluate_emotion, train_emotion
from nrse_tpu_torch.config.config_utils import get_config
from nrse_tpu_torch.models.convert import init_byol_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train.byol_trainer import create_train_state
from nrse_tpu_torch.train.categorical_emotions import build_classifier
from nrse_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emo_config(mock_msp_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("train_emotion")
    return {
        "model": {"name": "wavlm-tiny"},
        "training": {"num_workers": 2, "seed": 42,
                     "log_dir": str(root / "logs")},
        "data": {"noise_data_path": str(mock_msp_dir / "noise"),
                 "sample_rate": 16000, "max_audio_length": 0.48,
                 "snr_range": [5, 10]},
        "logging": {"wandb_mode": "disabled", "level": "ERROR",
                    "console_level": "ERROR"},
        "emotion": {
            "labels_file": str(mock_msp_dir / "labels_consensus.csv"),
            "audio_dir": str(mock_msp_dir / "Audios"),
            "encoder_checkpoint": None,
            "checkpoint_dir": str(root / "ckpt"),
            "train_dataset_split": "Development",
            "validataion_dataset_split": "Test1",
            "hidden_dim": 32, "batch_size": 4, "learning_rate": 1e-3,
            "fine_tuning_lr": 1e-4, "scheduler_patience": 2,
            "weight_decay": 1e-4, "dropout_rate": 0.1,
            "classifier_epochs": 1, "fine_tuning_epochs": 2, "patience": 5,
            "unfreeze_encoder": True, "add_noise_during_training": True,
            "use_class_weights": True, "categorical_only": True,
        },
    }


@pytest.fixture(scope="module")
def trained(emo_config, tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "emotion.yaml"
    path.write_text(yaml.safe_dump(emo_config))
    initial = build_classifier(copy.deepcopy(emo_config),
                               torch.device("cpu"), 42,
                               pretrained_encoder=False).state_dict()
    results = train_emotion.main(["--config", str(path), "--task", "both",
                                  "--device", "cpu"])
    return str(path), initial, results


def test_main_trains_both_tasks_in_two_phases(emo_config, trained):
    _, initial, results = trained
    assert set(results) == {"categorical", "dimensional"}
    ckpt = emo_config["emotion"]["checkpoint_dir"]
    for task, result in results.items():
        metric = "f1" if task == "categorical" else "ccc"
        assert np.isfinite(result[f"best_{metric}"])
        epochs = result["epochs"]
        assert [(e["phase"], e["layers"]) for e in epochs] == [
            ("classifier", []), ("fine_tune", [1]), ("fine_tune", [0, 1])]
        assert all(np.isfinite(e["train_loss"]) and e["steps"] == 1
                   for e in epochs)
        for name in ("best_classifier_model", "best_fine_tuned_model"):
            meta = os.path.join(ckpt, task, name, "meta.json")
            with open(meta) as f:
                assert metric in json.load(f)
        state = result["state"]
        assert state.step == 3  # the Adam count goes on across the phases
        params = dict(state.model.named_parameters())
        for name, p in params.items():
            start = initial[name]
            if name.startswith("encoder.") and ".layers." not in name:
                assert torch.equal(p.detach(), start), name
            if name.startswith("encoder.encoder.layers.0.") \
                    and "rel_attn_embed" not in name:
                assert not torch.equal(p.detach(), start), name
        assert not torch.equal(params["categorical_out.weight"].detach(),
                               initial["categorical_out.weight"])
    logs = emo_config["training"]["log_dir"]
    for plot in ("val_confusion_matrix.png", "val_scatter_arousal.png"):
        assert os.path.exists(os.path.join(logs, plot))


@pytest.mark.parametrize("task", ["categorical", "dimensional"])
def test_evaluate_reports_clean_and_noisy(emo_config, trained, tmp_path,
                                          task):
    path, _, _ = trained
    ckpt = os.path.join(emo_config["emotion"]["checkpoint_dir"], task,
                        "best_fine_tuned_model")
    out = tmp_path / "report.json"
    report = evaluate_emotion.main(["--config", path, "--checkpoint", ckpt,
                                    "--task", task, "--device", "cpu",
                                    "--out-json", str(out)])
    assert json.loads(out.read_text()) == report
    keys = {"accuracy", "macro_f1"} if task == "categorical" else \
        {"ccc_arousal", "ccc_valence", "ccc_dominance"}
    for cond in ("clean", "noisy"):
        assert set(report[cond]) == keys
        assert all(np.isfinite(v) for v in report[cond].values())


def test_encoder_from_a_byol_checkpoint(emo_config, tmp_path):
    cfg = WavLMConfig.tiny()
    sd = init_byol_state_dict(cfg, 16, 32, torch.Generator().manual_seed(9))
    state = create_train_state(cfg, sd, 16, 32, "cpu")
    save_checkpoint(str(tmp_path), "best_val_similarity", state)
    config = copy.deepcopy(emo_config)
    config["emotion"]["encoder_checkpoint"] = str(
        tmp_path / "best_val_similarity")
    model = build_classifier(config, torch.device("cpu"), 0)
    for name, p in state.online.encoder.named_parameters():
        assert torch.equal(model.encoder.get_parameter(name), p), name
    config["emotion"]["encoder_checkpoint"] = str(tmp_path / "byol.pt")
    with pytest.raises(NotImplementedError, match="Queue 1, item 3"):
        build_classifier(config, torch.device("cpu"), 0)


def test_preset_resolves_and_the_card_is_the_default(emo_config, tmp_path):
    config = get_config(["--config", "default_wavlm-large_emotion_dim_ft",
                         "--task", "both"])
    assert config["device"] == "cuda" and config["task"] == "both"
    assert config["emotion"]["unfreeze_encoder"] is True
    assert config["data"]["max_audio_length"] == 5.0
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    path = tmp_path / "emotion.yaml"
    path.write_text(yaml.safe_dump(emo_config))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_emotion.main(["--config", str(path), "--task", "categorical"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_emotion.main(["--config", str(path), "--checkpoint",
                               str(tmp_path / "missing")])
