"""The port's entry points over 2 gloo ranks on the CPU.

``train_byol.main`` (WavLM tiny, 2 layers, projection 16, prediction 32,
global batch 4 = 2 × 2, two epochs, early-stopping patience 1) and then
``train_emotion.run`` (``--task both``: each trainer one frozen epoch and
one fine-tuning epoch, global batch 4) in each rank of one group, over a
tiny corpus of ``data/synthetic.py``: 12 clean and 2 noise clips of ~0.5
s cropped to 0.3 s for BYOL, 8 + 4 labelled clips cropped to 0.48 s for
the SER trainers.  Both ranks report the same pooled losses and metrics
and the same stop decision; only rank 0 writes checkpoints; the BYOL
replicas end bit-equal.  ``dryrun_multiprocess(2)`` passes.
"""

import numpy as np
import pytest
import torch

from nrse_tpu_torch.data.synthetic import (
    generate_corpus,
    generate_emotion_corpus,
)
from nrse_tpu_torch.parallel.dryrun import dryrun_multiprocess
from nrse_tpu_torch.parallel.launch import run_ranks

import torch_dp_workers as workers

torch.set_num_threads(1)


def _configs(root):
    clean, noise = generate_corpus(str(root / "byol"), 12, 2, seconds=0.5,
                                   verbose=False)
    audio, labels = generate_emotion_corpus(str(root / "msp"), 8, 4,
                                            seconds=0.5, verbose=False)
    quiet = {"wandb_mode": "disabled", "level": "ERROR",
             "console_level": "ERROR", "visualization_interval": 1}
    byol = {
        "model": {"name": "tiny", "projection_dim": 16, "prediction_dim": 32,
                  "ema_decay": 0.99},
        "training": {"batch_size": 4, "num_workers": 2, "num_epochs": 2,
                     "learning_rate": 1e-4, "weight_decay": 1e-5,
                     "seed": 3, "early_stopping_patience": 1,
                     "checkpoint_dir": str(root / "byol_ckpt"),
                     "log_dir": str(root / "byol_logs")},
        "data": {"clean_data_path": clean, "noise_data_path": noise,
                 "sample_rate": 16000, "max_audio_length": 0.3,
                 "snr_range": [0, 10, 20], "validation_ratio": 0.25},
        "logging": quiet, "device": "cpu"}
    emotion = {
        "model": {"name": "wavlm-tiny"},
        "training": {"num_workers": 2, "seed": 42,
                     "log_dir": str(root / "emotion_logs")},
        "data": {"noise_data_path": noise, "sample_rate": 16000,
                 "max_audio_length": 0.48, "snr_range": [5, 10]},
        "logging": quiet, "device": "cpu", "task": "both",
        "emotion": {
            "labels_file": labels, "audio_dir": audio,
            "encoder_checkpoint": None,
            "checkpoint_dir": str(root / "emotion_ckpt"),
            "train_dataset_split": "Train",
            "validataion_dataset_split": "Development",
            "hidden_dim": 32, "batch_size": 4, "learning_rate": 1e-3,
            "fine_tuning_lr": 1e-4, "scheduler_patience": 2,
            "weight_decay": 1e-4, "dropout_rate": 0.1,
            "classifier_epochs": 1, "fine_tuning_epochs": 1,
            "patience": 5, "unfreeze_encoder": True,
            "add_noise_during_training": True, "use_class_weights": True,
            "categorical_only": True}}
    return byol, emotion


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    byol, emotion = _configs(tmp_path_factory.mktemp("dp_entry"))
    return run_ranks(workers.entry_points, 2, (byol, emotion))


def test_ranks_report_the_same_pooled_metrics(ranks):
    a, b = ranks
    assert a["pid"] != b["pid"]
    assert a["byol"] == b["byol"] and len(a["byol"]) >= 1
    assert a["byol_stopped"] == b["byol_stopped"]
    for epoch in a["byol"]:
        assert np.isfinite(epoch["train_loss"]) and epoch["steps"] == 2
        assert np.isfinite(epoch["val_loss"])
    assert a["emotion"] == b["emotion"]
    assert set(a["emotion"]) == {"categorical", "dimensional"}
    for records in a["emotion"].values():
        assert [r["phase"] for r in records] == ["classifier", "fine_tune"]
        for r in records:
            assert np.isfinite(r["train_loss"]) and r["steps"] == 2
            assert np.isfinite(r["metric"])


def test_only_rank_zero_writes_checkpoints(ranks):
    a, b = ranks
    assert "last_model" in a["byol_saves"] and b["byol_saves"] == []
    assert "best_classifier_model" in a["emotion_saves"]
    assert b["emotion_saves"] == []


def test_byol_replicas_end_bit_equal(ranks):
    a, b = (r["byol_flat"] for r in ranks)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_dryrun_multiprocess():
    report = dryrun_multiprocess(2)
    assert report["finite"] and report["agree"]
