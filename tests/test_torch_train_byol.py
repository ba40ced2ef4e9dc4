"""The port's BYOL entry point (``nrse_tpu_torch.train_byol``) on a tiny
corpus on the CPU: two epochs write the three checkpoints; ``--resume``
restores ``last_model`` bit for bit (flat buffers, Adam moments, the
target, both towers' BatchNorm statistics, step and seed), continues at
epoch 2 with the step carried over and keeps ``best`` from ``meta.json``.

WavLM tiny, projection 16, prediction 32; eight 0.5 s clean clips and two
noise clips, cropped to 0.3 s (239 frames, inside the block attention's
384), batch 2, a quarter held out for validation.
"""

import json
import os

import numpy as np
import pytest
import torch

from nrse_tpu.audio.io import save_wav
from nrse_tpu.config.config_utils import preset_path
from nrse_tpu_torch import train_byol
from nrse_tpu_torch.baseline import eval_cat_ser
from nrse_tpu_torch.data.loader import create_dataloaders
from nrse_tpu_torch.eval.evaluate_byol import (
    evaluate_embedding_similarity,
    validate_model,
)
from nrse_tpu_torch.models.convert import init_byol_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.runtime.device import resolve_device
from nrse_tpu_torch.train.byol_trainer import create_train_state
from nrse_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    state_tensors,
)
from torch_init import with_random_biases

torch.set_num_threads(1)

SR = 16000
NAMES = ("best_val_loss", "best_val_similarity", "last_model")
PROJ, PRED, SEED = 16, 32, 3


def _corpus(root):
    rng = np.random.default_rng(0)
    clean, noise = root / "clean", root / "noise"
    clean.mkdir()
    noise.mkdir()
    ax = np.arange(SR // 2) / SR
    for i in range(8):
        wave = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 2000) * ax)
        save_wav(str(clean / f"c{i}.wav"),
                 (wave + 0.01 * rng.standard_normal(ax.size)
                  ).astype(np.float32), SR)
    for i in range(2):
        save_wav(str(noise / f"n{i}.wav"),
                 (0.3 * rng.standard_normal(SR // 2)).astype(np.float32), SR)
    return clean, noise


def _config(root, clean, noise, epochs, resume=False):
    return {
        "model": {"name": "tiny", "projection_dim": PROJ,
                  "prediction_dim": PRED, "ema_decay": 0.99},
        "training": {"batch_size": 2, "num_workers": 2,
                     "num_epochs": epochs, "learning_rate": 1e-4,
                     "weight_decay": 1e-5, "seed": SEED,
                     "checkpoint_dir": str(root / "ckpt"),
                     "log_dir": str(root / "logs")},
        "data": {"clean_data_path": str(clean),
                 "noise_data_path": str(noise), "sample_rate": SR,
                 "max_audio_length": 0.3, "snr_range": [0, 10, 20],
                 "validation_ratio": 0.25},
        "logging": {"visualization_interval": 1},
        "device": "cpu",
        "resume": resume,
    }


def _flat(state):
    return {k: v.clone() for k, v in state_tensors(state).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("byol")
    clean, noise = _corpus(root)
    first = train_byol.main(_config(root, clean, noise, 2))
    saved = _flat(first["state"])
    ckpt = root / "ckpt"
    metas = {n: json.loads((ckpt / n / "meta.json").read_text())
             for n in NAMES}
    restored = _restore(ckpt)
    second = train_byol.main(_config(root, clean, noise, 3, resume=True))
    return root, first, saved, metas, restored, second


def _restore(ckpt):
    """``last_model`` restored into a state made from other weights."""
    cfg = WavLMConfig.tiny()
    fresh = create_train_state(
        cfg, with_random_biases(init_byol_state_dict(
            cfg, PROJ, PRED, torch.Generator().manual_seed(99)), 99),
        PROJ, PRED, "cpu", seed=0)
    return restore_checkpoint(str(ckpt), "last_model", fresh)


def test_two_epochs_write_three_checkpoints(runs):
    root, first, _, metas, _, _ = runs
    assert [e["epoch"] for e in first["epochs"]] == [0, 1]
    assert all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"])
               for e in first["epochs"])
    assert first["epochs"][0]["steps"] == 3  # 6 training clips, batch 2
    assert first["state"].step == 6
    for name in NAMES:
        assert (root / "ckpt" / name / "state.pt").is_file()
        assert set(metas[name]) == {"epoch", "loss", "similarity", "best"}
    assert metas["last_model"]["epoch"] == 1
    assert first["decoder"] in ("native", "python")


def test_resume_restores_last_model_bit_for_bit(runs):
    _, _, saved, _, (fresh, meta), _ = runs
    got = _flat(fresh)
    assert got.keys() == saved.keys()
    assert any("running_var" in k for k in got)
    for k, want in saved.items():
        assert torch.equal(got[k], want), k
    assert (fresh.step, fresh.seed) == (6, SEED)
    assert meta["epoch"] == 1
    # the modules' parameters are still views of the restored buffer
    p = next(fresh.online.parameters())
    assert torch.equal(p.detach().reshape(-1), got["params"][:p.numel()])
    assert p.data_ptr() == fresh.params.data_ptr()


def test_resume_continues_at_epoch_two_and_keeps_best(runs):
    root, _, _, metas, _, second = runs
    assert [e["epoch"] for e in second["epochs"]] == [2]
    assert second["state"].step == 9
    assert latest_checkpoint(str(root / "ckpt")) == "last_model"
    meta = json.loads((root / "ckpt" / "last_model" / "meta.json")
                      .read_text())
    val = second["epochs"][0]
    assert meta["epoch"] == 2
    assert meta["best"]["val_loss"] == min(metas["last_model"]["best"]
                                           ["val_loss"], val["val_loss"])
    assert meta["best"]["val_similarity"] == max(
        metas["last_model"]["best"]["val_similarity"],
        val["val_avg_similarity"])


def test_validation_similarities_agree(runs):
    """``validate_model``'s per-SNR similarities are
    ``evaluate_embedding_similarity``'s over the same items, for the SNRs
    that have rows; its loss is the resumed run's last validation loss.
    (A loader draws other noise and SNRs on each pass, so each call gets
    a fresh one.)"""
    root, _, _, _, _, second = runs
    config = train_byol.with_defaults(
        _config(root, root / "clean", root / "noise", 3))
    state = second["state"]
    loss, metrics = validate_model(state, create_dataloaders(config)[1],
                                   config)
    sims = evaluate_embedding_similarity(
        state, create_dataloaders(config)[1], config)
    assert loss == second["epochs"][-1]["val_loss"]
    assert metrics["val_similarities"]
    for snr, sim in metrics["val_similarities"].items():
        assert sim == sims[snr]
    assert all(sims[s] == 0.0 for s in config["data"]["snr_range"]
               if s not in metrics["val_similarities"])


def test_load_config_reads_the_jax_presets():
    config = train_byol.with_defaults(
        train_byol.load_config("dev_wavlm-large_byol"))
    assert config["model"]["name"] == "microsoft/wavlm-large"
    assert config["training"]["batch_size"] == 4
    assert config["device"] == "cuda"
    assert WavLMConfig.from_model_name(config["model"]["name"]) == \
        WavLMConfig.large()
    # the name resolves to the port's own copy of the JAX preset
    assert os.path.dirname(train_byol.PRESET_DIR) == os.path.join(
        os.path.dirname(os.path.abspath(train_byol.__file__)), "config")


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(train_byol.PRESET_DIR) if f.endswith(".yaml")))
def test_port_presets_equal_the_jax_presets(name):
    # the port's copies may not drift from the reference's hyper-parameters
    assert train_byol.load_config(os.path.join(train_byol.PRESET_DIR, name)) \
        == train_byol.load_config(preset_path(name))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for name in ("cuda", "gpu", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(name)
    # the evaluator resolves its device before it reads anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cat_ser.run_inference("unused", "unused", "unused",
                                   device="cuda")
    assert resolve_device("CPU") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")
