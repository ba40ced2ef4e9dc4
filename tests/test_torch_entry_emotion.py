"""The port's SER trainers against JAX's, over whole epochs.

``nrse_tpu_torch.train_emotion.main`` against the root
``train_emotion.py``'s ``main``, ``--task categorical`` and ``--task
dimensional``, on the CPU: the layout of ``conftest.py``'s mock
MSP-Podcast corpus (made here from its own seed: 6 training clips of the
8 classes' rows, 5 held out, 2 noise files), noise on, WavLM tiny in
float32 on both sides, every dropout, LayerDrop and SpecAugment off
(each package's ``WavLMConfig.from_model_name`` patched; the trunks'
``dropout_rate`` 0), batch 2, two frozen epochs, then two of gradual
unfreezing (layer 1, then layers 0 and 1).

Both start from one BYOL checkpoint: JAX's (``create_train_state`` of a
tiny ``BYOLSpeechModel``, saved by ``nrse_tpu.train.checkpoint``),
converted for the port by ``tools/orbax_to_torch.py``'s ``convert``.  The
heads come from JAX's init (``emotion_trainer.py:56``): each trainer's
``create_emotion_state`` is wrapped to keep what it made, and the port's
``init_emotion_state_dict`` patched to return it, converted.  AdamW's eps
is 1e-3 on both sides (each package's optimizer patched, as in
``tests/test_torch_entry_byol.py``).

Held to JAX, per epoch: the train and validation losses, the macro-F1
(categorical) or each dimension's CCC and their mean (dimensional), the
learning rate ReduceLROnPlateau set, the layers open; the checkpoints
written with their ``epoch``, ``phase`` and metric.  JAX's datasets
list the noise sorted, as the port's do (``torch_entry.sorted_listing``;
the two files' names sort as ``os.walk`` gave them where the bounds were
measured).  The bounds are
twice JAX's own spread on the same runs, measured four ways by
``tools/entry_spread.py emotion`` (as ``tests/test_torch_entry_byol.py``
says).
"""

import functools
import glob
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml

import train_emotion as jax_train_emotion
from nrse_tpu.audio.io import save_wav
from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.train import categorical_emotions as jax_categorical
from nrse_tpu.train import dimentional_emotions as jax_dimensional
from nrse_tpu.train.byol_trainer import create_train_state as jax_byol_state
from nrse_tpu.train.checkpoint import save_checkpoint as jax_save
from nrse_tpu.train.schedules import make_byol_optimizer
from nrse_tpu_torch import train_emotion
from nrse_tpu_torch.models.convert import emotion_params_to_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train import categorical_emotions
from nrse_tpu_torch.train import emotion_trainer
from torch_entry import EPS, QUIET, checkpoints, quiet_names, sorted_listing

torch.set_num_threads(1)

SR = 16000
TASKS = ("categorical", "dimensional")
JAX_TRAINERS = {"categorical": jax_categorical,
                "dimensional": jax_dimensional}
METRIC = {"categorical": "f1", "dimensional": "ccc"}
# twice JAX's own spread on these runs (tools/entry_spread.py emotion: the
# largest |Δ| of the four ways over both tasks' four epochs, rounded up at
# three digits; the macro-F1 did not move, the CCCs did)
BOUNDS = {"train_loss": 2 * 7.16e-7, "val_loss": 2 * 7.95e-7,
          "metric": 2 * 5.09e-8}

_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch",
    Path(__file__).resolve().parent.parent / "tools" / "orbax_to_torch.py")
orbax_to_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_torch)


def jax_emotion_optimizer(learning_rate, weight_decay=1e-4, clip_norm=1.0):
    """``nrse_tpu.train.schedules.make_emotion_optimizer`` at Adam's eps
    ``EPS``."""
    return optax.chain(optax.clip_by_global_norm(clip_norm),
                       optax.inject_hyperparams(optax.adamw)(
                           learning_rate=learning_rate,
                           weight_decay=weight_decay, eps=EPS))


def corpus(root):
    """``conftest.py::mock_msp_dir``'s layout from its own seed, and a
    JAX BYOL checkpoint with its conversion: ``(msp dir, JAX checkpoint,
    port checkpoint)``."""
    rng = np.random.default_rng(42)
    d = Path(root) / "msp"
    audio, noise = d / "Audios", d / "noise"
    audio.mkdir(parents=True)
    noise.mkdir()
    rows = []
    classes = ["A", "H", "S", "N", "N", "H", "X", "N"]
    for i, c in enumerate(classes):
        name = f"MSP-PODCAST_{1000 + i}_{i:04d}.wav"
        t = np.arange(int(SR * rng.uniform(0.4, 1.4))) / SR
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(90, 350) * t)
        x += 0.05 * rng.standard_normal(t.shape)
        save_wav(str(audio / name), x.astype(np.float32), SR)
        rows.append({"FileName": name, "EmoClass": c,
                     "EmoAct": rng.uniform(1, 7), "EmoVal": rng.uniform(1, 7),
                     "EmoDom": rng.uniform(1, 7),
                     "Split_Set": "Development" if i < 7 else "Test1",
                     "SpkrID": 100 + i,
                     "Gender": "Female" if i % 2 else "Male"})
    for i in range(8, 12):
        name = f"MSP-PODCAST_{1000 + i}_{i:04d}.wav"
        t = np.arange(int(SR * 0.8)) / SR
        x = 0.3 * np.sin(2 * np.pi * 200 * t) \
            + 0.05 * rng.standard_normal(t.shape)
        save_wav(str(audio / name), x.astype(np.float32), SR)
        rows.append({"FileName": name, "EmoClass": ["A", "H", "S", "N"][i - 8],
                     "EmoAct": rng.uniform(1, 7), "EmoVal": rng.uniform(1, 7),
                     "EmoDom": rng.uniform(1, 7), "Split_Set": "Test1",
                     "SpkrID": 200, "Gender": "Male"})
    for i in range(2):
        save_wav(str(noise / f"noise_{i}.wav"),
                 (0.2 * rng.standard_normal(SR)).astype(np.float32), SR)
    pd.DataFrame(rows).to_csv(d / "labels_consensus.csv", index=False)

    # the encoder the trainers build: without SpecAugment, so without
    # its masked_spec_embed
    model = BYOLSpeechModel({"model": {"projection_dim": 16,
                                       "prediction_dim": 32}},
                            encoder_config=JaxWavLMConfig.tiny(**QUIET))
    state = jax_byol_state(model, jax.random.PRNGKey(3), jnp.zeros((1, 7680)),
                           make_byol_optimizer(1e-4, total_steps=10))
    jax_ckpt = os.path.join(root, "byol_jax", "best_val_loss")
    jax_save(os.path.dirname(jax_ckpt), "best_val_loss", state, {"epoch": 0})
    port_ckpt = os.path.join(root, "byol_port", "best_val_loss")
    with pytest.MonkeyPatch.context() as m:
        quiet_names(m)
        orbax_to_torch.convert(jax_ckpt, port_ckpt, "wavlm-tiny", seed=0)
    return str(d), jax_ckpt, port_ckpt


def config(root, msp, ckpt, side, task):
    run = os.path.join(root, f"{side}_{task}")
    return {
        "model": {"name": "wavlm-tiny"},
        "training": {"num_workers": 2, "seed": 42,
                     "log_dir": os.path.join(run, "logs")},
        "data": {"noise_data_path": os.path.join(msp, "noise"),
                 "sample_rate": SR, "max_audio_length": 0.48,
                 "snr_range": [5, 10]},
        "logging": {"wandb_mode": "offline", "level": "ERROR",
                    "console_level": "ERROR"},
        "emotion": {
            "labels_file": os.path.join(msp, "labels_consensus.csv"),
            "audio_dir": os.path.join(msp, "Audios"),
            "encoder_checkpoint": ckpt,
            "checkpoint_dir": os.path.join(run, "ckpt"),
            "train_dataset_split": "Development",
            "validataion_dataset_split": "Test1",
            "hidden_dim": 32, "batch_size": 2, "learning_rate": 1e-3,
            "fine_tuning_lr": 1e-4, "scheduler_patience": 1,
            "weight_decay": 1e-4, "dropout_rate": 0.0,
            "classifier_epochs": 2, "fine_tuning_epochs": 2, "patience": 5,
            "unfreeze_encoder": True, "add_noise_during_training": True,
            "use_class_weights": True, "categorical_only": True},
        "tpu": {"compute_dtype": "float32", "mesh": {"data": 1, "model": 1}},
        "device": "cpu",
    }


def _write(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _np(tree):
    return jax.tree.map(np.array, tree)


def _records(log_dir, task):
    """A trainer's per-epoch records from its wandb stub (the stub of the
    JAX package or the port's copy), in the order logged."""
    records = []
    for stub in glob.glob(os.path.join(log_dir, "wandb_stub_*.jsonl")):
        with open(stub) as f:
            records += [r for r in map(json.loads, f)
                        if any(k.endswith("/val_loss") for k in r)]
    records.sort(key=lambda r: r["_t"])
    epochs = []
    for r in records:
        phase = next(k for k in r if k.endswith("/val_loss")).split("/")[0]
        rec = {"phase": phase, "epoch": r["epoch"],
               "train_loss": r[f"{phase}/train_loss"],
               "val_loss": r[f"{phase}/val_loss"], "lr": r[f"{phase}/lr"]}
        if task == "categorical":
            rec["metric"] = {"f1": r[f"{phase}/val_f1"]}
        else:
            rec["metric"] = {"ccc": r[f"{phase}/val_ccc"]} | {
                name: r[f"{phase}/ccc_{name}"]
                for name in ("arousal", "valence", "dominance")}
        epochs.append(rec)
    return epochs


def jax_run(root, msp, jax_ckpt, port_ckpt, nudge: float = 0.0,
            variant=None):
    """The root ``train_emotion.main`` on each task: ``{task: {"epochs":
    per-epoch records from the wandb stub, "checkpoints": {name: meta},
    "params": the initial params (numpy)}}``; ``nudge`` ±inf moves the
    first batch's waveforms one float32 ulp that way, ``variant`` sets
    JAX's encoder fields (``quiet_names``)."""
    out = {}
    side = f"jax{nudge:+}" + "".join(f"_{k}" for k in (variant or {}))
    for task in TASKS:
        cfg = config(root, msp, jax_ckpt, side, task)
        path = _write(cfg, os.path.join(root, f"{side}_{task}.yaml"))
        trainer = JAX_TRAINERS[task]
        made, layers = {}, []
        real_state = trainer.create_emotion_state
        real_step = trainer.make_emotion_train_step
        real_scale = trainer.layer_gradient_scale

        def create_emotion_state(*args, **kwargs):
            state = real_state(*args, **kwargs)
            made["params"] = _np(state.params)
            return state

        def make_emotion_train_step(*args, **kwargs):
            step, first = real_step(*args, **kwargs), [bool(nudge)]

            def run(state, batch, *rest):
                if first[0]:
                    first[0] = False
                    batch = dict(batch, input_values=jnp.nextafter(
                        batch["input_values"], jnp.float32(nudge)))
                return step(state, batch, *rest)
            return run

        def layer_gradient_scale(num_layers, open_layers):
            layers.append(list(open_layers))
            return real_scale(num_layers, open_layers)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(trainer, "create_emotion_state", create_emotion_state)
            m.setattr(trainer, "make_emotion_train_step",
                      make_emotion_train_step)
            m.setattr(trainer, "layer_gradient_scale", layer_gradient_scale)
            m.setattr(trainer, "make_emotion_optimizer",
                      jax_emotion_optimizer)
            quiet_names(m, variant)
            sorted_listing(m)
            jax_train_emotion.main(["--config", path, "--task", task])
        epochs = _records(cfg["training"]["log_dir"], task)
        # the first call is the frozen scale, then one a fine-tune epoch
        for rec, open_layers in zip(
                [e for e in epochs if e["phase"] == "fine_tune"],
                layers[1:]):
            rec["layers"] = open_layers
        for rec in epochs:
            rec.setdefault("layers", [])
        out[task] = {"epochs": epochs, "params": made["params"],
                     "checkpoints": checkpoints(
                         cfg["emotion"]["checkpoint_dir"])}
    return out


def port_run(root, msp, jax_ckpt, port_ckpt, ref):
    """``nrse_tpu_torch.train_emotion.main`` on each task from the
    converted checkpoint and JAX's initial heads: the same record as
    :func:`jax_run`."""
    out = {}
    for task in TASKS:
        cfg = config(root, msp, port_ckpt, "port", task)
        path = _write(cfg, os.path.join(root, f"port_{task}.yaml"))
        start = {k: torch.from_numpy(v) for k, v in
                 emotion_params_to_state_dict(ref[task]["params"],
                                              WavLMConfig.tiny()).items()}
        with pytest.MonkeyPatch.context() as m:
            m.setattr(categorical_emotions, "init_emotion_state_dict",
                      lambda *args, **kwargs: dict(start))
            m.setattr(emotion_trainer, "FusedAdamWSpec",
                      functools.partial(emotion_trainer.FusedAdamWSpec,
                                        eps=EPS))
            quiet_names(m)
            result = train_emotion.main(["--config", path, "--task", task,
                                         "--device", "cpu"])[task]
        epochs = _records(cfg["training"]["log_dir"], task)
        assert len(epochs) == len(result["epochs"])
        for rec, e in zip(epochs, result["epochs"]):
            assert (rec["phase"], rec["epoch"]) == (e["phase"], e["epoch"])
            assert rec["val_loss"] == e["val_loss"]
            rec["layers"] = e["layers"]
        out[task] = {"epochs": epochs,
                     "checkpoints": checkpoints(
                         cfg["emotion"]["checkpoint_dir"])}
    return out


def gaps(a, b):
    """The largest |Δ| between two runs' records, by metric family, over
    both tasks; the decisions (phases, epochs, layers, learning rates,
    checkpoints and their epochs) must be equal."""
    out = {"train_loss": 0.0, "val_loss": 0.0, "metric": 0.0}
    for task in TASKS:
        x_run, y_run = a[task], b[task]
        assert [(e["phase"], e["epoch"], e["layers"], e["lr"])
                for e in x_run["epochs"]] == \
            [(e["phase"], e["epoch"], e["layers"], e["lr"])
             for e in y_run["epochs"]]
        for x, y in zip(x_run["epochs"], y_run["epochs"]):
            for key in ("train_loss", "val_loss"):
                out[key] = max(out[key], abs(x[key] - y[key]))
            assert x["metric"].keys() == y["metric"].keys()
            for name in x["metric"]:
                out["metric"] = max(out["metric"], abs(x["metric"][name]
                                                       - y["metric"][name]))
        assert set(x_run["checkpoints"]) == set(y_run["checkpoints"])
        for name, meta in x_run["checkpoints"].items():
            other = y_run["checkpoints"][name]
            assert (meta["epoch"], meta["phase"]) == (other["epoch"],
                                                      other["phase"])
            key = METRIC[task]
            out["metric"] = max(out["metric"], abs(meta[key] - other[key]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("entry_emotion"))
    data = corpus(root)
    ref = jax_run(root, *data)
    return ref, port_run(root, *data, ref)


def test_trainers_follow_jax(runs):
    ref, port = runs
    got = gaps(ref, port)
    for key, bound in BOUNDS.items():
        assert got[key] <= bound, (key, got[key], bound)


@pytest.mark.parametrize("task", TASKS)
def test_phases_layers_and_checkpoints_are_jax(runs, task):
    ref, port = runs
    want = [("classifier", 0, []), ("classifier", 1, []),
            ("fine_tune", 0, [1]), ("fine_tune", 1, [0, 1])]
    for run in (ref, port):
        assert [(e["phase"], e["epoch"], e["layers"])
                for e in run[task]["epochs"]] == want
        assert set(run[task]["checkpoints"]) == {"best_classifier_model",
                                                 "best_fine_tuned_model"}
    for name, meta in ref[task]["checkpoints"].items():
        got = port[task]["checkpoints"][name]
        assert (got["epoch"], got["phase"]) == (meta["epoch"], meta["phase"])
