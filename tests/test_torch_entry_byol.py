"""The port's BYOL entry point against JAX's, over whole epochs.

``nrse_tpu_torch.train_byol.main`` against the root ``train_byol.py``'s
``main`` on the CPU, on one synthetic corpus and config: WavLM tiny in
float32 on both sides (``tpu.compute_dtype: float32`` for JAX), every
dropout, LayerDrop and SpecAugment off on both (each package's
``WavLMConfig.from_model_name`` patched here: the two sides draw their
masks from different generators), projection 16, prediction 32, 16
training clips of 0.3 s at batch 4 (4 steps an epoch) and 4 held out.
The port starts from JAX's initial variables: its
``init_byol_state_dict`` is patched to return
``byol_variables_to_state_dicts`` of what JAX's ``create_train_state``
made at the same seed.  Both sides list the corpus sorted (JAX's
datasets through ``torch_entry.sorted_listing``), its clean files named
in the order (``CLEAN_ORDER``) the bounds below were measured in.
``num_epochs`` is 3 (the cosine schedule runs
over 12 steps).  Early stopping watches the average similarity with
patience 1 and ``min_delta`` 0.00757, 1.1e-5 above the second epoch's
gain in JAX's run (0.0075589): a port within the similarity bound stops
after the second epoch as JAX does, one that dropped ``min_delta`` would
go on.  The config leaves ``tpu.optimizer_impl`` unset, so JAX runs
plain ``optax.adamw`` and the port rounds the moments' rates as it does
(``FusedAdamWSpec.optax_rates``).  AdamW's eps is 1e-3 on both sides, as
in the step tests (``tests/test_torch_train_step.py``; the configs do not
expose it, so each package's optimizer constructor is patched here): at
1e-8 Adam turns a gradient that is zero in exact arithmetic and float32
noise on each side (a Dense bias feeding a BatchNorm) into ±lr, and the
validation, whose BatchNorms read running statistics, carries it.

Held to JAX, per epoch: the train and validation losses, the per-SNR and
average clean↔noisy similarity (JAX's from its wandb stub, as
``tools/convergence_report.py`` reads them; the port's from ``main``'s
return value); the checkpoints written and their ``epoch`` and ``best``
entries; the early-stopping decision.

The bounds follow ``tests/test_torch_train_step.py``'s pre-mixed updates
(``PREMIXED_SEED_BOUNDS``): twice JAX's own spread on this run, measured
by ``tools/entry_spread.py byol`` four ways (JAX's ``main`` against
itself with the first batch's waveforms one float32 ulp up, one ulp
down, its Pallas attention for its XLA attention, its Pallas FFN for its
XLA pair: each a float32 evaluation as good as the first, and two
evaluations within the spread of a third lie within twice it of each
other).
"""

import functools
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import train_byol as jax_train_byol
from nrse_tpu.train import byol_trainer as jax_byol_trainer
from nrse_tpu.train import schedules as jax_schedules
from nrse_tpu_torch import train_byol
from nrse_tpu_torch.data.synthetic import generate_corpus
from nrse_tpu_torch.models.convert import byol_variables_to_state_dicts
from nrse_tpu_torch.models.wavlm import WavLMConfig
from torch_entry import EPS, checkpoints, quiet_names, sorted_listing

torch.set_num_threads(1)

PROJ, PRED, SEED, EPOCHS = 16, 32, 5, 3
# just above the average similarity's gain from the first epoch to the
# second in JAX's run (0.9729371 → 0.9804960)
MIN_DELTA = 0.00757
# twice JAX's own spread on this run (tools/entry_spread.py byol: the
# largest |Δ| of the four ways over the two epochs, rounded up at three
# digits)
BOUNDS = {"train_loss": 2 * 1.29e-5, "val_loss": 2 * 7.40e-6,
          "similarity": 2 * 3.58e-7}
# the order os.walk listed the clean files in (an ext4 directory's hash
# order) where MIN_DELTA and BOUNDS were measured: the run they describe
# takes its validation split and batches from this order.  Both sides now
# list sorted (the port's get_audio_files, JAX's through
# torch_entry.sorted_listing), and corpus() names the files so that the
# sorted order is this one on every machine; JAX's run on it reads the
# gain and the spread above (docs/entry_spread/byol.log).  On the files'
# plain sorted order JAX's own spread on this run is 3.3-8.7x larger
# (tools/entry_spread.py byol with corpus() not renaming: 7.30e-5,
# 6.44e-5, 1.19e-6), so bounds measured there would hold the port less
CLEAN_ORDER = (8, 5, 11, 10, 2, 7, 16, 14, 13, 12, 3, 9, 4, 1, 6, 19, 0, 18,
               17, 15)


def jax_byol_optimizer(learning_rate, weight_decay=1e-5, total_steps=0,
                       clip_norm=1.0, mu_dtype=None):
    """``nrse_tpu.train.schedules.make_byol_optimizer`` at Adam's eps
    ``EPS``."""
    schedule = learning_rate
    if total_steps and not callable(learning_rate):
        schedule = jax_schedules.cosine_annealing(learning_rate, total_steps)
    return optax.chain(optax.clip_by_global_norm(clip_norm),
                       optax.adamw(schedule, weight_decay=weight_decay,
                                   eps=EPS, mu_dtype=mu_dtype))


def corpus(root):
    """The synthetic corpus, its clean files named so that the sorted
    listing both sides read is ``CLEAN_ORDER``."""
    clean, noise = generate_corpus(os.path.join(root, "corpus"), 20, 3,
                                   seconds=0.5, duration_jitter=0.3, seed=2,
                                   verbose=False)
    for rank, i in enumerate(CLEAN_ORDER):
        src = os.path.join(clean, f"speech_{i:06d}.wav")
        if os.path.exists(src):  # a corpus made before is named already
            os.rename(src, os.path.join(clean, f"{rank:02d}_{i:06d}.wav"))
    return clean, noise


def config(root, clean, noise, side):
    return {
        "model": {"name": "wavlm-tiny", "projection_dim": PROJ,
                  "prediction_dim": PRED, "ema_decay": 0.99},
        "training": {"batch_size": 4, "num_workers": 2,
                     "num_epochs": EPOCHS, "learning_rate": 5e-4,
                     "weight_decay": 1e-5, "seed": SEED,
                     "checkpoint_dir": os.path.join(root, side, "ckpt"),
                     "log_dir": os.path.join(root, side, "logs"),
                     "early_stopping_metric": "val_avg_similarity",
                     "early_stopping_patience": 1,
                     "early_stopping_min_delta": MIN_DELTA},
        "data": {"clean_data_path": clean, "noise_data_path": noise,
                 "sample_rate": 16000, "max_audio_length": 0.3,
                 "snr_range": [0, 5, 10, 20], "validation_ratio": 0.2},
        "logging": {"wandb_mode": "offline", "visualization_interval": 100,
                    "level": "ERROR", "console_level": "ERROR"},
        "tpu": {"compute_dtype": "float32", "mesh": {"data": 1, "model": 1}},
        "device": "cpu",
    }


def jax_run(root, clean, noise, nudge: float = 0.0, variant=None):
    """The root ``train_byol.main`` on the config: ``{"epochs": per-epoch
    records from the wandb stub, "checkpoints": {name: meta},
    "variables": the initial variables (numpy)}``; ``nudge`` ±inf moves
    the first batch's clean and noise waveforms one float32 ulp that
    way, ``variant`` sets JAX's encoder fields (``quiet_names``)."""
    side = f"jax{nudge:+}" + "".join(f"_{k}" for k in (variant or {}))
    cfg = config(root, clean, noise, side)
    path = os.path.join(root, f"{side}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    made = {}
    real_state = jax_byol_trainer.create_train_state
    real_step = jax_byol_trainer.make_byol_train_step

    def create_train_state(*args, **kwargs):
        state = real_state(*args, **kwargs)
        made["variables"] = {"online": _np(state.variables.online),
                             "target": _np(state.variables.target)}
        return state

    def make_byol_train_step(*args, **kwargs):
        step, first = real_step(*args, **kwargs), [bool(nudge)]

        def run(state, batch):
            if first[0]:
                first[0] = False
                batch = dict(batch, **{k: jnp.nextafter(
                    batch[k], jnp.float32(nudge)) for k in ("clean",
                                                            "noise")})
            return step(state, batch)
        return run

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_byol_trainer, "create_train_state", create_train_state)
        m.setattr(jax_byol_trainer, "make_byol_train_step",
                  make_byol_train_step)
        m.setattr(jax_schedules, "make_byol_optimizer", jax_byol_optimizer)
        quiet_names(m, variant)
        sorted_listing(m)
        jax_train_byol.main(["--config", path])
    records = []
    for stub in glob.glob(os.path.join(cfg["training"]["log_dir"],
                                       "wandb_stub_*.jsonl")):
        with open(stub) as f:
            records += [r for r in map(json.loads, f) if "val_loss" in r]
    records.sort(key=lambda r: r["epoch"])
    epochs = [{"epoch": r["epoch"], "train_loss": r["train_loss"],
               "val_loss": r["val_loss"],
               "val_avg_similarity": r["val_avg_similarity"],
               "sims": {float(k.rsplit("_", 1)[1]): v for k, v in r.items()
                        if k.startswith("val_similarity_snr_")}}
              for r in records]
    return {"epochs": epochs, "variables": made["variables"],
            "checkpoints": checkpoints(cfg["training"]["checkpoint_dir"])}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


def port_run(root, clean, noise, variables):
    """``nrse_tpu_torch.train_byol.main`` on the config, from JAX's
    initial ``variables``: the same record as :func:`jax_run`."""
    cfg = config(root, clean, noise, "port")
    online, _ = byol_variables_to_state_dicts(variables,
                                              WavLMConfig.tiny())
    start = {k: torch.from_numpy(v) for k, v in online.items()}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(train_byol, "init_byol_state_dict",
                  lambda *args, **kwargs: dict(start))
        m.setattr(train_byol, "FusedAdamWSpec",
                  functools.partial(train_byol.FusedAdamWSpec, eps=EPS))
        quiet_names(m)
        out = train_byol.main(cfg)
    epochs = [{"epoch": e["epoch"], "train_loss": e["train_loss"],
               "val_loss": e["val_loss"],
               "val_avg_similarity": e["val_avg_similarity"],
               "sims": {float(k): v for k, v in
                        e["val_similarities"].items()}}
              for e in out["epochs"]]
    return {"epochs": epochs, "stopped_early": out["stopped_early"],
            "checkpoints": checkpoints(cfg["training"]["checkpoint_dir"])}


def gaps(a, b):
    """The largest |Δ| between two runs' records, by metric family."""
    assert [e["epoch"] for e in a["epochs"]] == \
        [e["epoch"] for e in b["epochs"]]
    out = {"train_loss": 0.0, "val_loss": 0.0, "similarity": 0.0}
    for x, y in zip(a["epochs"], b["epochs"]):
        for key in ("train_loss", "val_loss"):
            out[key] = max(out[key], abs(x[key] - y[key]))
        assert set(x["sims"]) == set(y["sims"])
        for snr in x["sims"]:
            out["similarity"] = max(out["similarity"],
                                    abs(x["sims"][snr] - y["sims"][snr]))
        out["similarity"] = max(out["similarity"], abs(
            x["val_avg_similarity"] - y["val_avg_similarity"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("entry_byol"))
    clean, noise = corpus(root)
    ref = jax_run(root, clean, noise)
    return ref, port_run(root, clean, noise, ref["variables"])


def test_epochs_follow_jax(runs):
    ref, port = runs
    assert [e["epoch"] for e in ref["epochs"]] == [0, 1]
    got = gaps(ref, port)
    for key, bound in BOUNDS.items():
        assert got[key] <= bound, (key, got[key], bound)
    assert all(len(e["sims"]) >= 2 for e in ref["epochs"])


def test_early_stopping_decision_is_jax(runs):
    ref, port = runs
    assert port["stopped_early"]
    assert len(port["epochs"]) == len(ref["epochs"]) == 2 < EPOCHS


def test_checkpoints_and_best_are_jax(runs):
    ref, port = runs
    assert set(port["checkpoints"]) == set(ref["checkpoints"]) == {
        "best_val_loss", "best_val_similarity", "last_model"}
    for name, want in ref["checkpoints"].items():
        got = port["checkpoints"][name]
        assert got["epoch"] == want["epoch"], name
        assert abs(got["loss"] - want["loss"]) <= BOUNDS["val_loss"]
        assert abs(got["best"]["val_loss"] - want["best"]["val_loss"]) \
            <= BOUNDS["val_loss"]
        assert abs(got["similarity"] - want["similarity"]) \
            <= BOUNDS["similarity"]
        assert abs(got["best"]["val_similarity"]
                   - want["best"]["val_similarity"]) <= BOUNDS["similarity"]
