"""The port's baseline SER fine-tune against JAX's, over whole epochs.

``nrse_tpu_torch.baseline.train_ft_cat_ser.main`` against
``nrse_tpu/baseline/train_ft_cat_ser.py::main`` on the CPU, on the tiny
corpus of ``tests/test_baseline_e2e.py`` (ten ``Train`` clips and six
``Development`` clips of 0.5-1.5 s, 1 s crops), WavLM tiny in float32,
end to end (``--freeze_ssl false``), batch 2, k = 2 (five micro-steps an
epoch: the third update takes the last micro-step of the first epoch and
the first of the second), two epochs, every dropout, LayerDrop and
SpecAugment off on both sides (each package's ``WavLMConfig.
from_model_name`` and ``BaselineSER``'s head dropout patched here).  The
port starts from JAX's init (``train_ft_cat_ser.py:163``, kept by a
wrapper around ``BaselineSER.init``): its ``init_baseline_state_dict`` is
patched to return it, converted.  AdamW's eps is 1e-3 on both sides (the
command line does not expose it: ``optax.adamw`` and the port's
``FusedAdamWSpec`` are patched), as in ``tests/test_torch_train_step.py``.

Held to JAX: each epoch's train and dev loss (JAX's from its
``LogManager``, the port's from ``main``'s return value), the epoch and
dev loss ``final_model`` was saved at, and its parameters (the largest
|Δ| of any of them over the run's scale: the largest distance any
parameter of JAX's run moved from its start).  The bounds are twice
JAX's own spread on the same run, measured four ways by
``tools/entry_spread.py ft`` (as ``tests/test_torch_entry_byol.py``
says).  JAX runs plain ``optax.adamw``, whose moments' rates the port
follows (``FusedAdamWSpec.optax_rates``: K4's own rounding of ``1 − b2``
put the port's losses 2× JAX's spread off).
"""

import functools
import json
import os

import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from nrse_tpu.audio.io import save_wav
from nrse_tpu.baseline import train_ft_cat_ser as jax_ft
from nrse_tpu.baseline.pipeline import BaselineSER as JaxBaselineSER
from nrse_tpu.data import loader as jax_loader
from nrse_tpu.labels.parsing import BASELINE_EMOTIONS_MAP
from nrse_tpu.train.checkpoint import restore_checkpoint_raw
from nrse_tpu_torch.baseline import train_ft_cat_ser as port_ft
from nrse_tpu_torch.baseline.pipeline import BaselineSER
from nrse_tpu_torch.models.convert import baseline_params_to_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train.checkpoint import restore_model
from torch_entry import EPS, QUIET, quiet_names

torch.set_num_threads(1)

SR = 16000
HEAD_DIM = 32
# twice JAX's own spread on this run (tools/entry_spread.py ft: the
# largest |Δ| of the four ways, rounded up at three digits)
BOUNDS = {"train_loss": 2 * 5.25e-7, "dev_loss": 2 * 5.57e-7,
          "params": 2 * 5.40e-5}


def quiet(mp, variant=None) -> None:
    """``torch_entry.quiet_names``, and both trainers' ``BaselineSER``
    its head without dropout."""
    quiet_names(mp, variant)
    mp.setattr(jax_ft, "BaselineSER",
               functools.partial(JaxBaselineSER, dropout=0.0))
    mp.setattr(port_ft, "BaselineSER",
               functools.partial(BaselineSER, dropout=0.0))


def corpus(root):
    """``tests/test_baseline_e2e.py``'s corpus; returns the path of its
    ``config.json``."""
    rng = np.random.default_rng(0)
    wav_dir = os.path.join(root, "Audios")
    os.makedirs(wav_dir)
    rows = []
    for i, c in enumerate(["A", "S", "H", "N"] * 4):
        name = f"MSP-PODCAST_{3000 + i}_{i:04d}.wav"
        t = np.arange(int(SR * rng.uniform(0.5, 1.5))) / SR
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(90, 350) * t)
        x += 0.05 * rng.standard_normal(t.shape)
        save_wav(os.path.join(wav_dir, name), x.astype(np.float32), SR)
        one_hot = {k: 0.0 for k in BASELINE_EMOTIONS_MAP}
        one_hot[c] = 1.0
        rows.append({"FileName": name, **one_hot,
                     "Split_Set": "Train" if i < 10 else "Development"})
    labels = os.path.join(root, "labels_onehot.csv")
    pd.DataFrame(rows).to_csv(labels, index=False)
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump({"wav_dir": wav_dir, "label_path": labels}, f)
    return (path,)


def argv(config_path, model_path):
    return ["--config", config_path, "--model_path", model_path,
            "--epochs", "2", "--batch_size", "2", "--accumulation_steps",
            "2", "--lr", "1e-3", "--freeze_ssl", "false", "--head_dim",
            str(HEAD_DIM), "--model_name", "wavlm-tiny", "--max_seconds",
            "1.0"]


def _np(tree):
    return jax.tree.map(np.array, tree)


def jax_run(root, config_path, nudge: float = 0.0, variant=None):
    """JAX's ``main``: ``{"epochs": [{train_loss, dev_loss}], "params":
    the initial params (numpy), "final": final_model's state dict in the
    port's layout, "meta": its metadata}``; ``nudge`` ±inf moves the first
    training batch's waveforms one float32 ulp that way, ``variant`` sets
    JAX's encoder fields (``quiet``)."""
    model_path = os.path.join(root, f"jax{nudge:+}" + "".join(
        f"_{k}" for k in (variant or {})))
    made, stats = {}, []
    real_init = JaxBaselineSER.init

    def init(self, *args, **kwargs):
        variables = real_init(self, *args, **kwargs)
        made["params"] = _np(variables["params"])
        return variables

    class LogManager(jax_ft.LogManager):
        def get_stat(self, name):
            value = super().get_stat(name)
            stats.append((name, value))
            return value

    class HostDataLoader(jax_loader.HostDataLoader):
        def __iter__(self):
            first = self.shuffle and self.epoch == 0 and nudge
            for i, batch in enumerate(super().__iter__()):
                if first and i == 0:
                    batch = dict(batch, input_values=np.nextafter(
                        batch["input_values"], np.float32(nudge)))
                yield batch

    with pytest.MonkeyPatch.context() as m:
        quiet(m, variant)
        m.setattr(JaxBaselineSER, "init", init)
        m.setattr(jax_ft, "LogManager", LogManager)
        m.setattr(jax_loader, "HostDataLoader", HostDataLoader)
        m.setattr(optax, "adamw", functools.partial(optax.adamw, eps=EPS))
        jax_ft.main(argv(config_path, model_path))
    # get_stat is read twice an epoch, train_loss then dev_loss
    epochs = [{"train_loss": stats[i][1], "dev_loss": stats[i + 1][1]}
              for i in range(0, len(stats), 2)]
    assert [n for n, _ in stats] == ["train_loss", "dev_loss"] * len(epochs)
    final = restore_checkpoint_raw(model_path, "final_model")["params"]
    with open(os.path.join(model_path, "final_model", "meta.json")) as f:
        meta = json.load(f)
    return {"epochs": epochs, "params": made["params"], "meta": meta,
            "final": baseline_params_to_state_dict(
                _np(final), WavLMConfig.tiny())}


def port_run(root, config_path, params):
    """The port's ``main`` from JAX's initial ``params``: the same record
    as :func:`jax_run`."""
    model_path = os.path.join(root, "port")
    start = {k: torch.from_numpy(v) for k, v in
             baseline_params_to_state_dict(params,
                                           WavLMConfig.tiny()).items()}
    with pytest.MonkeyPatch.context() as m:
        quiet(m)
        m.setattr(port_ft, "init_baseline_state_dict",
                  lambda *args, **kwargs: dict(start))
        m.setattr(port_ft, "FusedAdamWSpec",
                  functools.partial(port_ft.FusedAdamWSpec, eps=EPS))
        out = port_ft.main(argv(config_path, model_path) + ["--device",
                                                            "cpu"])
    model = BaselineSER(WavLMConfig.tiny(**QUIET), head_dim=HEAD_DIM,
                        device="meta")
    meta = restore_model(model_path, "final_model", model)
    return {"epochs": [{k: e[k] for k in ("train_loss", "dev_loss")}
                       for e in out["epochs"]], "meta": meta,
            "final": {k: v.numpy() for k, v in model.state_dict().items()}}


def gaps(a, b):
    """The largest |Δ| of the losses between two runs, and of the final
    parameters over ``a``'s scale (the largest distance a parameter moved
    from ``a``'s start); the epoch ``final_model`` was saved at must be
    equal."""
    assert len(a["epochs"]) == len(b["epochs"]) == 2
    out = {key: max(abs(x[key] - y[key])
                    for x, y in zip(a["epochs"], b["epochs"]))
           for key in ("train_loss", "dev_loss")}
    assert a["meta"]["epoch"] == b["meta"]["epoch"]
    out["dev_loss"] = max(out["dev_loss"], abs(a["meta"]["dev_loss"]
                                               - b["meta"]["dev_loss"]))
    assert set(a["final"]) == set(b["final"])
    start = baseline_params_to_state_dict(a["params"], WavLMConfig.tiny())
    scale = max(float(np.abs(a["final"][k] - start[k]).max())
                for k in a["final"])
    out["params"] = max(float(np.abs(a["final"][k] - b["final"][k]).max())
                        for k in a["final"]) / scale
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("entry_ft"))
    data = corpus(root)
    ref = jax_run(root, *data)
    return ref, port_run(root, *data, ref["params"])


def test_fine_tune_follows_jax(runs):
    ref, port = runs
    got = gaps(ref, port)
    for key, bound in BOUNDS.items():
        assert got[key] <= bound, (key, got[key], bound)


def test_final_model_is_saved_where_jax_saves_it(runs):
    ref, port = runs
    best = int(np.argmin([e["dev_loss"] for e in ref["epochs"]]))
    assert ref["meta"]["epoch"] == port["meta"]["epoch"] == best
    assert port["meta"]["freeze_ssl"] is False
    # the encoder trained (end to end): it moved from JAX's start
    start = baseline_params_to_state_dict(ref["params"], WavLMConfig.tiny())
    key = "ssl.encoder.layers.0.attention.q_proj.weight"
    assert not np.array_equal(port["final"][key], start[key])
