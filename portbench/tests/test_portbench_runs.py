"""Whole runs of each cell at a tiny size on the CPU (the port's plain
paths in float32): the result line's schema, the plain reference against
the program, and the control and each fault the cell can have coming out
as not correct under the committed limits."""

import contextlib
import io
import json
import re

import pytest
import torch

from portbench import run
from portbench.reference import models as ref_models
from portbench.reference import wavlm as ref_wavlm
from portbench.tests.tiny import OVERRIDES

CELLS = list(OVERRIDES)
SEED = 2**31 + 977


def drive(cell, trace=0):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "0.5", "--trace", str(trace)], device="cpu",
                      overrides=OVERRIDES[cell])
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue().strip().splitlines()


@pytest.mark.parametrize("cell", CELLS)
def test_the_result_line_keeps_its_schema_and_the_reference_agrees(cell):
    result, err = drive(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0
    spec = run.resolve(cell, run.load_json(run.ROOT / "BENCHMARK.json"))
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    for name, m in result["metrics"].items():
        assert m["value"] > 0 and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$",
                                           m["unit"])
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    tail = err[-len(result["checks"]):]
    for line, (name, c) in zip(tail, result["checks"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"
        # both sides compute in float32 here: the gaps are rounding, far
        # under the limits set for the card's bf16
        assert c["value"] < 1e-2 * c["limit"], (name, c)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_layers(cell):
    result, _ = drive(cell, trace=1)
    spec = run.resolve(cell, run.load_json(run.ROOT / "BENCHMARK.json"))
    names = {m["name"] for m in spec.per_layer}
    assert set(result["metrics"]) <= names
    assert "window_s" in result["device"] and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["correct"] is True


def _fp8_in_place(monkeypatch, cell):
    """The control: the plain reference in fp8 put in the program's
    place, on the same inputs."""
    spec = run.resolve(cell, run.load_json(run.ROOT / "BENCHMARK.json"))
    kind = spec.workload["entry"]
    import importlib

    entry = importlib.import_module(f"portbench.entries.{kind}")
    setup = entry.Cell.setup

    def setup_then_control(self):
        setup(self)
        if kind != "evaluate":
            self.readings = self.check(q=ref_wavlm.fp8_round)

    monkeypatch.setattr(entry.Cell, "setup", setup_then_control)
    if kind == "evaluate":
        window = entry.Cell.window

        def window_then_control(self, *a, **k):
            out = window(self, *a, **k)
            self.readings = self.check(q=ref_wavlm.fp8_round)
            return out

        monkeypatch.setattr(entry.Cell, "window", window_then_control)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, monkeypatch):
    _fp8_in_place(monkeypatch, cell)
    result, _ = drive(cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _state_unchanged(monkeypatch):
    from nrse_tpu_torch.baseline import train_ft_cat_ser
    from nrse_tpu_torch.train import byol_trainer

    monkeypatch.setattr(byol_trainer, "fused_adamw_ema_update",
                        lambda *a, **k: None)
    monkeypatch.setattr(train_ft_cat_ser, "_apply",
                        lambda state, spec, inputs: state.acc.zero_())


def _half_batch(monkeypatch):
    from nrse_tpu_torch.baseline import train_ft_cat_ser
    from nrse_tpu_torch.train import byol_trainer

    views = byol_trainer.byol_views

    def half_views(batch, on_device_mixing=True):
        clean, noisy, valid = views(batch, on_device_mixing)
        keep = torch.arange(valid.shape[0]) < valid.shape[0] // 2
        return clean, noisy, valid & keep.to(valid.device)

    ce = train_ft_cat_ser.ce_weight_category

    def half_ce(logits, labels, weights=None, mesh=None):
        n = logits.shape[0] // 2
        return ce(logits[:n], labels[:n], weights, mesh)

    monkeypatch.setattr(byol_trainer, "byol_views", half_views)
    monkeypatch.setattr(train_ft_cat_ser, "ce_weight_category", half_ce)


def _answer_altered(monkeypatch):
    from nrse_tpu_torch.baseline import pipeline

    forward = pipeline.BaselineSER.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        return out + (torch.arange(out.shape[0]) == 0)[:, None].to(out)

    monkeypatch.setattr(pipeline.BaselineSER, "forward", altered)


FAULTS = [("byol-train-5s", _state_unchanged),
          ("byol-train-5s", _half_batch),
          ("ser-finetune-10s", _state_unchanged),
          ("ser-finetune-10s", _half_batch),
          ("ser-eval-ragged", _answer_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = drive(cell)
    assert result["correct"] is False


def test_the_control_rounds_to_fp8():
    x = torch.linspace(-3, 3, 1001)
    r = ref_wavlm.fp8_round(x)
    assert torch.unique(r).numel() < 256
    assert (r - x).abs().max() <= 3 / 448 * 32
    assert ref_models.byol_loss(torch.ones(2, 3), torch.ones(2, 3),
                                torch.tensor([True, False])) < 1e-6


def test_change_keeps_a_leaf_that_moves_after_the_first_step():
    """A leaf whose reference gradient is nought at the first step (a
    layer LayerDrop skipped there) and not at a later one stays in
    ``change``; one nought at every step goes."""
    from portbench import loop

    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 1.0, "c": 0.0, "d": 0.0},
           "grads": [{"a": 1.0, "b": 1.0, "c": 0.0, "d": 0.0},
                     {"a": 1.0, "b": 1.0, "c": 1.0, "d": 0.0}],
           "change": {"online.a": 1.0, "online.b": 1.0, "online.c": 1.0,
                      "online.d": 1e-9, "target.c": 1.0}}
    prog = {"loss": [1.0], "grad": dict(ref["grad"]),
            "change": dict(ref["change"], **{"online.c": 0.0})}
    gaps = loop.training_gaps(prog, ref)
    assert gaps["left_out"] == ["online.d"]
    assert gaps["change"] == 1.0 and gaps["grad"] == 0.0
    ref.pop("grads")
    assert loop.training_gaps(prog, ref)["change"] == 0.0
