"""The evidence reports' new columns, on the CPU.

  * ``report_utils.bf16_numpy_mean`` reads what numpy's mean of a
    bfloat16 array reads (``ml_dtypes``, JAX's bfloat16), bit for bit, at
    a few dozen to a thousand rows, and it departs from the mean as the
    rows grow;
  * ``tools/port_convergence_report.py``'s ``records_of`` puts that
    reading beside each per-SNR mean when an epoch's record holds its
    validation's per-sample values;
  * ``tools/port_transfer_seeds.py`` sums up the e2e legs' lift over the
    seeds' ``results.json``.
"""

import importlib.util
import json
import statistics
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

from nrse_tpu_torch.utils.report_utils import bf16_numpy_mean, to_bf16

ROOT = Path(__file__).resolve().parent.parent


def _module(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n", [1, 36, 180, 1000])
def test_bf16_mean_is_numpys(n):
    values = np.random.default_rng(n).normal(0.92, 0.05, n).astype(
        np.float32)
    want = float(values.astype(ml_dtypes.bfloat16).mean())
    assert bf16_numpy_mean(values) == want
    assert np.array_equal(to_bf16(values),
                          values.astype(ml_dtypes.bfloat16).astype(
                              np.float32))
    if n >= 180:  # the accumulator's rounding no longer averages out
        assert abs(want - float(values.astype(np.float64).mean())) > 0.01


def test_convergence_rows_carry_jax_arithmetic():
    report = _module("port_convergence_report")
    rng = np.random.default_rng(0)
    sims = rng.normal(0.9, 0.05, 400).astype(np.float32)
    snrs = np.repeat(np.float32([2, 20]), 200)
    epochs = [{"epoch": 0, "train_loss": 1.0, "val_loss": 1.1,
               "val_avg_similarity": 0.9, "audio_sec_per_sec_per_chip": 1.0,
               "s_per_step": 0.1, "val_similarities": {
                   2: float(sims[:200].mean(dtype=np.float64)),
                   20: float(sims[200:].mean(dtype=np.float64))}}]
    row, = report.records_of([dict(epochs[0], val_samples={
        "loss": None, "similarity": sims, "snr": snrs})])
    for snr, rows in ((2, sims[:200]), (20, sims[200:])):
        assert row[f"val_similarity_snr_{snr}_jax_bf16"] == \
            bf16_numpy_mean(rows)
    assert not any(k.endswith("_jax_bf16")
                   for k in report.records_of(epochs)[0])


def test_transfer_seeds_summary(tmp_path):
    seeds = _module("port_transfer_seeds")
    runs = []
    for seed, (b, r) in {42: (0.5, 0.55), 43: (0.6, 0.5),
                         44: (0.7, 0.62)}.items():
        run = tmp_path / f"seed{seed}"
        run.mkdir()
        f1 = {p: {"macro_f1": b + i / 100, "accuracy": 0.0}
              for i, p in enumerate(seeds.PARTS)}
        f1_r = {p: {"macro_f1": r, "accuracy": 0.0} for p in seeds.PARTS}
        (run / "results.json").write_text(json.dumps(
            {"categorical_byol_e2e": f1, "categorical_random_e2e": f1_r}))
        (run / "checks.json").write_text(json.dumps({"card": "cpu"}))
        (run / "README.md").write_text(f"`... --ser-seed {seed}`")
        runs.append(str(run))
    out = seeds.main(["--runs", *runs, "--out", str(tmp_path / "out")])
    assert [s["seed"] for s in out["seeds"]] == ["42", "43", "44"]
    lifts = [-0.05, 0.1, 0.08]
    assert out["lift"]["clean"]["mean"] == pytest.approx(
        statistics.fmean(lifts))
    assert out["lift"]["clean"]["std"] == pytest.approx(
        statistics.stdev(lifts))
    assert out["lift"]["snr4"]["min"] == pytest.approx(-0.03)
    text = (tmp_path / "out" / "README.md").read_text()
    assert all(f"\n| {seed} | " in text for seed in (42, 43, 44))
    assert "+0.043 ± 0.081" in text
