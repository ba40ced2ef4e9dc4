"""The port's baseline evaluator CLI (``nrse_tpu_torch.baseline.
eval_cat_ser.main``) on a tiny corpus, against the JAX package's timed
path on the same weights; its numpy metrics against scikit-learn and a
hand count; its label parser against the JAX package's.

The corpus: three WAVs under 5 s (one 5 s bucket: 80000 samples, 3999
frames of the tiny encoder, so the port runs the flash path's plain
version), batch 2 (the second batch padded with a row whose mask is all
zero), one row labelled X (not scored).  The JAX side runs its
``bucketed_forward_timed`` with its default XLA attention, the same
arithmetic.  Logits are held to 1e-4 of max|logits|.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.baseline.eval_cat_ser import (
    bucketed_forward_timed as jax_bucketed_forward_timed,
)
from nrse_tpu.baseline.eval_cat_ser import load_audio_16k as jax_load_audio
from nrse_tpu.baseline.pipeline import BaselineSER as JaxBaselineSER
from nrse_tpu.baseline.pipeline import (
    make_baseline_forward as jax_make_forward,
)
from nrse_tpu.labels.parsing import parse_label_list as jax_parse_label_list
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.train.losses import ce_weight_category as jax_ce_weight_category
from nrse_tpu.train.losses import compute_ccc as jax_compute_ccc
from nrse_tpu_torch.audio.io import save_wav
from nrse_tpu_torch.baseline import eval_cat_ser
from nrse_tpu_torch.baseline.pipeline import BaselineSER
from nrse_tpu_torch.baseline.wavset import WavNormStats
from nrse_tpu_torch.eval.metrics import classification_metrics
from nrse_tpu_torch.labels.parsing import (
    BASELINE_EMOTIONS_MAP,
    parse_label_list,
)
from nrse_tpu_torch.models.convert import baseline_params_to_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import flash_attention
from nrse_tpu_torch.train.checkpoint import save_model
from nrse_tpu_torch.train.losses import ce_weight_category, compute_ccc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD_DIM = 32
SR = 16000
CLIPS = [("a.wav", "H", 0.8), ("b.wav", "X", 1.7), ("c.wav", "N", 2.9)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("sereval")
    audio = d / "Audios"
    audio.mkdir()
    rng = np.random.default_rng(0)
    lines, waves = [], []
    for name, emo, seconds in CLIPS:
        t = np.arange(int(SR * seconds)) / SR
        x = (0.4 * np.sin(2 * np.pi * rng.uniform(90, 300) * t)
             + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        save_wav(str(audio / name), x, SR)
        waves.append(x)
        lines.append(f"Audios/{name}; {emo}; A:3.0; V:4.0; D:5.0;")
    label_list = d / "list.txt"
    label_list.write_text("\n".join(lines) + "\n")
    model_dir = d / "model"
    model_dir.mkdir()
    WavNormStats.from_waveforms(waves).save(
        str(model_dir / "train_norm_stat.pkl"))

    jax_model = JaxBaselineSER(JaxWavLMConfig.tiny(), head_dim=HEAD_DIM)
    params = jax_model.init(jax.random.PRNGKey(3), jnp.zeros((1, 4000)),
                            jnp.ones((1, 4000)))["params"]
    cfg = WavLMConfig.tiny()
    model = BaselineSER(cfg, head_dim=HEAD_DIM)
    model.load_state_dict({
        k: torch.from_numpy(v) for k, v in baseline_params_to_state_dict(
            jax.tree.map(np.asarray, params), cfg).items()}, strict=True)
    save_model(str(model_dir), "final_model", model)

    before = flash_attention.LAUNCHES
    metrics, scored = eval_cat_ser.main([
        "--model_path", str(model_dir), "--audio_list", str(label_list),
        "--audio_dir", str(d), "--batch_size", "2", "--head_dim",
        str(HEAD_DIM), "--model_name", "tiny", "--device", "cpu"])
    assert flash_attention.LAUNCHES == before  # the CPU's plain versions

    stats = WavNormStats.load(str(model_dir / "train_norm_stat.pkl"))
    entries = jax_parse_label_list(str(label_list), audio_dir=str(d))
    loaded = [(e, stats.apply(jax_load_audio(e.path))) for e in entries]
    ref, _, ref_seconds = jax_bucketed_forward_timed(
        jax_make_forward(jax_model), params, loaded, 2)
    return {"dir": model_dir, "metrics": metrics, "scored": scored,
            "ref": ref, "ref_seconds": ref_seconds}


def test_logits_equal_jax_per_file(run):
    ours = {os.path.basename(e.path): logit for e, logit in run["scored"]}
    ref = {os.path.basename(e.path): np.asarray(logit)
           for e, logit in run["ref"]}
    assert sorted(ours) == sorted(ref) == sorted(c[0] for c in CLIPS)
    scale = max(np.abs(v).max() for v in ref.values())
    for name in ref:
        err = np.abs(ours[name] - ref[name]).max() / scale
        assert err < 1e-4, f"{name}: max|Δ|/max|ref| {err}"
    assert run["metrics"]["audio_seconds"] == pytest.approx(
        run["ref_seconds"])


def test_outputs_written(run):
    out = run["dir"] / "results"
    with open(out / "inference_results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["Filename"] for r in rows] == [c[0] for c in CLIPS]
    assert list(rows[0]) == (["Filename"] + [f"Label_{k}" for k in range(8)]
                             + ["Prediction"])
    happy = BASELINE_EMOTIONS_MAP["H"]
    assert rows[0][f"Label_{happy}"] == "1.0"
    assert all(rows[1][f"Label_{k}"] == "0.0" for k in range(8))  # X
    written = dict(line.split(": ", 1) for line in
                   (out / "metrics.txt").read_text().splitlines())
    m = run["metrics"]
    assert set(written) == set(m)
    assert m["n_files"] == 3 and m["n_scored"] == 2
    for k in ("f1_micro", "f1_macro", "precision_macro", "recall_macro",
              "inference_loss", "inference_time_per_audio_second"):
        assert np.isfinite(m[k]) and float(written[k]) == m[k]
    # the numpy metrics on the evaluator's own predictions
    labelled = [(e.emotion, int(np.argmax(logit)))
                for e, logit in run["scored"] if e.emotion >= 0]
    y, pred = (np.array(v) for v in zip(*labelled))
    assert classification_metrics(y, pred) == {
        k: m[k] for k in ("f1_micro", "f1_macro", "precision_macro",
                          "recall_macro")}


def test_metrics_hand_count():
    # labels 0, 1, 2; predictions hit 0 twice, miss 1, predict 3 once
    y = [0, 0, 1, 2, 2]
    pred = [0, 0, 2, 2, 3]
    m = classification_metrics(y, pred)
    # per label (0, 1, 2, 3): tp 2 0 1 0, fp 0 0 1 1, fn 0 1 1 0
    assert m["f1_micro"] == pytest.approx(3 / 5)
    assert m["precision_macro"] == pytest.approx((1 + 0 + 0.5 + 0) / 4)
    assert m["recall_macro"] == pytest.approx((1 + 0 + 0.5 + 0) / 4)
    assert m["f1_macro"] == pytest.approx((1 + 0 + 0.5 + 0) / 4)


def test_metrics_match_scikit_learn():
    metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(7)
    for n in (1, 9, 300):
        y, pred = rng.integers(0, 8, n), rng.integers(0, 6, n)
        ours = classification_metrics(y, pred)
        assert ours["f1_micro"] == pytest.approx(
            metrics.f1_score(y, pred, average="micro"))
        assert ours["f1_macro"] == pytest.approx(
            metrics.f1_score(y, pred, average="macro"))
        assert ours["precision_macro"] == pytest.approx(
            metrics.precision_score(y, pred, average="macro",
                                    zero_division=0))
        assert ours["recall_macro"] == pytest.approx(
            metrics.recall_score(y, pred, average="macro", zero_division=0))


def test_parse_label_list_equals_jax():
    path = os.path.join(ROOT, "labels", "msp1_11-test2-clean.txt")
    ours = parse_label_list(path, audio_dir="/data")
    ref = jax_parse_label_list(path, audio_dir="/data")
    assert len(ours) == len(ref) > 1000
    assert [vars(e) for e in ours] == [vars(e) for e in ref]


@pytest.mark.parametrize("weighted,labels", [
    (False, [0, 3, 7, 2, 2]),
    (True, [0, 3, 7, 2, 2]),
    (True, [-1, 3, 9, 2, 8]),   # invalid labels contribute nothing
    (True, [-1, 8, 9, -5, 8]),  # no valid label: zero loss
])
def test_losses_match_jax(weighted, labels):
    rng = np.random.default_rng(len(labels) + weighted)
    logits = (3 * rng.standard_normal((5, 8))).astype(np.float32)
    y = np.asarray(labels, np.int64)
    w = rng.uniform(0.5, 3.0, 8).astype(np.float32) if weighted else None
    ours = ce_weight_category(torch.from_numpy(logits), torch.from_numpy(y),
                              None if w is None else torch.from_numpy(w))
    ref = jax_ce_weight_category(jnp.asarray(logits), jnp.asarray(y),
                                 None if w is None else jnp.asarray(w))
    assert ours.dtype == torch.float32
    assert abs(float(ours) - float(ref)) < 1e-6
    p, t = rng.standard_normal(50), rng.standard_normal(50) + 0.3
    assert compute_ccc(p, t) == pytest.approx(jax_compute_ccc(p, t),
                                              rel=1e-12)
