"""The port's evidence path on the CPU, tiny: the quickstart, the
BYOL→SER transfer report and the profile summary, against the JAX
package's scripts where they share a contract.

- ``examples/quickstart_torch.py`` and ``tools/port_transfer_report.py
  --smoke`` run to their end in the blocked-import subprocess of
  ``test_torch_imports.py`` (no ``nrse_tpu``, no pandas), wavlm-tiny at
  one thread; the transfer report's checks hold (each BYOL leg's encoder
  started as the BYOL checkpoint's online encoder, each random leg's did
  not, every readout mixed in the held-out noise);
- the stage configs of ``nrse_tpu_torch.utils.report_utils`` equal JAX's
  ``tools/transfer_report.py`` ``ser_config`` and ``run_byol`` for the
  same arguments, less the TPU-only keys :data:`TPU_ONLY`;
- a SER leg started from a BYOL checkpoint holds its online encoder bit
  for bit (``report_utils.same_encoder``), one from random weights not;
- ``tools/port_analyze_profile.py`` groups a recorded CPU trace and a
  trace of known kernel names;
- ``results.json`` and the README's tables equal the JAX report's for the
  same results.
"""

import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import test_torch_imports
from nrse_tpu_torch.data.synthetic import (
    generate_corpus,
    generate_emotion_corpus,
)
from nrse_tpu_torch.models.convert import init_byol_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train.byol_trainer import create_train_state
from nrse_tpu_torch.train.checkpoint import load_byol_encoder, save_checkpoint
from nrse_tpu_torch.utils import report_utils
from nrse_tpu_torch.utils.profiling import COPIES, profile_trace
from torch_init import with_random_biases

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# the keys of JAX's stage configs that only its TPU runtime reads
TPU_ONLY = ("remat", "frontend_remat", "rng_impl")
LEGS = ("categorical_byol", "categorical_random", "categorical_byol_e2e",
        "categorical_random_e2e", "dimensional_byol", "dimensional_random")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port_report = _module(ROOT / "tools" / "port_transfer_report.py",
                      "port_transfer_report")
analyze = _module(ROOT / "tools" / "port_analyze_profile.py",
                  "port_analyze_profile")


def _blocked_run(code: str, timeout: int = 300) -> dict:
    """Run ``code`` at one thread in a fresh interpreter that refuses the
    JAX package and pandas (``test_torch_imports.BLOCK``), and check that
    neither was loaded; returns the JSON its last line prints.  torch's
    compiler, which probes for pandas with ``find_spec`` (not an import),
    is loaded before the refusal."""
    check = ("print(json.dumps(sorted(m for m in sys.modules if m.split('.')"
             "[0] in ('nrse_tpu', 'pandas', 'jax', 'flax', 'optax'))))\n")
    res = subprocess.run(
        [sys.executable, "-c", "import torch._dynamo\n"
         + test_torch_imports.BLOCK + "import torch\n"
         "torch.set_num_threads(1)\n" + code + check],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    *_, out, loaded = res.stdout.strip().splitlines()
    assert json.loads(loaded) == []
    return json.loads(out)


def test_quickstart_runs_without_the_jax_package(tmp_path):
    out = _blocked_run(
        "sys.path.insert(0, 'examples')\n"
        "import quickstart_torch\n"
        f"out = quickstart_torch.main({str(tmp_path)!r}, 'cpu', "
        "'wavlm-tiny')\n"
        "print(json.dumps({'byol': [[e['train_loss'], e['val_loss']] "
        "for e in out['byol']], 'f1': out['emotion'], "
        "'report': out['report']}))\n")
    assert len(out["byol"]) == 2 and np.isfinite(out["byol"]).all()
    assert 0.0 <= out["f1"] <= 1.0
    for part in ("clean", "noisy"):
        assert set(out["report"][part]) == {"accuracy", "macro_f1"}
        assert all(np.isfinite(v) for v in out["report"][part].values())
    assert (tmp_path / "ckpts" / "emotion" / "best_classifier_model"
            / "state.pt").is_file()
    with open(tmp_path / "msp" / "labels_consensus.csv") as f:
        assert f.readline().strip() == ("FileName,EmoClass,EmoAct,EmoVal,"
                                        "EmoDom,Split_Set,SpkrID,Gender")


def test_transfer_report_smoke_runs_without_the_jax_package(tmp_path):
    corpus = tmp_path / "corpus"
    out = _blocked_run(
        "sys.path.insert(0, 'tools')\n"
        "import port_transfer_report\n"
        "out = port_transfer_report.main(['--smoke', '--corpus', "
        f"{str(corpus)!r}])\n"
        "print(json.dumps({'checks': out['checks']}))\n")
    checks = out["checks"]
    with open(corpus / "out" / "results.json") as f:
        results = json.load(f)
    assert sorted(results) == sorted(LEGS)
    for leg in LEGS:
        assert sorted(results[leg]) == ["clean", "snr4", "snr8"]
        for part in results[leg].values():
            assert all(np.isfinite(v) for v in part.values())
        assert checks[leg]["encoder_is_byol"] == ("_byol" in leg)
        assert checks[leg]["readout_noise"] == str(
            corpus / "noise_eval" / "noise")
        assert checks[leg]["steps"] > 0
    assert checks["byol"]["steps"] > 0
    readme = (corpus / "out" / "README.md").read_text()
    assert "## Categorical SER (macro-F1)" in readme
    assert "## Dimensional SER (CCC)" in readme
    assert json.loads((corpus / "out" / "checks.json").read_text())[
        "legs"] == checks


def _jax_report():
    return _module(ROOT / "tools" / "transfer_report.py",
                   "jax_transfer_report")


def _strip_tpu_only(config):
    config = json.loads(json.dumps(config))
    for key in TPU_ONLY:
        config.get("tpu", {}).pop(key, None)
    return config


class _Captured(Exception):
    pass


def _jax_byol_config(jtr, monkeypatch, *args, **kwargs):
    """The config JAX's ``run_byol`` writes for ``train_byol``: its YAML
    dump is caught (into memory) before the run."""
    seen = {}

    def dump(config, f):
        seen["config"] = config
        raise _Captured

    def opened(path, mode="r", *args, **kwargs):
        if "w" in mode:  # the config file: kept in memory
            return io.StringIO()
        return open(path, mode, *args, **kwargs)

    monkeypatch.setattr(yaml, "safe_dump", dump)
    monkeypatch.setattr(jtr, "open", opened, raising=False)
    with pytest.raises(_Captured):
        jtr.run_byol(*args, **kwargs)
    return seen["config"]


@pytest.mark.parametrize("smoke", [False, True])
def test_byol_stage_config_equals_jax(monkeypatch, smoke):
    jtr = _jax_report()
    log_dir = "/tmp/nrse_transfer_logs"  # JAX's run_byol's own
    want = _jax_byol_config(jtr, monkeypatch, "clean", "noise", "ckpt", 10,
                            36, smoke=smoke, snr_range=[2.0, 4.0, 8.0, 12.0])
    got = report_utils.byol_config("clean", "noise", "ckpt", 10, 36, log_dir,
                                   smoke=smoke,
                                   snr_range=[2.0, 4.0, 8.0, 12.0])
    assert _strip_tpu_only(got) == _strip_tpu_only(want)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("preset,categorical,e2e", [
    ("dev_wavlm-large_emotion_cat.yaml", True, False),
    ("dev_wavlm-large_emotion_cat.yaml", True, True),
    ("dev_wavlm-large_emotion_dim.yaml", False, False)])
def test_ser_stage_configs_equal_jax(preset, categorical, e2e, smoke):
    jtr = _jax_report()
    for enc in ("byol_ckpt/best_val_loss", None):
        args = (preset, "labels.csv", "Audios", "noise", enc, "ser_ckpt", 8,
                16, 1e-3, categorical)
        kwargs = dict(smoke=smoke, e2e=e2e, ft_epochs=6, ft_lr=2e-5,
                      snr_range=[2.0, 4.0, 8.0, 12.0])
        want = jtr.ser_config(*args, **kwargs)
        got = report_utils.ser_config(*args, "/tmp/nrse_transfer_logs",
                                      **kwargs)
        assert _strip_tpu_only(got) == _strip_tpu_only(want)
        # the TPU-only keys are all the two differ in
        assert set(want["tpu"]) - set(got["tpu"]) <= set(TPU_ONLY)


def test_byol_leg_starts_from_the_checkpoints_online_encoder(tmp_path):
    cfg = WavLMConfig.tiny()
    state = create_train_state(
        cfg, with_random_biases(init_byol_state_dict(
            cfg, 32, 64, torch.Generator().manual_seed(3)), 3),
        32, 64, "cpu")
    byol_best = save_checkpoint(str(tmp_path / "byol"), "best_val_loss",
                                state)
    audio_dir, labels = generate_emotion_corpus(
        str(tmp_path / "emotion"), 8, 4, seconds=0.5, verbose=False)
    _, noise = generate_corpus(str(tmp_path / "noise"), 0, 2, seconds=0.5,
                               seed=1, verbose=False)
    legs = {}
    for name, enc in (("byol", byol_best), ("random", None)):
        config = report_utils.ser_config(
            "dev_wavlm-large_emotion_cat.yaml", labels, audio_dir, noise,
            enc, str(tmp_path / f"ser_{name}"), 1, 4, 1e-3, True,
            str(tmp_path / "logs"), smoke=True)
        config["data"]["max_audio_length"] = 0.48
        info = report_utils.train_ser(config, "categorical")
        assert info["steps"] == 2 and not info["captured"]
        ckpt = str(tmp_path / f"ser_{name}" / "best_classifier_model")
        legs[name] = report_utils.same_encoder(ckpt, byol_best, config)
        got = report_utils.ser_encoder(ckpt, config)
        assert got.keys() == load_byol_encoder(byol_best, cfg).keys()
    assert legs == {"byol": True, "random": False}


def test_analyze_profile_groups_a_cpu_trace(tmp_path):
    x = torch.randn(64, 256)
    w = torch.randn(256, 256)
    with profile_trace(str(tmp_path)):
        for _ in range(3):
            y = torch.nn.functional.layer_norm(x @ w, (256,))
            y.to(torch.float64)
    table = analyze.summarize(analyze.load_events(
        analyze.find_trace(str(tmp_path))), n_steps=3)
    assert table["plane"] == "host"
    assert table["groups"]["LayerNorm"] > 0
    assert table["groups"][COPIES] > 0
    assert table["busy_ms"] > 0 and table["per_step_ms"] > 0
    assert table["busy_ms"] == pytest.approx(sum(table["groups"].values()))


def test_analyze_profile_groups_kernel_names(tmp_path, capsys):
    kernels = [  # name, start µs, duration µs
        ("k6_fwd_wgmma_kernel", 0, 100),
        ("ln_row_fwd_kernel", 100, 20),
        ("block_attention_fwd_wgmma_kernel", 120, 50),
        ("void nrse::gemm<EpiGelu>(Params)", 170, 200),
        ("dropout_kernel", 370, 10),
        ("adamw_ema_kernel", 380, 30),
        ("flash_attention_fwd_wgmma", 410, 40),
        ("void at::native::elementwise_kernel<...>", 450, 5),
        ("mystery", 455, 5),
        ("block_attention_fwd_wgmma_kernel", 500, 70),
    ]
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d,
               "pid": 0, "tid": 7} for n, t, d in kernels]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
                   "dur": 1000, "pid": 1, "tid": 1})
    path = tmp_path / "trace_1.json"
    path.write_text(json.dumps({"traceEvents": events}))
    table = analyze.main([str(tmp_path), "2", "--json"])
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(table))
    assert table["plane"] == "device"
    assert table["span_ms"] == pytest.approx(0.57)
    assert table["busy_ms"] == pytest.approx(0.53)
    assert table["busy_share"] == pytest.approx(0.53 / 0.57)
    assert table["per_step_ms"] == pytest.approx(0.265)
    assert table["groups"] == pytest.approx({
        "kernel B and K2 (fused FFN GEMMs)": 0.2,
        "kernel A (block attention)": 0.12,
        "K6 (fused conv frontend)": 0.1,
        "K5 (flash attention)": 0.04,
        "K4 (AdamW)": 0.03,
        "K7 (channel LayerNorm)": 0.02,
        "K1 (dropout)": 0.01,
        "elementwise": 0.005,
        "other": 0.005})
    assert table["top"][0] == ["void nrse::gemm<EpiGelu>(Params)", 0.2, 1]
    assert table["top"][1] == ["block_attention_fwd_wgmma_kernel", 0.12, 2]
    assert list(table["groups"])[:2] == ["kernel B and K2 (fused FFN GEMMs)",
                                         "kernel A (block attention)"]


def _results():
    rng = np.random.default_rng(0)
    out = {}
    for leg in LEGS:
        metrics = (("ccc_arousal", "ccc_valence", "ccc_dominance")
                   if leg.startswith("dimensional") else
                   ("accuracy", "macro_f1"))
        out[leg] = {part: {m: float(rng.uniform()) for m in metrics}
                    for part in ("clean", "snr8", "snr4")}
    return out


def test_results_and_readme_tables_match_the_jax_report(tmp_path,
                                                        monkeypatch):
    results = _results()
    # JAX's report, all of it cached: it only writes its artifact
    corpus = tmp_path / "corpus"
    for sub in ("emotion", "noise_train", "noise_eval"):
        (corpus / sub).mkdir(parents=True)
        (corpus / sub / ".complete").write_text("cached\n")
    (corpus / "emotion" / "Audios").mkdir()
    (corpus / "emotion" / "Audios" / "MSP-SYN_Tr_00000.wav").write_bytes(b"")
    (corpus / "byol_ckpt" / "best_val_loss").mkdir(parents=True)
    for leg, res in results.items():
        (corpus / f"readout_{leg}.json").write_text(json.dumps(res))
    jax_out = tmp_path / "jax_out"
    monkeypatch.setattr(sys, "argv", [
        "transfer_report.py", "--reuse", "--corpus", str(corpus), "--out",
        str(jax_out)])
    _jax_report().main()

    port_out = tmp_path / "port_out"
    port_report.write_artifact(
        port_report.parse_args(["--out", str(port_out)]), results,
        {leg: {} for leg in LEGS}, {"total": 1.0})
    for name in ("results.json",):
        assert json.loads((port_out / name).read_text()) == json.loads(
            (jax_out / name).read_text())

    def tables(path):
        lines = (path / "README.md").read_text().splitlines()
        return lines[next(i for i, line in enumerate(lines)
                          if line.startswith("## ")):]

    assert tables(port_out) == tables(jax_out)
    assert sum(line.startswith("| BYOL-pretrained |")
               for line in tables(port_out)) == 7
