"""Every configuration, cell and metric resolves by name, and a cell
added as files alone is found with no code edit."""

import json
import re
import shutil

import pytest

from portbench import run

MANIFEST = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_resolves(cell):
    spec = run.resolve(cell, MANIFEST)
    assert spec.config["name"] == spec.cell["config"]
    assert spec.workload["entry"] in ("byol", "finetune", "evaluate")
    kinds = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert m["moves"] in kinds
        assert callable(run.reader(m["name"]))


def test_manifest_keeps_the_contract():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert run.load_json(run.ROOT / c["file"])["name"] == c["name"]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    """A cell added as a workload file and a manifest entry, with no
    edit to any code, resolves and finds its entry kind and metrics."""
    bench = tmp_path / "portbench"
    shutil.copytree(run.BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    wl = json.loads((bench / "workloads" / "ser-eval-ragged.json")
                    .read_text())
    (bench / "workloads" / "ser-eval-short.json").write_text(json.dumps(wl))
    (bench / "traffic" / "short-only.json").write_text(json.dumps(
        {"groups": [{"name": "short", "kind": "speech", "count": 8,
                     "seconds": [2.0, 4.0]}]}))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({
        "name": "ser-eval-short", "config": "wavlm-large-ser",
        "traffic": "short-only", "chips": 1, "why": "a test cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "ser-eval-ragged" in m.get("workloads", []):
            m["workloads"].append("ser-eval-short")
    monkeypatch.setattr(run, "BENCH", bench)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    spec = run.resolve("ser-eval-short", manifest)
    assert spec.traffic["groups"][0]["count"] == 8
    assert {m["name"] for m in spec.per_layer} == {
        "pad_share.eval", "mfu.eval", "ffn_roofline.eval",
        "idle_share.eval", "device_ms_per_pass.eval"}
