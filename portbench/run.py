"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``portbench/configs/<config>.json``) and traffic
(``portbench/traffic/<traffic>.json``); ``portbench/workloads/<cell>.json``
names the entry kind (``portbench/entries/<kind>.py``), the run's
parameters and the limits of the compared numbers; each per-layer metric
is read by ``portbench/metrics/<metric>.py``.  Set-up (from the process's
start to the first timed step: corpus, weights, state, the capture of the
cell's shapes and the first steps the check compares) is ``setup_s``; then
the window runs for ``--seconds`` (``--trace 1``: a short profiled window,
and the per-layer metrics); then the program's state is freed and the
plain reference (``portbench/reference/``) recomputes what the check
compares.  The last line of standard output is the result; the last lines
of standard error each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nrse_tpu")


def process_age() -> float:
    """Seconds since this process started, from ``/proc``."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, manifest: dict) -> types.SimpleNamespace:
    """Everything the cell ``name`` is made of, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in manifest["end_to_end"]
                  if name in m.get("workloads", [name])]
    return types.SimpleNamespace(
        cell=cell, config=load_json(ROOT / configs[cell["config"]]["file"]),
        traffic=load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        workload=load_json(BENCH / "workloads" / f"{name}.json"),
        per_layer=per_layer, end_to_end=end_to_end)


def override(spec: types.SimpleNamespace, overrides) -> None:
    """``{"config" | "traffic" | "workload": {key: value}}`` into a
    resolved cell, a dict value updating a dict (the CPU tests' tiny
    sizes)."""
    for part, changes in (overrides or {}).items():
        target = getattr(spec, part)
        for key, value in changes.items():
            if isinstance(value, dict) and isinstance(target.get(key), dict):
                target[key].update(value)
            else:
                target[key] = value


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric}", BENCH / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def compare(kind: str, program, reference, limits: dict) -> dict:
    """Each compared number beside its limit."""
    from portbench import loop

    if kind == "train":
        gaps = loop.training_gaps(program, reference)
        values = {k: gaps[k] for k in limits}
    else:
        import numpy as np

        ref = np.stack([reference[i] for i in sorted(reference)])
        got = np.stack([program[i] for i in sorted(reference)])
        scale = float(np.sqrt((ref.astype(np.float64) ** 2).mean()))
        values = {"logits": float(np.abs(got - ref).max()) / scale}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def main(argv=None, device=None, overrides=None) -> int:
    """``device`` and ``overrides`` (:func:`override`) serve the CPU
    tests, which drive a run at a tiny size without a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch

    spec = resolve(args.workload, load_json(ROOT / "BENCHMARK.json"))
    chips = int(spec.cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    override(spec, overrides)
    from portbench import trace

    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        ctx = types.SimpleNamespace(
            config=spec.config, traffic=spec.traffic, workload=spec.workload,
            seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            device=torch.device(device), tmp=tmp)
        kind = spec.workload["entry"]
        cell = importlib.import_module(f"portbench.entries.{kind}").Cell(ctx)
        cell.setup()
        cuda = ctx.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        setup_s = process_age()
        spans = trace.Spans(bool(args.trace))
        result = {"correct": False, "attempted": 0, "failed": 0,
                  "metrics": {}}
        if args.trace:
            obs: dict = {}
            warm = spec.workload["trace_warm"]
            with trace.profiled(obs):
                cell.window(0.0, trace.Spans(False), steps=warm)
                run = cell.window(0.0, spans,
                                  steps=spec.workload["trace_steps"])
            cell.observe(run, obs, spans)
            for m in spec.per_layer:
                value = reader(m["name"])(obs)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
            result["breakdown"] = trace.breakdown(obs)
        else:
            run = cell.window(args.seconds, spans)
            result["metrics"] = {
                m["name"]: {"value": run["metrics"][m["name"]],
                            "unit": m["unit"]}
                for m in spec.end_to_end if m["name"] in run["metrics"]}
            result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        result["attempted"], result["failed"] = run["attempted"], \
            run["failed"]
        result["device"] = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(ctx.device) if cuda
            else "cpu", "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(ctx.device)
            if cuda else 0}
        if args.trace:
            result["device"].update(busy_s=obs["busy_s"],
                                    window_s=obs["window_s"])
        program = cell.readings
        cell.release()
        checks = compare(cell.kind, program, cell.check(),
                         spec.workload["limits"])
        result["correct"] = result["failed"] == 0 and all(
            c["value"] <= c["limit"] for c in checks.values())
        result["checks"] = checks
        found = forbidden_modules()  # after everything the run loads
        if found:
            print("portbench: the run loaded " + ", ".join(found),
                  file=sys.stderr)
            return 4
        for name, c in checks.items():
            print(f"check {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        print(json.dumps(result))
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
