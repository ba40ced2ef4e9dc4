"""The readings the limits of a cell's compared numbers are set from, on
the card at the cell's own size, every seed in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \\
        --controls 3 [--first 3000000000] [--out <file.jsonl>] \\
        [--raw <file.jsonl>]

For each seed: the program's run as a cell's set-up drives it (for the
evaluator, with one pass), the program's state freed, then the plain
reference; its gaps are the sound readings.  For the first ``--controls``
seeds also the control, the reference computed in fp8 (each product's
operands rounded to float8 e4m3 with a scale a tensor: the nearest
precision below the configuration's bf16 compute) put in the program's
place, and for a training cell the fault of a step that leaves half the
batch out (the reference on the batches' first halves in the program's
place).  A step that leaves the state unchanged reads 1 on ``change``
without a run.  One JSON line a reading, with every number a training
cell can compare (``loop.training_gaps``); ``--raw`` also writes each
side's readings whole.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import loop, run  # noqa: E402


def halves(batches):
    return [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]


def main(argv=None, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--raw", default=None)
    args = ap.parse_args(argv)
    import importlib

    import torch

    from portbench.reference.wavlm import fp8_round

    spec = run.resolve(args.workload, run.load_json(run.ROOT
                                                    / "BENCHMARK.json"))
    run.override(spec, overrides)
    device = torch.device(device or "cuda")
    kind = spec.workload["entry"]
    out = open(args.out, "a") if args.out else None
    raw = open(args.raw, "a") if args.raw else None
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
            ctx = types.SimpleNamespace(
                config=spec.config, traffic=spec.traffic,
                workload=spec.workload, seed=seed, seconds=1.0, trace=False,
                device=device, tmp=tmp)
            cell = importlib.import_module(
                f"portbench.entries.{kind}").Cell(ctx)
            cell.setup()
            if cell.kind == "eval":
                from portbench.trace import Spans

                cell.window(0.0, Spans(False), steps=1)
            program = cell.readings
            cell.release()
            reference = cell.check()
            rows = [("sound", program)]
            if i < args.controls:
                rows.append(("control", cell.check(q=fp8_round)))
                if cell.kind == "train":
                    cell.checked = halves(cell.checked)
                    rows.append(("half_batch", cell.check()))
        raw_rows = raw if cell.kind == "train" else None
        if raw_rows:
            raw.write(json.dumps({"seed": seed, "what": "reference",
                                  **reference}) + "\n")
        for what, readings in rows:
            if cell.kind == "train":
                gaps = loop.training_gaps(readings, reference)
                values = {k: gaps[k] for k in (
                    "loss", "loss_mean", "grad", "grad_median", "change")}
                print(json.dumps({"seed": seed, "what": what,
                                  "left_out": len(gaps["left_out"]),
                                  "worst": gaps["worst"]}), flush=True)
            else:
                values = {k: c["value"] for k, c in run.compare(
                    cell.kind, readings, reference,
                    spec.workload["limits"]).items()}
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "what": what, "seconds":
                               time.perf_counter() - t0, **values})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            if raw_rows:
                raw.write(json.dumps({"seed": seed, "what": what,
                                      **readings}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
