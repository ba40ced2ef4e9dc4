"""BYOL's e2e lift over random init across the SER legs' seeds.

    python3 tools/port_transfer_seeds.py --runs <out dir> [<out dir> ...] \\
        [--out docs/port_transfer_seeds]

Each ``--runs`` directory is the ``--out`` of one
``tools/port_transfer_report.py --legs byol_e2e,random_e2e --ser-seed S``
run (its ``results.json`` and ``checks.json``).  Per seed, the e2e legs'
macro-F1 at clean, snr8 and snr4 and BYOL's lift (``byol_e2e`` minus
``random_e2e``); over the seeds, each leg's mean macro-F1 and each
lift's mean, sample standard deviation, least and greatest.  Writes
``summary.json`` and ``README.md`` under ``--out`` and prints the
summary.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics

PARTS = ("clean", "snr8", "snr4")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+", required=True)
    p.add_argument("--out", default="docs/port_transfer_seeds")
    return p.parse_args(argv)


def seed_of(run: str) -> str:
    """The ``--ser-seed`` a run's README names, or the run's directory."""
    try:
        with open(os.path.join(run, "README.md")) as f:
            m = re.search(r"--ser-seed (\d+)", f.read())
        if m:
            return m.group(1)
    except OSError:
        pass
    return os.path.basename(os.path.normpath(run))


def summarise(runs) -> dict:
    seeds, card = [], None
    for run in runs:
        with open(os.path.join(run, "results.json")) as f:
            results = json.load(f)
        with open(os.path.join(run, "checks.json")) as f:
            checks = json.load(f)
        card = card or checks.get("card")
        byol, rand = (results["categorical_byol_e2e"],
                      results["categorical_random_e2e"])
        seeds.append({
            "seed": seed_of(run), "card": checks.get("card"),
            "byol_e2e": {p: byol[p]["macro_f1"] for p in PARTS},
            "random_e2e": {p: rand[p]["macro_f1"] for p in PARTS},
            "lift": {p: byol[p]["macro_f1"] - rand[p]["macro_f1"]
                     for p in PARTS}})
    lift = {}
    for p in PARTS:
        values = [s["lift"][p] for s in seeds]
        lift[p] = {"mean": statistics.fmean(values),
                   "std": statistics.stdev(values) if len(values) > 1
                   else 0.0,
                   "min": min(values), "max": max(values)}
    means = {leg: {p: statistics.fmean(s[leg][p] for s in seeds)
                   for p in PARTS} for leg in ("byol_e2e", "random_e2e")}
    return {"card": card, "seeds": seeds, "lift": lift, "means": means}


def readme(summary: dict, runs) -> str:
    rows = "\n".join(
        f"| {s['seed']} | " + " | ".join(
            f"{s['byol_e2e'][p]:.3f} / {s['random_e2e'][p]:.3f} / "
            f"{s['lift'][p]:+.3f}" for p in PARTS) + " |"
        for s in summary["seeds"])
    m = summary["means"]
    rows += "\n| mean | " + " | ".join(
        f"{m['byol_e2e'][p]:.3f} / {m['random_e2e'][p]:.3f} / "
        f"{summary['lift'][p]['mean']:+.3f}" for p in PARTS) + " |"
    stats = " | ".join(
        f"{summary['lift'][p]['mean']:+.3f} ± {summary['lift'][p]['std']:.3f}"
        f" ({summary['lift'][p]['min']:+.3f} to "
        f"{summary['lift'][p]['max']:+.3f})" for p in PARTS)
    return f"""# BYOL's e2e lift over random init, over the SER legs' seeds

`python3 tools/port_transfer_seeds.py --runs {' '.join(runs)}` over the
runs of `tools/port_transfer_report.py --reuse --legs
byol_e2e,random_e2e --ser-seed S` (the e2e legs trained from a BYOL
checkpoint and from random init with `training.seed` S; runs made in one
call share the BYOL checkpoint the first of them trained), on
{summary['card']}.

Macro-F1, BYOL e2e / random e2e / lift:

| seed | clean | snr8 | snr4 |
|---|---|---|---|
{rows}

The lift over the seeds, mean ± sample standard deviation (least to
greatest):

| clean | snr8 | snr4 |
|---|---|---|
| {stats} |

Each run trains BYOL's e2e leg, then the random-init leg, in one
process after the BYOL stage (`tools/port_transfer_report.py`). The
port lists the corpus sorted, so a leg gives the same bits on any
machine, fresh or after an earlier stage in its process
(`tools/port_transfer_repeat.py` holds one to that): the spread over
the seeds is the seeds' own.
"""


def main(argv=None) -> dict:
    args = parse_args(argv)
    summary = summarise(args.runs)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(args.out, "README.md"), "w") as f:
        f.write(readme(summary, args.runs))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
