"""The random-init e2e leg of the transfer report, at one seed, three
times: once after BYOL's stage in the same process, then twice alone in
fresh processes; the three must agree to the bit.

    python3 tools/port_transfer_repeat.py --out <dir> \\
        [--ser-seed 42] [--fresh 2] [--corpus build/port_transfer] \\
        [-- <more tools/port_transfer_report.py arguments>]

Each run is ``tools/port_transfer_report.py`` in its own process: first
``--legs random_e2e --skip-dimensional`` (the corpus, BYOL's stage, then
the leg), then ``--reuse --stage categorical:random_e2e`` ``--fresh``
times (BYOL's checkpoint reused, the leg alone).  After each run the
leg's cached readout (``readout_categorical_random_e2e_seed<S>.json``:
the readout, the best macro-F1, the epoch records and the sha256 of the
best checkpoint's state) is moved under ``--out``, so that the next run
trains the leg anew; the first run's is put back at the end, for a later
``--reuse``.  Prints each run's figures and whether they are equal, and
exits 1 where they are not.  The first run's report (``results.json``,
``checks.json`` with BYOL's epochs and checkpoint digest) is under
``--out``/chained.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(ROOT, "tools", "port_transfer_report.py")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--ser-seed", type=int, default=42)
    p.add_argument("--fresh", type=int, default=2)
    p.add_argument("--corpus", default=os.path.join(ROOT, "build",
                                                    "port_transfer"))
    p.add_argument("rest", nargs="*",
                   help="more arguments of port_transfer_report.py")
    return p.parse_args(argv)


def same(runs: dict) -> bool:
    """Whether the runs' cached readouts agree: readout, best, epoch
    records and checkpoint digest."""
    keys = ("best", "epochs", "digest")
    first = next(iter(runs.values()))
    return all(r["readout"] == first["readout"] and all(
        r["checks"][k] == first["checks"][k] for k in keys)
        for r in runs.values())


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    cache = os.path.join(
        args.corpus,
        f"readout_categorical_random_e2e_seed{args.ser_seed}.json")
    common = ["--ser-seed", str(args.ser_seed), "--corpus", args.corpus,
              *args.rest]
    plans = [("chained", ["--legs", "random_e2e", "--skip-dimensional",
                          "--out", os.path.join(args.out, "chained")])]
    plans += [(f"fresh{i + 1}", ["--reuse", "--stage",
                                 "categorical:random_e2e"])
              for i in range(args.fresh)]
    if os.path.exists(cache):
        os.remove(cache)
    runs, seconds = {}, {}
    for name, extra in plans:
        t0 = time.perf_counter()
        code = subprocess.call([sys.executable, REPORT, *extra, *common])
        seconds[name] = time.perf_counter() - t0
        if code:
            print(f"# repeat: the {name} run exited with {code}", flush=True)
            return code
        kept = os.path.join(args.out, f"random_e2e_{name}.json")
        shutil.move(cache, kept)
        with open(kept) as f:
            runs[name] = json.load(f)
    shutil.copyfile(os.path.join(args.out, "random_e2e_chained.json"), cache)
    for name, r in runs.items():
        c = r["checks"]
        print(f"# repeat: {name} ({seconds[name]:.0f} s): best "
              f"{c['best']!r}, readout "
              + ", ".join(f"{part} {m['macro_f1']!r}"
                          for part, m in r["readout"].items())
              + f"; digest {c['digest']}; epochs "
              + json.dumps(c["epochs"]), flush=True)
    agree = same(runs)
    print(f"# repeat: the random-init e2e leg at seed {args.ser_seed}, "
          f"after BYOL's stage and {args.fresh} times fresh: "
          f"{'equal to the bit' if agree else 'NOT equal'}", flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
