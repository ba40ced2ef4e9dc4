"""``chip_smoke.py`` phase 23 (entry repeat) alone on the card.

The training entry points must give the same bits in fresh processes,
after an earlier stage in the same process and whatever order the
filesystem lists the corpus in: three processes at once over one small
synthetic corpus, WavLM-large at full width cut to 2 layers,
(a) BYOL's entry then the random-init e2e leg, (b) the leg alone over
card memory filled with 0xFF, (c) as (a) on copies of the corpus's clean
and noise directories written in reverse order, ``os.walk`` yielding their
files reversed (``chip_smoke.phase_entry_repeat``).

    python3 tools/entry_repeat.py [--log PATH]

Every line goes to stdout and, with ``--log``, to that file as well.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log", default=None)
    args = p.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.log:
            os.makedirs(os.path.dirname(os.path.abspath(args.log)),
                        exist_ok=True)
            f = stack.enter_context(open(args.log, "w"))
            stack.enter_context(contextlib.redirect_stdout(
                _Tee(sys.stdout, f)))
        t0 = time.perf_counter()
        chip_smoke.phase_device()
        chip_smoke.timed(chip_smoke.phase_build)
        chip_smoke.timed(chip_smoke.phase_entry_repeat)
        print(f"[time] tools/entry_repeat.py: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
