"""A DevicePrefetcher whose copy stream is the stream a CUDA graph is
being captured on, on the card.

    python3 tools/prefetch_stream_check.py

Each round prefetches batches while the main thread captures a program
(``runtime.graphs.ProgramCache``) on its first batch, as the evaluator
and the trainers do.  "forced": the prefetcher is handed
``torch.cuda.graph``'s capture stream, as a stream of torch's
normal-priority pool now and then is; "loader's own": the prefetcher's
own stream (high priority since the fix).  Prints, for each, the rounds
that raised and the count of wrong values read.  Needs a card."""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from nrse_tpu_torch.data import loader as loader_module  # noqa: E402
from nrse_tpu_torch.runtime.graphs import (  # noqa: E402
    ProgramCache,
    audio_inputs,
)


def rounds(n, forced):
    real = torch.cuda.Stream
    failures, bad_values = [], 0
    for r in range(n):
        batches = [{"input_values": np.full((8, 160000), i, np.float32),
                    "__count__": 8} for i in range(6)]
        cache = ProgramCache(lambda x, m: (x * 2.0).sum(-1), "cuda",
                             audio_inputs(with_mask=False))
        if forced:
            if torch.cuda.graph.default_capture_stream is None:
                torch.cuda.graph.default_capture_stream = real()
            capture = torch.cuda.graph.default_capture_stream
            loader_module.torch.cuda.Stream = lambda *a, **k: capture
        try:
            for i, b in enumerate(loader_module.DevicePrefetcher(
                    batches, "cuda", depth=4)):
                loader_module.torch.cuda.Stream = real
                out = cache(b["input_values"], None)
                if float(out[0]) != 2.0 * 160000 * i:
                    bad_values += 1
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001
            failures.append((r, type(e).__name__, str(e)[:80]))
            try:
                torch.cuda.synchronize()
            except Exception as e2:  # noqa: BLE001
                failures.append((r, "sync", str(e2)[:80]))
                return failures, bad_values
        finally:
            loader_module.torch.cuda.Stream = real
        cache.release()
    return failures, bad_values


def main() -> int:
    print("loader's own stream:", rounds(20, False), flush=True)
    print("forced onto the capture stream:", rounds(20, True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
