"""The model axis against one process, beside the one-process step's own
spread: the bound of ``tests/test_torch_tp_byol.py::
test_random_features_match_one_process`` over several seeded starts.

    python3 tools/tp_heads_spread.py [--draws 0 1 2 3 4 5]

For each draw (``init_byol_state_dict`` seeded with it, biases by
``with_random_biases``), tiny BYOL with dropout, LayerDrop and
SpecAugment on, the test's batch, one step on the CPU:

- the port's step in one process (the reference);
- again with the pooled embeddings entering both towers' projectors one
  float32 ulp off, by four draws of random signs (``heads``: the test's
  spread), and with the batch's waveforms one ulp up and down
  (``input``);
- the step at ``{data: 1, model: 2}`` (two gloo ranks: the gap).

Prints, a draw, the largest gradient gap and spread (each over its
tensor's largest value, but the gradients that are 0 in exact
arithmetic) and the largest ratio of gap to each spread over the
tensors, then a JSON summary.  The test module it takes its harness
from imports the JAX package; the CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def first_grads(tp, cfg, sd, batch, signs=None):
    """The one-process step's first gradients (``model: 1`` layout)."""
    return tp._one_process(cfg, sd, batch, 1, signs)[2]


def measure(draw: int) -> dict:
    import numpy as np
    import torch

    import test_torch_tp_byol as tp
    import torch_dp_workers as dp_workers
    from nrse_tpu_torch.models.convert import init_byol_state_dict
    from nrse_tpu_torch.models.wavlm import WavLMConfig
    from nrse_tpu_torch.parallel.launch import run_ranks
    from torch_init import with_random_biases

    cfg = WavLMConfig.tiny()
    sd = with_random_biases(init_byol_state_dict(
        cfg, tp.PROJ, tp.PRED, torch.Generator().manual_seed(draw)), draw)
    batch = tp._dp_batch()
    ref = first_grads(tp, cfg, sd, batch)
    heads = [first_grads(tp, cfg, sd, batch, s) for s in range(4)]
    inputs = [first_grads(tp, cfg, sd, dict(batch, **{
        k: np.nextafter(batch[k], np.float32(d)) for k in ("clean",
                                                           "noise")}))
              for d in (np.inf, -np.inf)]
    ranks = run_ranks(dp_workers.byol_steps, 2, (
        {}, {k: v.numpy() for k, v in sd.items()}, None, batch, tp.PROJ,
        tp.PRED, tp.OPT, 1, 2))
    out = {"gap": 0.0, "heads": 0.0, "input": 0.0,
           "gap_over_heads": 0.0, "gap_over_input": 0.0}
    for k, g in ref.items():
        if k.endswith(tp.ZERO_GRADS):
            continue
        gap = max(tp._rel(r["grads"][k], g) for r in ranks)
        spread = {way: max(tp._rel(n[k], g) for n in runs)
                  for way, runs in (("heads", heads), ("input", inputs))}
        out["gap"] = max(out["gap"], gap)
        for way, s in spread.items():
            out[way] = max(out[way], s)
            out[f"gap_over_{way}"] = max(out[f"gap_over_{way}"],
                                         gap / max(s, 1e-30))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draws", type=int, nargs="+", default=list(range(6)))
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    summary = {}
    for draw in args.draws:
        summary[draw] = m = measure(draw)
        print(f"draw {draw}: gap {m['gap']:.3e}, spread heads "
              f"{m['heads']:.3e} input {m['input']:.3e}; gap / spread at "
              f"most {m['gap_over_heads']:.2f} (heads), "
              f"{m['gap_over_input']:.2f} (input)", flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
