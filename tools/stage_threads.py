"""Time the SER step's host staging when ranks share the host's cores.

    python3 tools/stage_threads.py [--procs 4] [--threads 8] [--steps 20]

``emotion_trainer.StepInputs.stage`` draws one step's host inputs (the
seed table, LayerDrop's keep list, SpecAugment's spans and the trunks'
dropout masks at the global batch, K4's scalars) with small torch ops on
the CPU.  This runs it at WavLM-large's shapes (36 × 5 s a rank, the
classifier's trunks of 1024, rank 1 of a ``{data: procs}`` mesh, the
model on the ``meta`` device) in ``procs`` processes at once, each with
``threads`` torch threads, and prints each process's seconds a step.
No card is needed.
"""

import argparse
import multiprocessing as mp
import os
import sys
import time


def _run(procs: int, threads: int, steps: int, out) -> None:
    import torch

    from nrse_tpu_torch.models.emotion import EmotionClassifier
    from nrse_tpu_torch.models.wavlm import WavLMConfig
    from nrse_tpu_torch.parallel.mesh import DataMesh
    from nrse_tpu_torch.train import emotion_trainer as et

    torch.set_num_threads(threads)
    model = EmotionClassifier(WavLMConfig.large(), 1024, dropout=0.3,
                              device="meta")
    flat = torch.zeros(8)
    state = et.EmotionTrainState(model=model, params=flat, grads=flat,
                                 mu=flat, nu=flat, starts=(0,) * 26)
    state.mesh = DataMesh(world=procs, rank=min(1, procs - 1),
                          device=torch.device("cpu"), distributed=True)
    inputs = et.StepInputs(model, 36, 80000, "cpu")
    spec = et.adamw_spec(1e-4)
    t0 = time.perf_counter()
    for i in range(steps):
        state.step = i
        inputs.stage(state, "both", spec)
    out.put((time.perf_counter() - t0) / steps)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--procs", type=int, default=4)
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    ps = [ctx.Process(target=_run, args=(args.procs, args.threads,
                                         args.steps, out))
          for _ in range(args.procs)]
    for p in ps:
        p.start()
    times = sorted(out.get() for _ in ps)
    for p in ps:
        p.join()
    print(f"[stage] {args.procs} processes x {args.threads} threads on "
          f"{os.cpu_count()} cores: s a step " +
          ", ".join(f"{t:.4f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
