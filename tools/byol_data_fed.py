"""Time BYOL pretraining fed by its data loader at full depth, with the
train step replayed from captured CUDA graphs and dispatched eagerly.

    python3 tools/byol_data_fed.py [--clips N] [--epochs N] [--runs N]

Writes a synthetic corpus (``data/synthetic.py::generate_corpus``: N
speech-like clean clips of 5 s ± 20 %, N / 10 noise clips; 2200 by
default, 55 train steps an epoch) into a temporary directory under
``build/``, then runs
``nrse_tpu_torch.train_byol.main`` on one card at WavLM-large's full width
and depth (24 layers, projection 1024, prediction 2048, seeded weights),
batch 36 × 5 s, the preset's hyper-parameters, no checkpoints, in turns:
captured, eager (``training.cuda_graphs: false``), eager, captured, each
run in this process.  Each run's first step holds the capture.  Prints
the card, one ``[data-fed]`` line per run and epoch, then one JSON line.
Each epoch gives two figures by the host clock: its mean s/step over all
its train steps, loading and the readers' start included (what
``train_byol.main`` reports), and its steady s/step, from the return of
its ``SKIP``-th train step to that of its last (the step returns when
its work is queued; ``Staging`` keeps the host within a step of the
card, so over tens of steps the rate of returns is the card's).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an epoch's first steps, left out of its steady s/step: the capture (the
# first step of a run), the readers' and the prefetcher's start
SKIP = 5


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clips", type=int, default=2200)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--runs", type=int, default=4)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from nrse_tpu_torch import train_byol
    from nrse_tpu_torch.data.synthetic import generate_corpus
    from nrse_tpu_torch.runtime import cuda_build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[data-fed] card: {card}", flush=True)
    # each train step's return time, by the host clock
    returns = []
    make_step = train_byol.make_byol_train_step

    def timed_step(*step_args, **step_kwargs):
        step = make_step(*step_args, **step_kwargs)

        def run(state, batch):
            out = step(state, batch)
            returns.append(time.perf_counter())
            return out
        return run

    train_byol.make_byol_train_step = timed_step
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="data_fed_", dir=cuda_build.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        clean, noise = generate_corpus(root, args.clips,
                                       max(1, args.clips // 10), 5.0,
                                       verbose=False)
        print(f"[data-fed] corpus of {args.clips} clean + "
              f"{max(1, args.clips // 10)} noise clips written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        config = {
            "model": {"name": "microsoft/wavlm-large",
                      "projection_dim": 1024, "prediction_dim": 2048,
                      "ema_decay": 0.997},
            "training": {"batch_size": 36, "num_workers": 8,
                         "num_epochs": args.epochs, "learning_rate": 1e-5,
                         "weight_decay": 1e-5, "seed": 0,
                         "save_checkpoints": False,
                         "checkpoint_dir": os.path.join(root, "ckpt"),
                         "log_dir": os.path.join(root, "logs")},
            "data": {"clean_data_path": clean, "noise_data_path": noise,
                     "sample_rate": 16000, "max_audio_length": 5.0,
                     "snr_range": [0, 5, 10, 15, 20],
                     "validation_ratio": 0.09},
            "logging": {"visualization_interval": 10 ** 9},
            "device": "cuda",
        }
        forms = ("captured", "eager", "eager", "captured")
        results = []
        for form in forms[:args.runs]:
            run = dict(config, training=dict(
                config["training"], cuda_graphs=form == "captured"))
            t0 = time.perf_counter()
            returns.clear()
            out = train_byol.main(run)
            wall = time.perf_counter() - t0
            graphs = out["state"].graphs
            epochs, first = [], 0
            for e in out["epochs"]:
                e = {k: e[k] for k in ("epoch", "steps", "s_per_step",
                                       "audio_sec_per_sec", "train_loss")}
                last = first + e["steps"] - 1
                e["steady_s_per_step"] = (
                    (returns[last] - returns[first + SKIP - 1])
                    / (e["steps"] - SKIP)
                    if e["steps"] > SKIP else None)
                first = last + 1
                epochs.append(e)
                steady = e["steady_s_per_step"]
                print(f"[data-fed] {form}: epoch {e['epoch']}, "
                      f"{e['steps']} steps at {e['s_per_step']:.4f} s/step "
                      f"({e['audio_sec_per_sec']:.1f} audio-sec/sec), "
                      f"steady after {SKIP} steps "
                      f"{steady if steady is None else f'{steady:.4f}'} "
                      f"s/step, train loss {e['train_loss']:.6f}",
                      flush=True)
            results.append({
                "form": form, "epochs": epochs, "run_s": wall,
                "graphs": len(graphs.graphs) if graphs else 0,
                "capture_s": graphs.capture_s if graphs else None})
            del out, graphs
            torch.cuda.empty_cache()
        print(json.dumps({"card": card, "clips": args.clips,
                          "skip": SKIP, "runs": results}), flush=True)
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
