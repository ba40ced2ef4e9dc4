"""Time the SER trainers' train step of one checkout of the port, for a
before/after comparison on one card.

    python3 tools/ser_step_ab.py <checkout root>

Imports ``nrse_tpu_torch`` from ``<checkout root>`` (its kernels built
under that root's ``build/``), makes WavLM-large + ASP + trunks of 1024
with seeded random weights, and takes the ``dim_ft`` preset's step (``task
both``, 36 clips of 5 s, every dropout, LayerDrop and SpecAugment on) in
three freeze states: the encoder frozen, its top 12 layers unfrozen, the
whole encoder.  In each, 2 warm-up steps, then 3 repetitions of 5 steps
timed by the host clock up to a synchronize: the eager step, and the
captured one where the package has it (``make_emotion_train_step``'s
``graphs``).  Prints one ``[ab]`` line a form and state, then one JSON
line.  Run it in turns on the two checkouts in one call to the card, each
in its own process: parent, change, change, parent.
"""

import inspect
import json
import os
import sys
import time


def main(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    from nrse_tpu_torch.models.convert import init_emotion_state_dict
    from nrse_tpu_torch.models.emotion import EmotionClassifier
    from nrse_tpu_torch.models.wavlm import WavLMConfig
    from nrse_tpu_torch.train import emotion_trainer as et

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = WavLMConfig.large()
    model = EmotionClassifier(cfg, 1024, dropout=0.3, device="meta",
                              compute_dtype=torch.bfloat16)
    model.load_state_dict(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(15), 1024), strict=True,
        assign=True)
    state = et.create_emotion_state(model.to(dev), 0)
    rng = np.random.default_rng(15)
    n, t = 36, 80000
    x = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300, (n, 1))
                      * np.arange(t) / 16000)
         + 0.02 * rng.standard_normal((n, t))).astype(np.float32)
    mask = np.ones((n, t), np.float32)
    mask[::3, t // 2:], x[::3, t // 2:] = 0.0, 0.0
    batch = {"input_values": x, "attention_mask": mask,
             "C": rng.integers(0, 10, n).astype(np.int32)}
    for k in "AVD":
        batch[k] = rng.uniform(1, 7, n).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    weights = torch.linspace(0.5, 1.5, 8, device=dev)
    has_graphs = "graphs" in inspect.signature(
        et.make_emotion_train_step).parameters
    forms = ("eager", "captured") if has_graphs else ("eager",)
    out = {"root": root}
    for name, layers, rest, lr in (
            ("frozen", [], 0.0, 1e-4),
            ("top12", list(range(12, 24)), 0.0, 5e-6),
            ("whole", list(range(24)), 1.0, 5e-6)):
        for form in forms:
            kw = {"graphs": form == "captured"} if has_graphs else {}
            step = et.make_emotion_train_step("both", 1e-4, **kw)
            for _ in range(2):
                step(state, batch, weights, layers, lr, rest)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(5):
                    step(state, batch, weights, layers, lr, rest)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / 5)
            out[f"{name} {form}"] = times
            print(f"[ab] {root} {name} {form}: s/step "
                  + ", ".join(f"{s:.4f}" for s in times), flush=True)
            if has_graphs:
                state.graphs = None
    print("[ab]", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
