"""BYOL convergence evidence on the port (synthetic corpus, one card).

Counterpart of ``tools/convergence_report.py``.  The reference's only
convergence record is a pasted training log (dev.ipynb cell 37: val loss
0.2439 / clean-noisy cosine similarity 0.9934 by epoch 4-5 on 151k
files).  MSP-Podcast and AudioSet are not available, so this reproduces
the trajectory's shape on a generated speech-like corpus
(``nrse_tpu_torch/data/synthetic.py``) through the port's
``train_byol.main``: host decode → SNR mixing → the train step from
captured graphs → validation with per-SNR similarity, WavLM-large at full
width.  It writes the per-epoch CSV, a table (``README.md``) and, where
matplotlib imports, the curves, under ``--out``.

Beside each per-SNR similarity (the port's mean, in float64, of its
per-sample similarities) the CSV holds, as ``..._jax_bf16``, the reading
JAX's arithmetic gives for the same per-sample similarities: each rounded
to bfloat16, then numpy's bfloat16 mean (``report_utils.
bf16_numpy_mean``), which is how JAX's ``validate_model`` reads the bf16
similarities of its eval step on the TPU.  That column, not the mean, is
the one to set beside ``docs/convergence/convergence.csv``.

    python3 tools/port_convergence_report.py [--files 6000] [--epochs 8] \\
        [--batch 36] [--out docs/port_convergence] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nrse_tpu_torch.utils import report_utils  # noqa: E402

COLUMNS = ("epoch", "train_loss", "val_loss", "val_avg_similarity",
           "audio_sec_per_sec_per_chip", "s_per_step")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--files", type=int, default=6000)
    p.add_argument("--noise-files", type=int, default=600)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch", type=int, default=36)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default="docs/port_convergence")
    p.add_argument("--corpus", default=os.path.join(ROOT, "build",
                                                    "port_conv_corpus"))
    return p.parse_args(argv)


def records_of(epochs) -> list:
    """The epoch records of ``train_byol.main`` as the CSV's rows: the
    columns, then ``val_similarity_snr_<snr>`` by SNR and, where an
    epoch's record holds its validation's per-sample values
    (``val_samples``), ``val_similarity_snr_<snr>_jax_bf16``."""
    rows = []
    for e in epochs:
        row = {k: e[k] for k in COLUMNS}
        row.update({f"val_similarity_snr_{snr}": sim
                    for snr, sim in e["val_similarities"].items()})
        samples = e.get("val_samples")
        if samples is not None:
            sims, snrs = samples["similarity"], samples["snr"]
            row.update({f"val_similarity_snr_{snr}_jax_bf16":
                        report_utils.bf16_numpy_mean(sims[snrs == float(snr)])
                        for snr in e["val_similarities"]})
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    args = parse_args(argv)
    from nrse_tpu_torch.data.synthetic import generate_corpus

    t0 = time.perf_counter()
    clean_dir, noise_dir = generate_corpus(
        args.corpus, args.files, args.noise_files, args.seconds)
    config = report_utils.load_preset("default_wavlm-large_byol.yaml")
    config["training"].update({
        "batch_size": args.batch,
        "num_epochs": args.epochs,
        "learning_rate": args.lr,
        "checkpoint_dir": os.path.join(args.corpus, "ckpt"),
        "log_dir": os.path.join(args.corpus, "logs"),
        "save_checkpoints": False,
        "early_stopping_patience": args.epochs,  # the whole trajectory
    })
    config["data"].update({
        "clean_data_path": clean_dir,
        "noise_data_path": noise_dir,
        "max_audio_length": args.seconds,
    })
    config["logging"].update({
        "wandb_mode": "disabled",
        "console_level": "WARNING",
        "visualization_interval": max(args.epochs, 2),  # final-epoch t-SNE
    })
    config["device"] = args.device
    from nrse_tpu_torch import train_byol

    out = train_byol.main(config)
    captured = out["state"].graphs is not None
    records = records_of(out["epochs"])
    del out
    report_utils.free_card()
    if not records:
        raise RuntimeError("train_byol.main ran no epoch")
    total = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    snr_keys = sorted((k for k in records[0]
                       if k.startswith("val_similarity_snr_")
                       and not k.endswith("_jax_bf16")),
                      key=lambda k: float(k.rsplit("_", 1)[1]))
    cols = list(COLUMNS) + [c for k in snr_keys
                            for c in (k, f"{k}_jax_bf16")]
    with open(os.path.join(args.out, "convergence.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for r in records:
            f.write(",".join(f"{r.get(c, '')}" for c in cols) + "\n")
    plotted = plot(records, snr_keys, os.path.join(args.out,
                                                    "convergence.png"))
    card = report_utils.card_line()
    first, last = records[0], records[-1]
    table = "\n".join(
        f"| epoch {r['epoch'] + 1} | {r['train_loss']:.4f} | "
        f"{r['val_loss']:.4f} | {r['val_avg_similarity']:.4f} | "
        f"{r['s_per_step']:.4f} |" for r in records)
    snrs, nan = [k.rsplit("_", 1)[1] for k in snr_keys], float("nan")
    per_snr = "\n".join(
        f"| epoch {r['epoch'] + 1} | " + " | ".join(
            f"{r.get(k, nan):.4f} / {r.get(k + '_jax_bf16', nan):.4f}"
            for k in snr_keys)
        + " |" for r in (first, last))
    with open(os.path.join(args.out, "README.md"), "w") as f:
        f.write(f"""# BYOL convergence evidence on the port (synthetic corpus, one card)

Generated by `python3 tools/port_convergence_report.py --files \
{args.files} --epochs {args.epochs} --batch {args.batch}` on {card}
(WavLM-large, the train step {'from captured graphs' if captured else
'eager'}), {total:.0f} s in all, the corpus's generation included.

The reference's convergence record is a pasted log (dev.ipynb cell 37:
val loss 0.2439, clean-noisy similarity 0.9934 on 151k MSP-Podcast files).
That corpus is not available, so this run takes a generated speech-like
corpus ({args.files} clean + {args.noise_files} noise files,
`nrse_tpu_torch/data/synthetic.py`) through the port's whole pipeline:
`train_byol.main` → host WAV decode → SNR mixing on the card → the train
step (both towers, backward, AdamW + EMA) → validation with per-SNR
similarity.

| metric | epoch 1 | epoch {last['epoch'] + 1} |
|---|---|---|
| train loss | {first['train_loss']:.4f} | {last['train_loss']:.4f} |
| val loss | {first['val_loss']:.4f} | {last['val_loss']:.4f} |
| val avg clean↔noisy similarity | {first['val_avg_similarity']:.4f} | \
{last['val_avg_similarity']:.4f} |
| data-fed s/step (host clock, decode included) | \
{first['s_per_step']:.4f} | {last['s_per_step']:.4f} |

| epoch | train loss | val loss | val similarity | s/step |
|---|---|---|---|---|
{table}

Per SNR, the port's float64 mean of its per-sample similarities / the
reading of JAX's arithmetic (bfloat16 values, numpy's bfloat16 mean, as
JAX's `validate_model` reads them on the TPU).  The TPU run's similarities
in `docs/convergence/` are such bf16-accumulated readings, not means: set
them beside the second figure.

| epoch | {' | '.join(f'{s} dB' for s in snrs)} |
|---|{'---|' * len(snrs)}
{per_snr}

Per-epoch data: [convergence.csv](convergence.csv)\
{'; curves: ![convergence](convergence.png)' if plotted else
 ' (no plot: matplotlib is not installed where this ran)'}
""")
    summary = {"records": len(records), "final_val_loss": last["val_loss"],
               "final_similarity": last["val_avg_similarity"],
               "captured": captured, "seconds": total,
               "artifact": args.out}
    print(json.dumps(summary), flush=True)
    return summary


def plot(records, snr_keys, path: str) -> bool:
    """The loss and similarity curves, where matplotlib imports."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    epochs = [r["epoch"] + 1 for r in records]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.plot(epochs, [r["train_loss"] for r in records], "-o",
             label="train loss")
    ax1.plot(epochs, [r["val_loss"] for r in records], "-s",
             label="val loss")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("BYOL loss (2 − 2·cos)")
    ax1.legend()
    ax1.grid(alpha=0.3)
    for k in snr_keys:
        ax2.plot(epochs, [r.get(k, float("nan")) for r in records], "-o",
                 label=f"SNR {k.rsplit('_', 1)[1]} dB")
    ax2.plot(epochs, [r["val_avg_similarity"] for r in records], "-k",
             lw=2, label="mean")
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("clean↔noisy cosine similarity")
    ax2.legend(fontsize=8)
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


if __name__ == "__main__":
    main()
