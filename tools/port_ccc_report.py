"""Dimensional SER (CCC) evidence on the port (synthetic corpus, one card).

Counterpart of ``tools/ccc_report.py``.  The reference records no
dimensional CCC numbers; the JAX report made the rebuild's own on the
synthetic emotion corpus, whose A/V/D labels follow the acoustic regimes
(``nrse_tpu_torch.data.synthetic.EMOTION_REGIMES`` plus per-file jitter),
so a CCC well above 0 shows that the dimensional pipeline learns:
consensus-CSV A/V/D parsing → ``EmotionClassifier``'s dimensional branch
→ CCC loss → per-dimension CCC → scatter plots (where matplotlib
imports).  WavLM-large at full width from seeded random weights, the
encoder frozen.  Writes ``CCC.md`` under ``--out``.

    python3 tools/port_ccc_report.py [--train 2400] [--dev 480] \\
        [--epochs 10] [--out docs/port_ser_evidence] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nrse_tpu_torch.utils import report_utils  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", type=int, default=2400)
    p.add_argument("--dev", type=int, default=480)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default="docs/port_ser_evidence")
    p.add_argument("--corpus", default=os.path.join(ROOT, "build",
                                                    "port_ser_corpus"))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from nrse_tpu_torch.data.synthetic import generate_emotion_corpus

    t0 = time.perf_counter()
    audio_dir, labels_csv = generate_emotion_corpus(
        args.corpus, args.train, args.dev)
    log_dir = os.path.join(args.corpus, "ccc_logs")
    config = report_utils.emotion_config(
        "dev_wavlm-large_emotion_dim.yaml", args, labels_csv, audio_dir,
        os.path.join(args.corpus, "ccc_ckpt"), log_dir, categorical=False)
    info = report_utils.train_ser(config, "dimensional")
    total = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    scatter = []
    for path in sorted(glob.glob(os.path.join(log_dir, "val_scatter_*.png"))):
        name = os.path.basename(path)
        shutil.copy(path, os.path.join(args.out, name))
        scatter.append(f"![{name}]({name})")
    best_ccc = info["best"]
    with open(os.path.join(args.out, "CCC.md"), "w") as f:
        f.write(f"""# Dimensional SER (CCC) evidence on the port (synthetic corpus, one card)

Generated by `python3 tools/port_ccc_report.py --train {args.train} --dev \
{args.dev} --epochs {args.epochs}` on {report_utils.card_line()}
(WavLM-large, the train step {'from captured graphs' if info['captured']
else 'eager'}), {total:.0f} s in all, the corpus's generation included.

The reference repo records no dimensional CCC numbers, so this is the
rebuild's own generated reference, on the port.  Corpus: the same
8-regime synthetic emotion corpus as the categorical run; the A/V/D
targets derive from each regime (plus per-file jitter), so they are
predictable from the waveform.  The run takes the port's dimensional
pipeline end to end on the card with a frozen randomly-initialised
encoder (phase 1): CCC loss, per-dimension CCC, ReduceLROnPlateau on
the mean CCC.

**Best dev mean CCC (arousal/valence/dominance): {best_ccc:.3f}**
(an unskilled constant predictor scores 0.0).

| phase | epoch | train loss | val loss | mean CCC | data-fed s/step |
|---|---|---|---|---|---|
{report_utils.epochs_table(info['epochs'], 'ccc')}

{chr(10).join(scatter) if scatter else
 '(No scatter plots: matplotlib is not installed where this ran.)'}

Like the categorical number, this is pipeline-learning evidence, not a
benchmark claim: no pretrained weights or real speech are available.
""")
    summary = {"best_ccc": best_ccc, "captured": info["captured"],
               "seconds": total, "artifact": args.out}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
