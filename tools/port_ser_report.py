"""Categorical SER evidence on the port (synthetic labelled corpus, one card).

Counterpart of ``tools/ser_report.py``.  The reference's downstream
numbers (macro-F1 0.260 on MSP-Podcast test2, dev.ipynb cell 52) need the
real dataset, which is not available.  This takes
``nrse_tpu_torch.data.synthetic.generate_emotion_corpus`` (8 emotion
classes realised as distinct acoustic regimes: pitch level and slope, AM
rate, formant shift, roughness) through the port's categorical trainer,
WavLM-large at full width from seeded random weights with the encoder
frozen (phase 1; ``--unfreeze`` adds phase 2): consensus-CSV parsing →
masked loading → ``EmotionClassifier`` (encoder + ASP) → weighted masked
CE → macro-F1 → confusion matrix.  A macro-F1 far above chance (0.125)
shows that the pipeline learns.  Writes ``README.md`` (and the confusion
matrix where matplotlib and seaborn import) under ``--out``.

    python3 tools/port_ser_report.py [--train 2400] [--dev 480] \\
        [--epochs 6] [--out docs/port_ser_evidence] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--unfreeze", action="store_true",
                   help="run phase 2 (gradual encoder unfreeze) as well")
    p.add_argument("--ft-lr", type=float, default=1e-4)
    p.add_argument("--ft-epochs", type=int, default=6)
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
    log_dir = os.path.join(args.corpus, "ser_logs")
    config = report_utils.emotion_config(
        "dev_wavlm-large_emotion_cat.yaml", args, labels_csv, audio_dir,
        os.path.join(args.corpus, "ser_ckpt"), log_dir, categorical=True)
    info = report_utils.train_ser(config, "categorical")
    total = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    cm_src = os.path.join(log_dir, "val_confusion_matrix.png")
    plotted = os.path.exists(cm_src)
    if plotted:
        shutil.copy(cm_src, os.path.join(args.out, "confusion_matrix.png"))
    best_f1 = info["best"]
    with open(os.path.join(args.out, "README.md"), "w") as f:
        f.write(f"""# Categorical SER evidence on the port (synthetic labelled corpus, one card)

Generated by `python3 tools/port_ser_report.py --train {args.train} --dev \
{args.dev} --epochs {args.epochs}` on {report_utils.card_line()}
(WavLM-large, the train step {'from captured graphs' if info['captured']
else 'eager'}), {total:.0f} s in all, the corpus's generation included.

MSP-Podcast is not available, so the corpus is
`nrse_tpu_torch.data.synthetic.generate_emotion_corpus`: {args.train}+\
{args.dev} utterances over the 8 MSP emotion codes, each class a distinct
acoustic regime (pitch level/slope, syllabic rate, formant shift,
roughness).  The run takes the port's categorical SER pipeline end to
end on the card: `labels_consensus.csv` parsing → masked audio loading →
`EmotionClassifier` (frozen WavLM encoder + ASP pooling, phase 1 of the
reference's 2-phase schedule{", then phase-2 gradual top-down encoder"
" unfreezing" if args.unfreeze else ""}) → class-weighted masked CE →
macro-F1 selection → confusion matrix.

**Best dev macro-F1: {best_f1:.3f}** (chance level for 8 classes: 0.125).

| phase | epoch | train loss | val loss | macro-F1 | data-fed s/step |
|---|---|---|---|---|---|
{report_utils.epochs_table(info['epochs'], 'f1')}

{'![confusion matrix](confusion_matrix.png)' if plotted else
 '(No confusion-matrix plot: matplotlib or seaborn is not installed '
 'where this ran.)'}

This is pipeline-learning evidence, not a benchmark claim: the encoder is
randomly initialised (no BYOL checkpoint, no real speech), so the number
is not comparable to the reference's MSP-Podcast F1 (0.260, dev.ipynb
cell 52).
""")
    summary = {"best_f1": best_f1, "captured": info["captured"],
               "seconds": total, "artifact": args.out}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
