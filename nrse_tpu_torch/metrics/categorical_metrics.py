"""Offline categorical SER scorer.

Port of ``nrse_tpu/metrics/categorical_metrics.py:61-178`` (capability
parity with the reference's ``src/metrics/categorical_metrics.py:
23-256``) on the ``csv`` module and numpy: score a predictions CSV against
``labels_consensus.csv`` — find the file-name and prediction columns,
strip ``_snrN_...`` suffixes to match augmented names to their utterance,
drop X/O, optionally keep one split; write accuracy, macro-F1 and
weighted-F1 (over the classes present, ``zero_division=0``),
``class_report.csv``, ``class_distribution.csv`` and ``metrics.txt``, and
the confusion-matrix and per-class-F1 plots where matplotlib and seaborn
import.

    python -m nrse_tpu_torch.metrics.categorical_metrics \\
        --predictions preds.csv --ground_truth labels_consensus.csv \\
        --output_dir out/ [--split Test2]
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from nrse_tpu_torch.eval.metrics import (
    accuracy,
    classification_report,
    confusion_matrix,
    f1_scores,
)
from nrse_tpu_torch.labels.parsing import VALID_EMOTIONS_MAP, clean_filename
from nrse_tpu_torch.utils.logging_utils import logger

FILENAME_COLUMNS = ["file_name", "Filename", "FileName", "filename"]
PREDICTION_COLUMNS = ["prediction", "Prediction", "pred", "predicted_class",
                      "EmoClass"]


def _read_csv(path: str):
    """``(rows as dicts, column names)``."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        return rows, list(reader.fieldnames or [])


def _detect_column(columns: List[str], candidates, kind: str) -> str:
    for c in candidates:
        if c in columns:
            return c
    raise ValueError(
        f"could not find a {kind} column in predictions; "
        f"looked for {candidates}, got {columns}"
    )


def _normalize_prediction(value) -> Optional[str]:
    """Letter code, class name, or class index → letter code."""
    names_to_code = {
        "anger": "A", "happiness": "H", "sadness": "S", "fear": "F",
        "surprise": "U", "disgust": "D", "contempt": "C", "neutral": "N",
    }
    s = str(value).strip()
    if s in VALID_EMOTIONS_MAP:
        return s
    if s.lower() in names_to_code:
        return names_to_code[s.lower()]
    try:
        idx = int(float(s))
    except ValueError:
        return None
    inv = {v: k for k, v in VALID_EMOTIONS_MAP.items()}
    return inv.get(idx)


def _plots(cm, class_names, f1s, output_dir: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError as e:
        logger.info(f"confusion-matrix and per-class F1 plots skipped: {e}")
        return
    plt.figure(figsize=(10, 8))
    sns.heatmap(cm, annot=True, fmt="d", cmap="Blues",
                xticklabels=class_names, yticklabels=class_names)
    plt.xlabel("Predicted")
    plt.ylabel("True")
    plt.title("Confusion Matrix")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "confusion_matrix.png"))
    plt.close()

    plt.figure(figsize=(10, 5))
    plt.bar(class_names, f1s)
    plt.ylabel("F1")
    plt.title("Per-class F1")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "per_class_f1.png"))
    plt.close()


def score_predictions(predictions_csv: str, ground_truth_csv: str,
                      output_dir: str, split: Optional[str] = None) -> Dict:
    """Score, write the reports into ``output_dir`` and return
    ``{"accuracy", "macro_f1", "weighted_f1", "n_scored"}``."""
    os.makedirs(output_dir, exist_ok=True)
    preds, pred_columns = _read_csv(predictions_csv)
    gt, gt_columns = _read_csv(ground_truth_csv)

    if split:
        if "Split_Set" in gt_columns:
            gt = [r for r in gt if r["Split_Set"] == split]
        else:
            print("Warning: 'Split_Set' column not found in ground truth. "
                  "Cannot filter by split.")

    # keep valid 8-class ground truth only (X/O filtered)
    gt_map = {r["FileName"]: r["EmoClass"] for r in gt
              if r["EmoClass"] in VALID_EMOTIONS_MAP}

    fname_col = _detect_column(pred_columns, FILENAME_COLUMNS, "filename")
    pred_col = _detect_column(pred_columns, PREDICTION_COLUMNS, "prediction")

    y_true, y_pred, missing = [], [], 0
    for row in preds:
        label = gt_map.get(clean_filename(str(row[fname_col])))
        pred = _normalize_prediction(row[pred_col])
        if label is None or pred is None:
            missing += 1
            continue
        y_true.append(VALID_EMOTIONS_MAP[label])
        y_pred.append(VALID_EMOTIONS_MAP[pred])
    if missing:
        print(f"Skipped {missing} predictions without ground truth / "
              "valid class")
    if not y_true:
        raise ValueError("no overlapping (prediction, ground-truth) pairs")

    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    # the classes present (scikit-learn's default: macro-F1 is not diluted
    # by classes absent from this list)
    present = sorted(set(y_true.tolist()) | set(y_pred.tolist()))
    all_names = list(VALID_EMOTIONS_MAP.keys())
    class_names = [all_names[i] for i in present]
    f1 = f1_scores(y_true, y_pred, present)
    metrics = {
        "accuracy": accuracy(y_true, y_pred),
        "macro_f1": f1["macro"],
        "weighted_f1": f1["weighted"],
        "n_scored": int(len(y_true)),
    }

    report = classification_report(y_true, y_pred, present, class_names)
    fields = ["precision", "recall", "f1-score", "support"]
    with open(os.path.join(output_dir, "class_report.csv"), "w",
              newline="") as f:
        writer = csv.writer(f)
        writer.writerow([""] + fields)
        for name, entry in report.items():
            values = [entry] * len(fields) if not isinstance(entry, dict) \
                else [entry[k] for k in fields]
            writer.writerow([name] + [repr(float(v)) for v in values])

    with open(os.path.join(output_dir, "class_distribution.csv"), "w",
              newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["", "count"])
        for idx, count in sorted(Counter(y_true.tolist()).items()):
            writer.writerow([all_names[idx], count])

    cm = confusion_matrix(y_true, y_pred, present)
    _plots(cm, class_names, [report[n]["f1-score"] for n in class_names],
           output_dir)

    with open(os.path.join(output_dir, "metrics.txt"), "w") as f:
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")
    print(f"accuracy={metrics['accuracy']:.4f} "
          f"macro_f1={metrics['macro_f1']:.4f} "
          f"weighted_f1={metrics['weighted_f1']:.4f} "
          f"(n={metrics['n_scored']})")
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description="Score SER predictions")
    parser.add_argument("--predictions", required=True)
    parser.add_argument("--ground_truth", required=True)
    parser.add_argument("--output_dir", default="metrics_out")
    parser.add_argument("--split", default=None)
    args = parser.parse_args(argv)
    return score_predictions(args.predictions, args.ground_truth,
                             args.output_dir, args.split)


if __name__ == "__main__":
    main()
