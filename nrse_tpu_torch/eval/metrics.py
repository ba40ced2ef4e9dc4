"""Classification metrics in numpy.

What the JAX package takes from scikit-learn, written out because the
card's machine has no scikit-learn, with its semantics and
``zero_division=0``:

  * :func:`classification_metrics` — the evaluator's
    (``nrse_tpu/baseline/eval_cat_ser.py:234-252``): F1 micro and macro,
    precision and recall macro over the labels that occur in either the
    targets or the predictions, as ``average="macro"`` takes them;
  * :func:`accuracy`, :func:`f1_scores` (macro and weighted over given
    labels), :func:`confusion_matrix` and :func:`classification_report`
    (``output_dict=True``) — the SER trainers' and the offline scorer's
    (``nrse_tpu/train/categorical_emotions.py:108-141``,
    ``nrse_tpu/metrics/categorical_metrics.py:114-134``);
    :func:`macro_f1_from_confusion` and :func:`report_from_confusion`, the same
    from a confusion matrix, which ranks can pool.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den`` with 0 where ``den`` is 0 (``zero_division=0``)."""
    out = np.zeros(num.shape, np.float64)
    np.divide(num, den, out=out, where=den > 0)
    return out


def _mean(x: np.ndarray) -> float:
    return float(x.mean()) if x.size else 0.0


def _labels(y_true, y_pred):
    y_true = np.asarray(y_true, np.int64).ravel()
    y_pred = np.asarray(y_pred, np.int64).ravel()
    if y_true.shape != y_pred.shape:
        raise ValueError(f"{y_true.shape} targets against {y_pred.shape} "
                         "predictions")
    return y_true, y_pred


def _counts(y_true, y_pred, labels):
    """``(tp, fp, fn)`` per label, float64."""
    def count(cond):
        return np.array([np.sum(cond(c)) for c in labels], np.float64)
    return (count(lambda c: (y_true == c) & (y_pred == c)),
            count(lambda c: (y_true != c) & (y_pred == c)),
            count(lambda c: (y_true == c) & (y_pred != c)))


def classification_metrics(y_true, y_pred) -> Dict[str, float]:
    """``f1_micro``, ``f1_macro``, ``precision_macro`` and ``recall_macro``
    of integer labels ``y_true`` against predictions ``y_pred``."""
    y_true, y_pred = _labels(y_true, y_pred)
    labels = np.union1d(y_true, y_pred)
    tp, fp, fn = _counts(y_true, y_pred, labels)
    precision = _ratio(tp, tp + fp)
    recall = _ratio(tp, tp + fn)
    f1 = _ratio(2 * tp, 2 * tp + fp + fn)
    micro = _ratio(2 * tp.sum(keepdims=True),
                   (2 * tp + fp + fn).sum(keepdims=True))[0]
    return {"f1_micro": float(micro), "f1_macro": _mean(f1),
            "precision_macro": _mean(precision),
            "recall_macro": _mean(recall)}


def accuracy(y_true, y_pred) -> float:
    """The share of predictions equal to their target (0 for none)."""
    y_true, y_pred = _labels(y_true, y_pred)
    return float(np.mean(y_true == y_pred)) if y_true.size else 0.0


def f1_scores(y_true, y_pred, labels: Optional[Sequence[int]] = None
              ) -> Dict[str, float]:
    """``macro`` and ``weighted`` (by support) F1 over ``labels`` (default:
    those in either array)."""
    y_true, y_pred = _labels(y_true, y_pred)
    if labels is None:
        labels = np.union1d(y_true, y_pred)
    tp, fp, fn = _counts(y_true, y_pred, labels)
    f1 = _ratio(2 * tp, 2 * tp + fp + fn)
    support = tp + fn
    weighted = float(_ratio((f1 * support).sum(keepdims=True),
                            support.sum(keepdims=True))[0])
    return {"macro": _mean(f1), "weighted": weighted}


def confusion_matrix(y_true, y_pred, labels: Sequence[int]) -> np.ndarray:
    """``[K, K]`` int64 counts, row = target, column = prediction, over
    ``labels`` (pairs with another label are left out)."""
    y_true, y_pred = _labels(y_true, y_pred)
    index = {int(c): i for i, c in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def _confusion_counts(cm: np.ndarray):
    """``(tp, fp, fn)`` per class of a ``[K, K]`` confusion matrix (row =
    target, column = prediction), float64."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    return tp, cm.sum(0) - tp, cm.sum(1) - tp


def macro_f1_from_confusion(cm: np.ndarray) -> float:
    """:func:`f1_scores`' macro F1 of the pairs a confusion matrix counts,
    over the classes that occur as a target or a prediction."""
    tp, fp, fn = _confusion_counts(cm)
    present = (tp + fp + fn) > 0
    tp, fp, fn = tp[present], fp[present], fn[present]
    return _mean(_ratio(2 * tp, 2 * tp + fp + fn))


def report_from_confusion(cm: np.ndarray,
                          target_names: Sequence[str]) -> Dict:
    """:func:`classification_report` of the pairs a confusion matrix over
    every label counts (so ``accuracy``, never ``micro avg``)."""
    return _report(*_confusion_counts(cm), target_names, True)


def classification_report(y_true, y_pred, labels: Sequence[int],
                          target_names: Sequence[str]) -> Dict:
    """scikit-learn's ``classification_report(..., output_dict=True,
    zero_division=0)``: per class ``precision``, ``recall``, ``f1-score``
    and ``support``; ``accuracy`` where ``labels`` cover every label
    present (else a ``micro avg`` entry); ``macro avg`` and ``weighted
    avg``."""
    y_true, y_pred = _labels(y_true, y_pred)
    labels = [int(c) for c in labels]
    present = set(np.union1d(y_true, y_pred).tolist())
    return _report(*_counts(y_true, y_pred, labels), target_names,
                   present <= set(labels))


def _report(tp, fp, fn, target_names: Sequence[str],
            all_labels: bool) -> Dict:
    precision = _ratio(tp, tp + fp)
    recall = _ratio(tp, tp + fn)
    f1 = _ratio(2 * tp, 2 * tp + fp + fn)
    support = tp + fn
    report = {}
    for i, name in enumerate(target_names):
        report[name] = {"precision": float(precision[i]),
                        "recall": float(recall[i]),
                        "f1-score": float(f1[i]),
                        "support": int(support[i])}
    total = support.sum(keepdims=True)
    micro = [float(_ratio(tp.sum(keepdims=True), d.sum(keepdims=True))[0])
             for d in (tp + fp, tp + fn)]
    micro_f1 = float(_ratio(2 * tp.sum(keepdims=True),
                            (2 * tp + fp + fn).sum(keepdims=True))[0])
    if all_labels:
        report["accuracy"] = micro_f1
    else:
        report["micro avg"] = {"precision": micro[0], "recall": micro[1],
                               "f1-score": micro_f1,
                               "support": int(total[0])}

    def weighted(x):
        return float(_ratio((x * support).sum(keepdims=True), total)[0])

    report["macro avg"] = {"precision": _mean(precision),
                           "recall": _mean(recall), "f1-score": _mean(f1),
                           "support": int(total[0])}
    report["weighted avg"] = {"precision": weighted(precision),
                              "recall": weighted(recall),
                              "f1-score": weighted(f1),
                              "support": int(total[0])}
    return report
