"""Classification metrics in numpy.

What the JAX evaluator takes from scikit-learn
(``nrse_tpu/baseline/eval_cat_ser.py:234-252``), written out because the
card's machine has no scikit-learn: F1 micro and macro, and precision and
recall macro with ``zero_division=0``, over the labels that occur in
either the targets or the predictions, as scikit-learn's ``average=
"macro"`` takes them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den`` with 0 where ``den`` is 0 (``zero_division=0``)."""
    out = np.zeros(num.shape, np.float64)
    np.divide(num, den, out=out, where=den > 0)
    return out


def _mean(x: np.ndarray) -> float:
    return float(x.mean()) if x.size else 0.0


def classification_metrics(y_true, y_pred) -> Dict[str, float]:
    """``f1_micro``, ``f1_macro``, ``precision_macro`` and ``recall_macro``
    of integer labels ``y_true`` against predictions ``y_pred``."""
    y_true = np.asarray(y_true, np.int64).ravel()
    y_pred = np.asarray(y_pred, np.int64).ravel()
    if y_true.shape != y_pred.shape:
        raise ValueError(f"{y_true.shape} targets against {y_pred.shape} "
                         "predictions")
    labels = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels],
                  np.float64)
    fp = np.array([np.sum((y_true != c) & (y_pred == c)) for c in labels],
                  np.float64)
    fn = np.array([np.sum((y_true == c) & (y_pred != c)) for c in labels],
                  np.float64)
    precision = _ratio(tp, tp + fp)
    recall = _ratio(tp, tp + fn)
    f1 = _ratio(2 * tp, 2 * tp + fp + fn)
    micro = _ratio(2 * tp.sum(keepdims=True),
                   (2 * tp + fp + fn).sum(keepdims=True))[0]
    return {"f1_micro": float(micro), "f1_macro": _mean(f1),
            "precision_macro": _mean(precision),
            "recall_macro": _mean(recall)}
