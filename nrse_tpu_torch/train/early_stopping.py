"""Early stopping: a copy of ``nrse_tpu/train/early_stopping.py`` (whose
package imports the JAX trainer, so it cannot be imported without JAX)."""

from __future__ import annotations


class EarlyStopping:
    """Stop after ``patience`` epochs without ``min_delta`` improvement."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0,
                 mode: str = "min"):
        assert mode in ("min", "max")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.counter = 0
        self.best_score = None
        self.early_stop = False

    def __call__(self, score: float) -> bool:
        if self.best_score is None:
            self.best_score = score
            return False
        if self.mode == "min":
            improvement = self.best_score - score > self.min_delta
        else:
            improvement = score - self.best_score > self.min_delta
        if improvement:
            self.best_score = score
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop
