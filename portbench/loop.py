"""What the training entries share: the loader's endless order, the timed
step loop, its traced form, per-leaf norms of the program's flat buffers,
and the comparison of the program's readings with the reference's."""

from __future__ import annotations

import gc
import itertools
import statistics
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from portbench import corpus, trace


class Endless:
    """The program's ``HostDataLoader`` over ``dataset`` (``size`` items)
    with no end: block after block of ``batch_size`` whole permutations of
    the corpus, each block whole batches and one epoch of the loader (so
    each item's draws differ from block to block), the first ``size``
    rows all distinct.  The window takes as many batches as it runs."""

    def __init__(self, dataset, size: int, batch_size: int, seed: int):
        from nrse_tpu_torch.data.loader import HostDataLoader

        self.size, self.rows, self.seed = size, size * batch_size, seed
        self.loader = HostDataLoader(dataset, self.block(0), batch_size,
                                     shuffle=False, seed=seed % 2**32,
                                     drop_last=True)

    def block(self, j: int):
        return corpus.epoch_order(self.size, self.rows, self.seed, j)

    def __iter__(self) -> Iterator:
        for j in itertools.count():
            self.loader.indices = self.block(j)
            yield from self.loader


def leaf_norms(named, flat: torch.Tensor, scale: float = 1.0,
               base: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Norm of each named parameter's slice of ``flat`` (minus ``base``),
    times ``scale``; ``named`` gives the names and sizes in the buffer's
    order."""
    out, off = {}, 0
    for name, p in named:
        n = p.numel()
        x = flat[off:off + n].double()
        if base is not None:  # kept on the host, off the card's peak
            x = x - base[off:off + n].to(x.device).double()
        out[name] = float(x.norm()) * scale
        off += n
    return out


def run_steps(step: Callable[[Dict], Dict], batches: Iterator,
              seconds: float, spans: trace.Spans, steps: Optional[int] = None
              ) -> Dict:
    """Steps from ``batches`` until ``seconds`` have passed (or ``steps``
    are done), then a synchronize; each step's record is ``step``'s.
    Returns ``records`` and ``elapsed`` (host clock, to the synchronize)."""
    records = []
    t0 = time.perf_counter()
    with trace.window_range(spans):
        while True:
            with spans("loader_wait"):
                batch = next(batches, None)
            if batch is None:
                raise RuntimeError("the loader ended inside the window")
            batch.pop("__count__", None)
            with spans("step_dispatch"):
                records.append(step(batch))
            if (steps is not None and len(records) >= steps) or (
                    steps is None and time.perf_counter() - t0 >= seconds):
                break
        sync()
        elapsed = time.perf_counter() - t0
    return {"records": records, "elapsed": elapsed}


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def free_card() -> None:
    from nrse_tpu_torch.runtime.graphs import release_graphs

    release_graphs()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def training_gaps(prog: Dict, ref: Dict, floor: float = 1e-3) -> Dict:
    """The numbers a training cell can compare (its workload's ``limits``
    name those it does):

    * ``loss``: the largest gap of a step's loss, over the reference's;
      ``loss_mean``: the mean of the steps' gaps;
    * ``grad``: over the leaves, the gap between the program's and the
      reference's norm of the first gradient as the optimizer takes it,
      over the larger of the reference's norm of that leaf and of the
      median leaf; ``grad_median``: the median leaf's such gap;
    * ``change``: the same of each leaf's change over the followed steps.

    ``grad`` leaves out the leaves whose reference first gradient is under
    ``floor`` of the median leaf's, ``change`` those whose reference
    gradient is under it at every followed step (``ref["grads"]``, one
    norm per leaf a step; else the first alone): their gradient is nought
    to rounding (k_proj's bias under softmax, a layer LayerDrop skipped),
    so what the program reads there, and how far Adam moves them, is
    round-off alone."""
    losses = [abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(prog["loss"], ref["loss"])]

    def kept(norms):
        med = statistics.median(norms.values())
        return {k for k, v in norms.items() if v >= floor * med}

    g_med = statistics.median(ref["grad"].values())
    first = kept(ref["grad"])
    moved = set().union(*(kept(g) for g in ref.get("grads", [ref["grad"]])))
    grad = {k: abs(prog["grad"][k] - v) / max(v, g_med)
            for k, v in ref["grad"].items() if k in first}
    held = {k: v for k, v in ref["change"].items()
            if k.split(".", 1)[1] in moved or k in moved}
    c_med = statistics.median(held.values())
    change = {k: abs(prog["change"][k] - v) / max(v, c_med)
              for k, v in held.items()}

    def worst(gaps, side):
        top = sorted(gaps, key=lambda k: -gaps[k])[:5]
        return [[k, gaps[k], ref[side][k], prog[side][k]] for k in top]

    return {"loss": max(losses), "loss_mean": statistics.fmean(losses),
            "grad": max(grad.values()),
            "grad_median": statistics.median(grad.values()),
            "change": max(change.values()),
            "left_out": sorted(set(ref["change"]) - set(held)),
            "worst": {"grad": worst(grad, "grad"),
                      "change": worst(change, "change"),
                      "medians": [g_med, c_med]}}
