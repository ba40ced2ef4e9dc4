"""Spans around the benchmark's calls into the program, and the reading of
a ``torch.profiler`` trace: kernel records, busy time as the union of the
kernels' intervals, device time by group, and the idle gaps labelled with
the span the host was in."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench import yardstick

PREFIX = "portbench."
WINDOW = PREFIX + "window"


class Spans:
    """Host spans: with ``on`` each is a profiler range and its host
    seconds add up by name; without, nothing is recorded."""

    def __init__(self, on: bool):
        self.on = on
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1


@contextlib.contextmanager
def profiled(out: Dict):
    """Profile what runs inside; ``out`` then holds the window's reading
    (:func:`read`).  The caller marks the window with a ``WINDOW`` range
    that ends after a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(read(events))


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read(events: List[Dict]) -> Dict:
    """``window_s``, ``busy_s``, ``kernels`` ``[(name, start, dur)]``,
    ``groups`` (device seconds by group) and ``idle_gaps`` (the ten
    longest, ``[label, seconds]``) of the trace's ``WINDOW`` range."""
    spans, kernels = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if e.get("cat") == "kernel":
            kernels.append((e["name"], ts, dur))
        elif str(e.get("name", "")).startswith(PREFIX) \
                and e.get("cat") in ("user_annotation", "cpu_op"):
            spans.append((e["name"][len(PREFIX):], ts, dur))
    windows = [s for s in spans if s[0] == WINDOW[len(PREFIX):]]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    _, w0, wd = windows[0]
    w1 = w0 + wd
    inside = [(n, max(s, w0), min(s + d, w1) - max(s, w0))
              for n, s, d in kernels if s < w1 and s + d > w0]
    busy = _merge([(s, s + d) for _, s, d in inside])
    busy_s = sum(b - a for a, b in busy)
    gaps, last = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    inner = [s for s in spans if s[0] != WINDOW[len(PREFIX):]]

    def label(mid: float) -> str:
        holding = [s for s in inner if s[1] <= mid <= s[1] + s[2]]
        return min(holding, key=lambda s: s[2])[0] if holding \
            else "between calls"

    labelled = sorted(((label((a + b) / 2), b - a) for a, b in gaps),
                      key=lambda g: -g[1])
    return {"window_s": wd, "busy_s": busy_s, "kernels": inside,
            "groups": yardstick.group_seconds(inside),
            "idle_gaps": [list(g) for g in labelled[:10]]}


def breakdown(obs: Dict) -> Dict:
    ops = sorted(obs["groups"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": obs["idle_gaps"]}


def window_range(spans: Optional[Spans]):
    if spans is None or not spans.on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(WINDOW)
