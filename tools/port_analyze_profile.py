"""Summarise a ``torch.profiler`` trace of the port into a time table.

Counterpart of ``tools/analyze_profile.py`` (which reads XLA's xplane):
this reads the Chrome trace that ``nrse_tpu_torch.utils.profiling.
profile_trace`` writes (``trace_<time>.json``) and sums its CUDA kernels
by the groups the port's profiles report (``utils.profiling.
PROFILE_GROUPS``, ``group_of``), with the trace's span and the card's
busy share, and lists the kernels that took the most device time.  A
trace without kernels (a CPU run) is summed over its host ops instead,
each op charged its self time.

    python3 tools/port_analyze_profile.py <trace.json or a directory> \\
        [n_steps] [--top 30] [--json]

A directory gives its newest ``*.json`` trace (searched recursively).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nrse_tpu_torch.utils.profiling import group_of  # noqa: E402


def find_trace(path: str) -> str:
    """``path`` if it is a file, else the newest ``*.json`` under it."""
    if os.path.isfile(path):
        return path
    paths = glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
    if not paths:
        raise SystemExit(f"no .json trace under {path}")
    return max(paths, key=os.path.getmtime)


def load_events(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def self_times(events) -> tuple:
    """``({name: self µs}, {name: calls})`` of complete events nested per
    thread: each event is charged its duration less its children's."""
    by_name, calls = collections.Counter(), collections.Counter()
    threads = collections.defaultdict(list)
    for e in events:
        threads[(e.get("pid"), e.get("tid"))].append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []  # [end, name, children's µs, start]

        def close():
            end, name, child, start = stack.pop()
            by_name[name] += (end - start) - child
            if stack:
                stack[-1][2] += end - start

        for e in evs:
            t0 = e["ts"]
            while stack and stack[-1][0] <= t0:
                close()
            calls[e["name"]] += 1
            stack.append([t0 + e.get("dur", 0), e["name"], 0, t0])
        while stack:
            close()
    return by_name, calls


def summarize(events, n_steps=None, top: int = 30) -> dict:
    """The trace's table: ``plane`` (``device`` when it holds CUDA
    kernels, else ``host``), ``span_ms``, ``busy_ms``, ``busy_share``,
    ``groups`` ({group: ms}, largest first), ``top`` ([name, ms, calls]),
    ``per_step_ms`` (busy over ``n_steps``, or None)."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    kernels = [e for e in complete if e.get("cat") == "kernel"]
    if kernels:
        plane, chosen = "device", kernels
        by_name, calls = collections.Counter(), collections.Counter()
        for e in kernels:
            by_name[e["name"]] += e.get("dur", 0)
            calls[e["name"]] += 1
    else:
        plane = "host"
        chosen = [e for e in complete if e.get("cat") == "cpu_op"]
        by_name, calls = self_times(chosen)
    if not chosen:
        raise SystemExit("the trace holds neither CUDA kernels nor host ops")
    lo = min(e["ts"] for e in chosen)
    hi = max(e["ts"] + e.get("dur", 0) for e in chosen)
    busy = sum(by_name.values()) / 1e3
    span = (hi - lo) / 1e3
    groups = collections.Counter()
    for name, us in by_name.items():
        groups[group_of(name)] += us / 1e3
    return {"plane": plane, "span_ms": span, "busy_ms": busy,
            "busy_share": busy / span if span > 0 else 0.0,
            "groups": dict(groups.most_common()),
            "top": [[name, us / 1e3, calls[name]]
                    for name, us in by_name.most_common(top)],
            "per_step_ms": busy / n_steps if n_steps else None}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", help="a trace_*.json, or a directory of them")
    p.add_argument("n_steps", type=int, nargs="?", default=None)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--json", action="store_true",
                   help="print the summary as one JSON object")
    args = p.parse_args(argv)
    path = find_trace(args.trace)
    print(f"# trace: {path}", file=sys.stderr)
    table = summarize(load_events(path), args.n_steps, args.top)
    if args.json:
        print(json.dumps(table))
        return table
    busy = table["busy_ms"]
    print(f"## {table['plane']} time: trace span {table['span_ms']:.1f} ms; "
          f"busy {busy:.1f} ms ({100 * table['busy_share']:.1f}% of the "
          f"span)")
    if table["per_step_ms"] is not None:
        print(f"≈ {table['per_step_ms']:.1f} ms busy per step "
              f"(over {args.n_steps} steps)")
    print("\n== time by group ==")
    for group, ms in table["groups"].items():
        print(f"{100 * ms / busy:6.2f}%  {ms:9.3f} ms  {group}")
    print(f"\n== top {args.top} by time ==")
    for name, ms, calls in table["top"]:
        print(f"{100 * ms / busy:6.2f}%  {ms:9.3f} ms  x{calls:<5} "
              f"{name[:110]}")
    return table


if __name__ == "__main__":
    main()
