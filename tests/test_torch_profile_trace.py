"""The check ``chip_smoke.py`` makes of each ``torch.profiler`` trace
before it reads device time from it (``chip_smoke._trace_faults``): of
the launches inside the trace's timed range, one with no kernel in the
trace, or a span of their kernels that disagrees with the CUDA events
timed around the same calls, marks the trace at fault.  Synthetic traces,
no card."""

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)


def _trace(spans, launched=None, ranges=((50.0, 1000.0),)):
    """Kernels at ``(start µs, duration µs)`` with correlations 1, 2, ...,
    a launch event for each correlation in ``launched`` (default: every
    kernel's), in correlation order on the host 100 µs apart, alternating
    runtime and driver calls, and the timed ranges ``(start, duration)``."""
    kernels = [{"cat": "kernel", "name": f"k{i}", "ts": ts, "dur": dur,
                "args": {"correlation": i + 1}}
               for i, (ts, dur) in enumerate(spans)]
    if launched is None:
        launched = range(1, len(spans) + 1)
    launches = [{"cat": ("cuda_runtime", "cuda_driver")[c % 2],
                 "name": ("cudaLaunchKernel", "cuLaunchKernelEx")[c % 2],
                 "ts": 100.0 * c, "args": {"correlation": c}}
                for c in launched]
    timed = [{"cat": "user_annotation", "name": chip_smoke.TIMED, "ts": ts,
              "dur": dur} for ts, dur in ranges]
    return kernels + launches + timed


# kernels spanning 10 ms of the trace (1000 to 11000 µs)
SPANS = [(1000.0, 4000.0), (6000.0, 3000.0), (9500.0, 1500.0)]


@pytest.mark.fast
@pytest.mark.parametrize("event_ms,launched,faults", [
    (10.3, None, []),                       # lead-in and copy back: fine
    (20.6, None, ["span"]),                 # every kernel at half its time
    (9.0, None, ["span"]),                  # longer than the events
    (10.3, [1, 2, 3, 4], ["launches"]),     # a launch without its kernel
    (20.6, [1, 2, 3, 4], ["launches", "span"]),
])
def test_trace_faults(event_ms, launched, faults):
    kernels, got = chip_smoke._trace_faults(_trace(SPANS, launched),
                                            event_ms)
    assert [k["name"] for k in kernels] == ["k0", "k1", "k2"]
    assert len(got) == len(faults)
    for msg, kind in zip(got, faults):
        assert ("no kernel in the trace (launches [3]" if kind == "launches"
                else "of CUDA events") in msg


@pytest.mark.fast
def test_only_the_timed_range_counts():
    """A warm-up call's launch before the timed range (correlation 1, at
    100 µs) and its kernel are left out; a launch after it (correlation 5,
    at 500 µs) whose kernel the trace lacks is no fault."""
    events = _trace(SPANS + [(11500.0, 10.0)], launched=[1, 2, 3, 4, 5],
                    ranges=((150.0, 300.0),))
    kernels, faults = chip_smoke._trace_faults(events, 5.6)
    assert [k["name"] for k in kernels] == ["k1", "k2", "k3"]
    assert faults == []


@pytest.mark.fast
@pytest.mark.parametrize("ranges,fault", [
    ((), "0 timed ranges in the trace"),
    (((50.0, 1000.0), (2000.0, 10.0)), "2 timed ranges in the trace"),
    (((5000.0, 10.0),), "no kernel launched in the timed range"),
])
def test_trace_without_one_timed_range_or_kernels_is_at_fault(ranges, fault):
    kernels, faults = chip_smoke._trace_faults(
        _trace(SPANS, ranges=ranges), 10.3)
    assert kernels == [] and faults == [fault]


@pytest.mark.fast
@pytest.mark.parametrize("event_ms,faults", [
    (30.3, []),          # 20 ms of host work before the first launch: fine
    (40.6, ["span"]),    # the same lead-in, every kernel at half its time
])
def test_host_lead_in_before_the_first_launch(event_ms, faults):
    """The host's time from the timed range's start to its first launch
    (a train step's staging) is read from the trace and not held against
    the kernels' span."""
    events = _trace([(ts + 20000.0, dur) for ts, dur in SPANS],
                    ranges=((50.0, 40000.0),))
    for e in events:
        if e["cat"] in ("cuda_runtime", "cuda_driver"):
            e["ts"] += 20000.0
    kernels, got = chip_smoke._trace_faults(events, event_ms)
    assert [k["name"] for k in kernels] == ["k0", "k1", "k2"]
    assert ["span" for msg in got if "of CUDA events" in msg] == faults
