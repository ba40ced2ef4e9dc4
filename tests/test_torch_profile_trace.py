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


# a product of the wgmma GEMM as the profiler names it: demangled, with
# its template arguments (the epilogue, the MN-major flag)
GEMM = ("void nrse::wg::gemm_tn_kernel<(anonymous namespace)::{0}, {1}>("
        "CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, int, int, int, "
        "(anonymous namespace)::{0})")


@pytest.mark.fast
@pytest.mark.parametrize("name,wrapper", [
    (GEMM.format("EpiGelu<true>", "false"), "fused_ffn_fwd"),
    (GEMM.format("EpiGelu<false>", "false"), "fused_ffn_fwd"),
    (GEMM.format("EpiBias<true>", "false"), "other"),
    (GEMM.format("EpiDgd", "false"), "other"),
    (GEMM.format("EpiStoreBf16", "false"), "other"),
    (GEMM.format("EpiDw", "true"), "fused_ffn_bwd_dw"),
    ("(anonymous namespace)::dh2_kernel(__nv_bfloat16 const*, "
     "nrse::DropSite, __nv_bfloat16*, float*, int, int)", "fused_ffn_bwd_dx"),
    ("(anonymous namespace)::transpose_cast_kernel(float const*, "
     "__nv_bfloat16*, int, int)", "other"),
    ("(anonymous namespace)::colsum_fold_kernel(float const*, int, int, "
     "float*)", "other"),
])
def test_ffn_kernels_told_apart_in_a_trace(name, wrapper):
    """Kernel B's and K2's launches are read from a trace by the kernels
    only their entries launch: B's first product (its GELU epilogue), K2
    dx's dh2 pass, K2 dW's product (its dW epilogue); their other
    kernels count for no wrapper, in the BYOL step's and the fine-tune's
    tables alike."""
    assert chip_smoke._byol_kernel(name) == wrapper
    assert chip_smoke._ft_kernel(name) == wrapper


# an eager step's kernel records: wrapper "a" launched twice, two kernels
# a launch, wrapper "b" once, one kernel
EAGER = ["a0", "a1", "a0", "a1", "b0"]
FULL = ["a0", "a1", "a0", "a1", "b0"]


@pytest.mark.fast
@pytest.mark.parametrize("reads,launches,retakes", [
    ([FULL], {"a": 2, "b": 1}, 0),
    ([FULL[1:], FULL], {"a": 2, "b": 1}, 1),        # a record lost
    ([FULL[:-1], FULL[:-2], FULL], {"a": 2, "b": 1}, 2),
    ([FULL + ["b0"]], "b: 2 kernel records", 0),     # above the want
    ([FULL[1:]] * chip_smoke.TRACE_ATTEMPTS,
     f"in {chip_smoke.TRACE_ATTEMPTS} traces",
     chip_smoke.TRACE_ATTEMPTS),
])
def test_replayed_launches_retake_a_trace_that_lost_records(
        monkeypatch, reads, launches, retakes):
    """A replay's kernels share one launch, so a lost record shows only
    as a read short of what the keep list implies: both traces are taken
    again (logged); a read above it fails at once, as does a shortfall in
    every one of the attempts."""
    logged = []
    monkeypatch.setattr(chip_smoke, "sync", lambda device: None)
    monkeypatch.setattr(chip_smoke, "log", logged.append)
    counts = {}
    replays = iter(reads)

    def trace(call, form):
        call()
        return [{"name": n}
                for n in (EAGER if form == "eager" else next(replays))]

    def read():
        return chip_smoke._replayed_launches(
            lambda: counts.update(a=0, b=0), lambda: counts.update(a=2, b=1),
            lambda: [True], lambda keep: {"a": 2, "b": 1, "c": 5},
            {"a": "a", "b": "b"}, lambda name: name[0], lambda: dict(counts),
            "step", trace)

    if isinstance(launches, dict):
        assert read() == (launches, [True])
    else:
        with pytest.raises(RuntimeError, match=launches):
            read()
    assert len(logged) == retakes
    assert all("kernel records lost" in m for m in logged)
