"""Drive the port's embedding server once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the exit code is
not 0:

  1. device  — requires CUDA (never runs on the CPU), prints the card's
     name and power limit from ``nvidia-smi``, turns TF32 off;
  2. build   — compiles ``nrse_tpu_torch/csrc/*.cu`` with ``nvcc`` for
     ``sm_90a`` into ``build/nrse_tpu_torch/`` and prints the seconds;
  3. kernel A (block gated attention) against its plain PyTorch version at
     the serving shapes (bf16, B=32, H=16, D=64, T=249 with ragged key
     masks and one fully masked row, and T=384), with µs per call of both;
  4. kernel B (fused FFN) against its plain version at N=7968 (32 clips of
     249 frames), C=1024, F=4096, with µs per call of both;
  5. serving — WavLM-large at full width (24 layers, 1024 wide, 16 heads,
     FFN 4096) with seeded random weights, exported with buckets
     (1, 8, 32) and 5 s clips, loaded by ``ServingModel`` on the card,
     answers three ragged requests (1 clip; 6 clips; 40 clips chunked
     32 + 8).  Checks shapes, finiteness, that each kernel ran exactly
     24 × (bucket forwards) times, and the pooled cosine of one request
     against the same weights in float32 on the CPU through the plain
     path; then prints audio-sec/sec for each bucket.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the port, from this checkout: without it the script stops here
from nrse_tpu_torch.models.convert import init_state_dict  # noqa: E402
from nrse_tpu_torch.models.wavlm import WavLMConfig  # noqa: E402
from nrse_tpu_torch.ops import block_attention, fused_ffn  # noqa: E402
from nrse_tpu_torch.ops.attention import (  # noqa: E402
    gated_bias_attention_lse,
)
from nrse_tpu_torch.runtime import cuda_build  # noqa: E402
from nrse_tpu_torch.serve.export import (  # noqa: E402
    ServingModel,
    export_embedder,
)

SEED = 0
CLIP_SECONDS = 5.0
SAMPLE_RATE = 16000
BUCKETS = (1, 8, 32)
OUT_TOL = 1e-2      # max|Δ| / max|ref|, bf16 outputs (one bf16 ulp ≈ 4e-3)
LSE_TOL = 1e-3      # max|Δ| / max|ref| of the f32 log-sum-exp
COSINE_MIN = 0.99   # pooled cosine, bf16 card vs f32 CPU


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip())  # name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{name} x{torch.cuda.device_count()}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.load()
    log(f"[build] {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.3f} s")


def phase_kernel_a() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, d = 32, 16, 64
    worst, timing = 0.0, None
    for t in (249, 384):
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        gate = 1.0 + torch.rand(b, h, t, generator=gen, device=dev)
        bias = torch.randn(h, t, t, generator=gen, device=dev)
        mask = None
        rows = torch.ones(b, dtype=torch.bool, device=dev)  # lse compared
        if t == 249:
            lengths = torch.randint(t // 4, t + 1, (b,), generator=gen,
                                    device=dev)
            lengths[0] = t
            lengths[1] = 0  # one sample whose keys are all padded
            mask = (torch.arange(t, device=dev)[None, :]
                    < lengths[:, None]).to(torch.int32)
            rows = lengths > 0  # lse of an all-padded row is ~-1e9
        out, lse = block_attention.block_gated_attention_lse(
            q, k, v, gate, bias, mask)
        torch.cuda.synchronize()
        ref, ref_lse = gated_bias_attention_lse(q, k, v, gate, bias, mask)
        if not (torch.isfinite(out.float()).all()
                and torch.isfinite(lse).all()):
            raise RuntimeError(f"kernel A: non-finite output at T={t}")
        e_out = rel_err(out, ref)
        e_lse = rel_err(lse[rows], ref_lse[rows])
        abs_err = float((out.float() - ref.float()).abs().max())
        log(f"[kernel A] T={t} masked={mask is not None}: out rel "
            f"{e_out:.3e} (abs {abs_err:.3e}), lse rel {e_lse:.3e}")
        if e_out > OUT_TOL or e_lse > LSE_TOL:
            raise RuntimeError(f"kernel A disagrees with its plain version "
                               f"at T={t}: out {e_out}, lse {e_lse}")
        worst = max(worst, abs_err)
        if t == 249:
            ms = cuda_ms(lambda: block_attention.block_gated_attention_lse(
                q, k, v, gate, bias, mask))
            plain_ms = cuda_ms(lambda: gated_bias_attention_lse(
                q, k, v, gate, bias, mask))
            timing = (ms, plain_ms)
            log(f"[kernel A] B={b} H={h} T={t} D={d}: kernel "
                f"{ms * 1e3:.1f} us/call, plain {plain_ms * 1e3:.1f} "
                f"us/call")
    return {"name": "block_attention_fwd", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/block_attention_fwd.cu",
            "replaces": "nrse_tpu/ops/block_attention.py:106",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def phase_kernel_b() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, c, f = 32 * 249, 1024, 4096
    x = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    w1 = (torch.randn(f, c, generator=gen, device=dev) * c ** -0.5
          ).to(torch.bfloat16)
    w2 = (torch.randn(c, f, generator=gen, device=dev) * f ** -0.5
          ).to(torch.bfloat16)
    b1 = 0.1 * torch.randn(f, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(c, generator=gen, device=dev)
    out = fused_ffn.fused_ffn(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    ref = fused_ffn.ffn_plain(x, w1, b1, w2, b2)
    if not torch.isfinite(out.float()).all():
        raise RuntimeError("kernel B: non-finite output")
    err = rel_err(out, ref)
    abs_err = float((out.float() - ref.float()).abs().max())
    log(f"[kernel B] N={n} C={c} F={f}: out rel {err:.3e} "
        f"(abs {abs_err:.3e})")
    if err > OUT_TOL:
        raise RuntimeError(f"kernel B disagrees with its plain version: "
                           f"{err}")
    ms = cuda_ms(lambda: fused_ffn.fused_ffn(x, w1, b1, w2, b2))
    plain_ms = cuda_ms(lambda: fused_ffn.ffn_plain(x, w1, b1, w2, b2))
    flop = 4.0 * n * c * f
    log(f"[kernel B] kernel {ms * 1e3:.1f} us/call "
        f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms * 1e3:.1f} "
        f"us/call ({flop / plain_ms / 1e9:.1f} TFLOP/s)")
    return {"name": "fused_ffn_fwd", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/fused_ffn_fwd.cu",
            "replaces": "nrse_tpu/ops/fused_ffn.py:110",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


def _requests(rng: np.random.Generator, clip_seconds: float):
    """Three ragged requests ``(name, audio [N, T], lengths or None)``:
    one clip of 0.34 of the clip length (1.7 s of a 5 s clip), 6 clips of
    0.1-1 of it, 40 full clips."""
    clip = int(clip_seconds * SAMPLE_RATE)

    def clips(n, fractions):
        lengths = [int(f * clip) for f in fractions]
        out = np.zeros((n, clip), np.float32)
        for i, m in enumerate(lengths):
            out[i, :m] = 0.1 * rng.standard_normal(m)
        return out, lengths

    one, (one_len,) = clips(1, [0.34])
    six, six_len = clips(6, rng.uniform(0.1, 1.0, 6))
    forty, _ = clips(40, [1.0] * 40)
    return [(f"1 clip of {one_len / SAMPLE_RATE:g} s", one[:, :one_len],
             None),
            (f"6 clips of {min(six_len) / SAMPLE_RATE:.2f}-"
             f"{max(six_len) / SAMPLE_RATE:.2f} s", six, six_len),
            (f"40 clips of {clip_seconds:g} s", forty, None)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def phase_serving(cfg=None, device=torch.device("cuda"),
                  clip_seconds: float = CLIP_SECONDS,
                  buckets=BUCKETS) -> dict:
    """The serving phase; its arguments let it be rehearsed at a small
    width on the CPU, with the wrappers' plain paths standing in."""

    cfg = cfg or WavLMConfig.large()
    t0 = time.perf_counter()
    sd = init_state_dict(cfg, torch.Generator().manual_seed(SEED))
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    art = tempfile.mkdtemp(prefix="smoke_artifact_",
                           dir=cuda_build.BUILD_DIR)
    try:
        export_embedder(sd, cfg, art, batch_sizes=buckets,
                        clip_seconds=clip_seconds, sample_rate=SAMPLE_RATE)
        server = ServingModel(art, device)
        ref_server = ServingModel(art, torch.device("cpu"))  # float32
    finally:
        shutil.rmtree(art)
    n_params = sum(v.numel() for v in sd.values())
    log(f"[serve] WavLM {cfg.num_hidden_layers} layers x "
        f"{cfg.hidden_size}, {n_params / 1e6:.1f} M params, exported and "
        f"loaded in {time.perf_counter() - t0:.1f} s")

    clip = server.clip_samples
    frames = int(cfg.feature_lengths(clip))
    for bkt in buckets:  # warm-up: cuDNN algorithm choice, allocator
        server(np.zeros((bkt, clip), np.float32))
    _sync(device)

    reqs = _requests(np.random.default_rng(SEED), clip_seconds)
    forwards = sum(len(server.plan(len(a))) for _, a, _ in reqs)
    block_attention.LAUNCHES = 0
    fused_ffn.LAUNCHES = 0
    results = []
    for name, audio, lengths in reqs:
        mask = None
        if lengths is not None:
            mask = (np.arange(audio.shape[1])[None, :]
                    < np.asarray(lengths)[:, None]).astype(np.int32)
        results.append(server(audio, mask))
    _sync(device)
    launches = {"block_attention_fwd": block_attention.LAUNCHES,
                "fused_ffn_fwd": fused_ffn.LAUNCHES}
    want = cfg.num_hidden_layers * forwards
    log(f"[serve] {forwards} bucket forwards; launches {launches} "
        f"(want {want} each)")
    if any(n != want for n in launches.values()):
        raise RuntimeError(f"kernel launches {launches} != {want}")

    for (name, audio, _), (seq, pooled) in zip(reqs, results):
        n = audio.shape[0]
        ok = (seq.shape == (n, frames, cfg.hidden_size)
              and pooled.shape == (n, cfg.hidden_size)
              and np.isfinite(seq).all() and np.isfinite(pooled).all())
        log(f"[serve] {name}: sequence {seq.shape}, pooled {pooled.shape}, "
            f"finite={ok}")
        if not ok:
            raise RuntimeError(f"bad serving output for {name}")

    # the same weights in float32 on the CPU, through the plain path
    ref_seq, ref_pooled = ref_server(reqs[0][1])
    del ref_server
    got = torch.from_numpy(results[0][1]).double()
    cos = torch.nn.functional.cosine_similarity(
        got, torch.from_numpy(ref_pooled).double(), dim=-1)
    seq_cos = torch.nn.functional.cosine_similarity(
        torch.from_numpy(results[0][0]).double().flatten(),
        torch.from_numpy(ref_seq).double().flatten(), dim=0)
    log(f"[serve] {reqs[0][0]}: pooled cosine vs float32 CPU "
        f"{[round(c, 6) for c in cos.tolist()]}, sequence cosine "
        f"{float(seq_cos):.6f}")
    if float(cos.min()) < COSINE_MIN:
        raise RuntimeError(f"pooled cosine {cos.tolist()} < {COSINE_MIN}")

    for bkt in buckets:
        audio = 0.1 * np.random.default_rng(bkt).standard_normal(
            (bkt, clip)).astype(np.float32)
        for _ in range(3):  # warm-up; the card idled during the CPU run
            server(audio)
        iters = 10
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            server(audio)
        _sync(device)
        dt = (time.perf_counter() - t0) / iters
        log(f"[serve] bucket {bkt}: {dt * 1e3:.2f} ms/request, "
            f"{bkt * clip_seconds / dt:.1f} audio-sec/sec")
    if device.type == "cuda":
        log(f"[serve] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> int:
    name = phase_device()
    phase_build()
    kernels = [phase_kernel_a(), phase_kernel_b()]
    launches = phase_serving()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
