"""Drive the port's embedding server and its BYOL train step once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the exit code is
not 0:

  1. device  — requires CUDA (never runs on the CPU), prints the card's
     name and power limit from ``nvidia-smi``, turns TF32 off;
  2. build   — compiles ``nrse_tpu_torch/csrc/*.cu`` with ``nvcc`` for
     ``sm_90a`` (one process per source, all at once) into
     ``build/nrse_tpu_torch/`` and prints the seconds;
  3. kernel A (block gated attention) against its plain PyTorch version at
     the serving shapes (bf16, B=32, H=16, D=64, T=249 with ragged key
     masks and one fully masked row, and T=384), with µs per call of both;
     and that it raises under autograd (it has no backward yet);
  4. kernel B (fused FFN, serving entry) against its plain version at
     N=7968 (32 clips of 249 frames), C=1024, F=4096, µs per call of both;
  5. serving — WavLM-large at full width (24 layers, 1024 wide, 16 heads,
     FFN 4096) with seeded random weights, exported with buckets
     (1, 8, 32) and 5 s clips, loaded by ``ServingModel`` on the card,
     answers three ragged requests (1 clip; 6 clips; 40 clips chunked
     32 + 8).  Checks shapes, finiteness, that each kernel ran exactly
     24 × (bucket forwards) times, and the pooled cosine of one request
     against the same weights in float32 on the CPU through the plain
     path; then prints audio-sec/sec for each bucket;
  6. K1 (dropout) at [36·249, 1024] bf16, p = 0.1: the kernel's mask equals
     the Philox twin bit for bit, forward and backward equal the plain
     version, the explicit-mask entry equals the seeded one; µs per call
     of both;
  7. kernel B's training forward (both dropout sites, h1 saved) and K2's
     dx and dW kernels at N = 36·249, C = 1024, F = 4096, p = 0.1, against
     the plain versions (max|Δ|/max|ref| ≤ 1e-2), the explicit-mask entries
     and the autograd Function against the direct seeded calls (bit for
     bit); µs per call and TFLOP/s of each beside the plain version's;
  8. K4 (AdamW + EMA) over the flat BYOL parameter set (~326 M) against
     the plain version (≤ 1e-6 relative); µs per call and GB/s;
  9. training — BYOL on WavLM-large at full width and depth (projection
     1024, prediction 2048, seeded weights) with the JAX preset's
     hyper-parameters (lr 1e-5 cosine, wd 1e-5, clip 1.0, EMA 0.997,
     dropout 0.1, LayerDrop 0.1, SpecAugment 0.05/10/2) on 36 synthetic
     5 s clips: 2 warm-up steps (the target checked to move by exactly the
     EMA), then 5 timed steps whose kernel launches must equal the counts
     the layers each tower ran imply; prints s/step, audio-sec/sec and
     peak memory; then the eval step once; then a cross-check at 4 layers
     and batch 2, random features off, bf16 on the card against float32
     on the CPU (loss, grad_norm ratio, gradient cosine ≥ 0.99).

The line before the last is the kernels' JSON record (launches: kernels
A and B from the serving phase, K1, K2 and K4 from the training phase);
the last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": ...}}``.
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
from nrse_tpu_torch.models.byol import OnlineNetwork, TargetNetwork  # noqa
from nrse_tpu_torch.models.convert import (  # noqa: E402
    init_byol_state_dict,
    init_state_dict,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig  # noqa: E402
from nrse_tpu_torch.ops import (  # noqa: E402
    block_attention,
    fused_dropout,
    fused_ffn,
    fused_optimizer,
    philox,
)
from nrse_tpu_torch.ops.attention import (  # noqa: E402
    gated_bias_attention_lse,
)
from nrse_tpu_torch.runtime import cuda_build  # noqa: E402
from nrse_tpu_torch.train.byol_trainer import (  # noqa: E402
    create_train_state,
    make_byol_eval_step,
    make_byol_train_step,
)
from nrse_tpu_torch.train.schedules import cosine_annealing  # noqa: E402
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
    # §0: under autograd the kernel raises instead of detaching its output
    try:
        block_attention.block_gated_attention(
            q.detach().requires_grad_(), k, v, gate, bias, mask)
    except RuntimeError as e:
        log(f"[kernel A] under autograd: raises ({str(e)[:60]}...)")
    else:
        raise RuntimeError("kernel A returned an output under autograd")
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


TRAIN_BATCH = 36
DROP_P = 0.1
GRAD_TOL = 1e-2    # max|Δ| / max|ref| of K2's outputs against plain
OPT_TOL = 1e-6     # max|Δ| / max|ref| of K4's outputs against plain


def _gbps(nbytes: float, ms: float) -> float:
    return nbytes / ms / 1e6


def phase_k1() -> dict:
    """K1 at the training shape: the kernel's mask against the Philox twin
    bit for bit, forward and backward against the plain version."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, c = TRAIN_BATCH * 249, 1024
    seed = philox.stream_seed(SEED, 0, 0, 0, 0)
    x = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    mask = fused_dropout.dump_dropout_mask(seed, (n, c), DROP_P, device=dev)
    twin = philox.dump_mask(seed, 0, (n, c), DROP_P, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(mask, twin):
        raise RuntimeError(f"K1: the kernel's mask differs from the Philox "
                           f"twin at {int((mask != twin).sum())} elements")
    xr = x.clone().requires_grad_()
    y = fused_dropout.hw_dropout(xr, seed, DROP_P)
    y.backward(dy)
    ref_y = fused_dropout.dropout_plain(x, twin)
    ref_dx = fused_dropout.dropout_plain(dy, twin)
    err = max(float((y.detach().float() - ref_y.float()).abs().max()),
              float((xr.grad.float() - ref_dx.float()).abs().max()))
    log(f"[K1] [{n}, {c}] bf16 p={DROP_P}: mask equals the Philox twin bit "
        f"for bit (keep {float((twin > 0).float().mean()):.5f}); forward "
        f"and backward max|Δ| vs plain {err:.3e}")
    if err != 0.0:
        raise RuntimeError(f"K1 disagrees with its plain version: {err}")
    with torch.no_grad():  # the explicit-mask entry, fed the same mask
        if not torch.equal(fused_dropout.hw_dropout_masked(x, twin),
                           y.detach()):
            raise RuntimeError("K1's explicit-mask entry differs from its "
                               "Philox entry")
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_dropout.hw_dropout(x, seed, DROP_P))
        plain_ms = cuda_ms(lambda: fused_dropout.dropout_plain(
            x, philox.dump_mask(seed, 0, (n, c), DROP_P, device=dev)))
    nbytes = 2 * 2 * n * c
    log(f"[K1] kernel {ms * 1e3:.1f} us/call ({_gbps(nbytes, ms):.0f} GB/s), "
        f"plain (Philox twin + multiply) {plain_ms * 1e3:.1f} us/call")
    return {"name": "fused_dropout", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/fused_dropout.cu",
            "replaces": "nrse_tpu/ops/fused_dropout.py:68",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_k2() -> list:
    """Kernel B's training forward (both dropout sites, h1 saved) and K2's
    dx and dW kernels at N = 36 x 249, against the plain versions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, c, f = TRAIN_BATCH * 249, 1024, 4096
    seed = philox.stream_seed(SEED, 0, 0, 0, 2)
    x = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    dout = (0.1 * torch.randn(n, c, generator=gen, device=dev)
            ).to(torch.bfloat16)
    w1 = torch.randn(f, c, generator=gen, device=dev) * c ** -0.5
    w2 = torch.randn(c, f, generator=gen, device=dev) * f ** -0.5
    b1 = 0.1 * torch.randn(f, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(c, generator=gen, device=dev)
    keep_act, keep_hid = fused_ffn.dump_masks(seed, n, c, f, DROP_P, DROP_P,
                                              device=dev)
    drop = fused_ffn._Drop(seed, DROP_P, DROP_P)
    with torch.no_grad():
        out, h1, gd = fused_ffn._kernel_fwd(x, w1, b1, w2, b2, drop, True)
        dx, db1, db2, dh1, dh2 = fused_ffn._kernel_bwd_dx(dout, h1, w1, w2,
                                                          drop)
        dw1, dw2 = fused_ffn._kernel_bwd_dw(x, gd, dh1, dh2)
        torch.cuda.synchronize()
        ref_out, ref_h1, ref_gd = fused_ffn.ffn_plain_fwd(
            x, w1, b1, w2, b2, keep_act, keep_hid)
        ref_dx, ref_db1, ref_db2, ref_dh1, ref_dh2 = \
            fused_ffn.ffn_plain_bwd_dx(dout, h1, w1, w2, keep_act, keep_hid)
        ref_dw1, ref_dw2 = fused_ffn.ffn_plain_bwd_dw(x, gd, dh1, dh2)
    checks = {"out": (out, ref_out), "h1": (h1, ref_h1), "gd": (gd, ref_gd),
              "dx": (dx, ref_dx), "db1": (db1, ref_db1),
              "db2": (db2, ref_db2), "dh1": (dh1, ref_dh1),
              "dw1": (dw1, ref_dw1), "dw2": (dw2, ref_dw2)}
    errs = {k: rel_err(*v) for k, v in checks.items()}
    if not all(torch.isfinite(t.float()).all() for t, _ in checks.values()):
        raise RuntimeError("kernel B / K2: non-finite output")
    log(f"[K2] N={n} C={c} F={f} p={DROP_P}: max|Δ|/max|ref| vs plain "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if max(errs.values()) > GRAD_TOL:
        raise RuntimeError(f"kernel B / K2 disagree with plain: {errs}")

    # the explicit-mask entries, fed the dumped masks, give the same bits
    with torch.no_grad():
        masked = fused_ffn._Drop(masks=(keep_act, keep_hid))
        m_out, m_h1, _ = fused_ffn._kernel_fwd(x, w1, b1, w2, b2, masked,
                                               True)
        m_dx = fused_ffn._kernel_bwd_dx(dout, h1, w1, w2, masked)
    for name, got, want in (("out", m_out, out), ("h1", m_h1, h1),
                            ("dx", m_dx[0], dx), ("db1", m_dx[1], db1),
                            ("dh1", m_dx[3], dh1)):
        if not torch.equal(got, want):
            raise RuntimeError(f"kernel B / K2 with explicit masks: {name} "
                               f"differs from the Philox masks' run")

    # the autograd Function gives the same gradients as the direct calls
    xr = x.clone().requires_grad_()
    params = [t.clone().requires_grad_() for t in (w1, b1, w2, b2)]
    fused_ffn.fused_ffn(xr, *params, seed, DROP_P, DROP_P).backward(dout)
    for name, got, want in (("dx", xr.grad, dx), ("dw1", params[0].grad, dw1),
                            ("db1", params[1].grad, db1),
                            ("dw2", params[2].grad, dw2),
                            ("db2", params[3].grad, db2)):
        if not torch.equal(got, want.to(got.dtype)):
            raise RuntimeError(f"FusedFFN's {name} differs from K2's")

    flop = 4.0 * n * c * f
    with torch.no_grad():
        times = {
            "fwd": (cuda_ms(lambda: fused_ffn._kernel_fwd(
                        x, w1, b1, w2, b2, drop, True)),
                    cuda_ms(lambda: fused_ffn.ffn_plain_fwd(
                        x, w1, b1, w2, b2, keep_act, keep_hid))),
            "dx": (cuda_ms(lambda: fused_ffn._kernel_bwd_dx(
                       dout, h1, w1, w2, drop)),
                   cuda_ms(lambda: fused_ffn.ffn_plain_bwd_dx(
                       dout, h1, w1, w2, keep_act, keep_hid))),
            "dw": (cuda_ms(lambda: fused_ffn._kernel_bwd_dw(x, gd, dh1, dh2)),
                   cuda_ms(lambda: fused_ffn.ffn_plain_bwd_dw(
                       x, gd, dh1, dh2))),
        }
    for k, (ms, plain_ms) in times.items():
        log(f"[K2] {k}: kernel {ms * 1e3:.1f} us/call "
            f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms * 1e3:.1f} "
            f"us/call ({flop / plain_ms / 1e9:.1f} TFLOP/s)")
    abs_err = {k: float((a.float() - b.float()).abs().max())
               for k, (a, b) in checks.items()}
    return [
        {"name": "fused_ffn_bwd_dx", "route": "cuda",
         "source": "nrse_tpu_torch/csrc/fused_ffn_bwd.cu",
         "replaces": "nrse_tpu/ops/fused_ffn.py:204",
         "max_abs_err": max(abs_err[k] for k in ("dx", "db1", "db2")),
         "ms": times["dx"][0], "plain_ms": times["dx"][1]},
        {"name": "fused_ffn_bwd_dw", "route": "cuda",
         "source": "nrse_tpu_torch/csrc/fused_ffn_bwd.cu",
         "replaces": "nrse_tpu/ops/fused_ffn.py:253",
         "max_abs_err": max(abs_err["dw1"], abs_err["dw2"]),
         "ms": times["dw"][0], "plain_ms": times["dw"][1]},
    ]


def byol_sizes(cfg, projection_dim=1024, prediction_dim=2048):
    """``(online, target)`` parameter counts of the BYOL towers."""
    def count(m):
        return sum(p.numel() for p in m.parameters())
    return (count(OnlineNetwork(cfg, projection_dim, prediction_dim,
                                device="meta")),
            count(TargetNetwork(cfg, projection_dim, device="meta")))


def phase_k4() -> dict:
    """K4 over the full flat BYOL parameter set against the plain
    version, with a clipping grad norm."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, n_ema = byol_sizes(WavLMConfig.large())
    spec = fused_optimizer.FusedAdamWSpec(schedule=1e-5)
    p = torch.randn(n, generator=gen, device=dev)
    g = 1e-3 * torch.randn(n, generator=gen, device=dev)
    mu = 1e-3 * torch.randn(n, generator=gen, device=dev)
    nu = 1e-6 * torch.rand(n, generator=gen, device=dev)
    pt = p[:n_ema] + 1e-3 * torch.randn(n_ema, generator=gen, device=dev)
    grad_norm = torch.tensor(2.5, device=dev)  # above the clip norm 1.0
    ref = None
    with torch.no_grad():
        sc = fused_optimizer.scalars(spec, 3, grad_norm)
        ref = fused_optimizer.adamw_ema_plain(sc, g, p, mu, nu, pt)
        fused_optimizer.fused_adamw_ema_update(g, p, mu, nu, pt, spec, 3,
                                               grad_norm)
        torch.cuda.synchronize()
    errs = {k: rel_err(a, b) for k, a, b in zip(
        ("p", "mu", "nu", "target"), (p, mu, nu, pt), ref)}
    abs_err = max(float((a - b).abs().max())
                  for a, b in zip((p, mu, nu, pt), ref))
    log(f"[K4] {n / 1e6:.1f} M params ({n_ema / 1e6:.1f} M with EMA): "
        f"max|Δ|/max|ref| vs plain " +
        ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if max(errs.values()) > OPT_TOL:
        raise RuntimeError(f"K4 disagrees with its plain version: {errs}")
    del ref
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_optimizer._kernel(sc, g, p, mu, nu, pt),
                     iters=10)
        plain_ms = cuda_ms(lambda: fused_optimizer.adamw_ema_plain(
            sc, g, p, mu, nu, pt), iters=5, warmup=1)
    nbytes = 4.0 * (7 * n + 2 * n_ema)
    log(f"[K4] kernel {ms * 1e3:.1f} us/call ({_gbps(nbytes, ms):.0f} GB/s), "
        f"plain {plain_ms * 1e3:.1f} us/call "
        f"({_gbps(nbytes, plain_ms):.0f} GB/s)")
    return {"name": "fused_adamw_ema", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/fused_adamw_ema.cu",
            "replaces": "nrse_tpu/ops/fused_optimizer.py:75",
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


def _train_batch(n: int, clip_seconds: float, device, seed: int = 0):
    """Synthetic clean speech, noise and SNRs as ``bench.py`` makes
    them."""
    rng = np.random.default_rng(seed)
    t = int(SAMPLE_RATE * clip_seconds)
    ax = np.arange(t) / SAMPLE_RATE
    clean = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300, (n, 1)) * ax)
             + 0.02 * rng.standard_normal((n, t))).astype(np.float32)
    noise = (0.2 * rng.standard_normal((n, t))).astype(np.float32)
    snr = rng.choice([2.0, 5.0, 10.0, 15.0, 20.0], n).astype(np.float32)
    return {k: torch.from_numpy(v).to(device)
            for k, v in (("clean", clean), ("noise", noise), ("snr", snr))}


def _adamw_spec():
    """The JAX preset's optimizer: lr 1e-5 cosine over 100000 steps, wd
    1e-5, clip 1.0, EMA 0.997 (``bench.py:1037-1075``)."""
    return fused_optimizer.FusedAdamWSpec(
        schedule=cosine_annealing(1e-5, 100000), weight_decay=1e-5,
        clip_norm=1.0, ema_decay=0.997)


def _reset_counts() -> None:
    block_attention.LAUNCHES = 0
    fused_ffn.LAUNCHES = fused_ffn.DX_LAUNCHES = fused_ffn.DW_LAUNCHES = 0
    fused_dropout.LAUNCHES = 0
    fused_optimizer.LAUNCHES = 0


def _train_counts() -> dict:
    return {"fused_ffn_fwd": fused_ffn.LAUNCHES,
            "fused_ffn_bwd_dx": fused_ffn.DX_LAUNCHES,
            "fused_ffn_bwd_dw": fused_ffn.DW_LAUNCHES,
            "fused_dropout": fused_dropout.LAUNCHES,
            "fused_adamw_ema": fused_optimizer.LAUNCHES,
            "block_attention_fwd": block_attention.LAUNCHES}


def phase_training(cfg=None, device=torch.device("cuda"),
                   batch: int = TRAIN_BATCH,
                   clip_seconds: float = CLIP_SECONDS, warmup: int = 2,
                   steps: int = 5, projection_dim: int = 1024,
                   prediction_dim: int = 2048) -> dict:
    """The BYOL train step at full width with the JAX preset's
    hyper-parameters (dropout 0.1 at every site, LayerDrop 0.1,
    SpecAugment 0.05/10/2: ``WavLMConfig``'s defaults); its arguments let
    it be rehearsed at a small width on the CPU, with the wrappers' plain
    paths standing in."""
    cfg = cfg or WavLMConfig.large()
    t0 = time.perf_counter()
    sd = init_byol_state_dict(cfg, projection_dim, prediction_dim,
                              torch.Generator().manual_seed(SEED))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = create_train_state(cfg, sd, projection_dim, prediction_dim,
                               device, seed=SEED, compute_dtype=dtype)
    del sd
    step = make_byol_train_step(_adamw_spec())
    data = _train_batch(batch, clip_seconds, device)
    log(f"[train] BYOL on WavLM {cfg.num_hidden_layers} x "
        f"{cfg.hidden_size}, projection {projection_dim}, prediction "
        f"{prediction_dim}: {state.params.numel() / 1e6:.1f} M online "
        f"params, {state.target_params.numel() / 1e6:.1f} M target; batch "
        f"{batch} x {clip_seconds:g} s; set up in "
        f"{time.perf_counter() - t0:.1f} s")

    def check(m, when):
        if not bool(m["finite"]):
            raise RuntimeError(f"non-finite loss or grad norm {when}: "
                               f"{float(m['loss'])} {float(m['grad_norm'])}")

    for i in range(warmup):
        if i == warmup - 1:  # the EMA of this step is checked exactly
            target_before = state.target_params.clone()
        m = step(state, data)
        check(m, f"at warm-up step {i}")
        log(f"[train] warm-up step {i}: loss {float(m['loss']):.6f}, "
            f"grad_norm {float(m['grad_norm']):.4f}, layers run "
            f"{m['layers_online']}/{m['layers_target']}")
    with torch.no_grad():  # in float32, as K4 rounds it
        ema = torch.tensor(_adamw_spec().ema_decay, dtype=torch.float32,
                           device=device)
        want = (ema * target_before
                + (1.0 - ema) * state.params[:target_before.numel()])
        ema_err = float((state.target_params - want).abs().max())
    del target_before, want
    log(f"[train] target after a step vs ema·target + (1−ema)·online: "
        f"max|Δ| {ema_err:.3e}")
    if ema_err != 0.0:
        raise RuntimeError(f"the target did not move by the EMA: {ema_err}")

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    metrics = [step(state, data) for _ in range(steps)]
    _sync(device)
    dt = (time.perf_counter() - t0) / steps
    counts = _train_counts()
    for i, m in enumerate(metrics):
        check(m, f"at timed step {i}")
    on = sum(m["layers_online"] for m in metrics)
    tg = sum(m["layers_target"] for m in metrics)
    want = {"fused_ffn_fwd": on + tg, "fused_ffn_bwd_dx": on,
            "fused_ffn_bwd_dw": on,
            # encoder site + 2 per layer run; the online tower's again in
            # its backward
            "fused_dropout": 2 * (steps + 2 * on) + steps + 2 * tg,
            "fused_adamw_ema": steps, "block_attention_fwd": 0}
    log(f"[train] {steps} timed steps, layers run online {on}, target {tg}: "
        f"launches {counts} (want {want})")
    if counts != want:
        raise RuntimeError(f"kernel launches {counts} != {want}")
    log(f"[train] losses {[round(float(m['loss']), 6) for m in metrics]}, "
        f"grad norms {[round(float(m['grad_norm']), 4) for m in metrics]}")
    log(f"[train] {dt:.4f} s/step, {batch * clip_seconds / dt:.1f} "
        f"audio-sec/sec")
    if device.type == "cuda":
        log(f"[train] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    loss, sim = make_byol_eval_step()(state, data)
    _sync(device)
    if loss.shape != (batch,) or sim.shape != (batch,) or not (
            torch.isfinite(loss).all() and torch.isfinite(sim).all()):
        raise RuntimeError("bad eval step output")
    log(f"[eval] loss {float(loss.mean()):.6f}, clean-noisy cosine "
        f"{float(sim.mean()):.6f} (mean over {batch})")
    return counts


def _crosscheck_step(cfg, sd, batch: int, heads_on_batch_stats: bool):
    """One train step of the same weights and batch in bf16 on the card
    and in float32 on the CPU: ``(loss, grad_norm)`` of each, and the
    cosines of the whole flat gradient and of its encoder part."""
    grads, out = [], []
    for device, dtype in ((torch.device("cuda"), torch.bfloat16),
                          (torch.device("cpu"), torch.float32)):
        state = create_train_state(cfg, sd, 1024, 2048, device, seed=SEED,
                                   compute_dtype=dtype)
        if not heads_on_batch_stats:
            for head in (state.online.projector, state.online.predictor,
                         state.target.projector):
                head.eval()
        m = make_byol_train_step(_adamw_spec())(
            state, _train_batch(batch, CLIP_SECONDS, device, seed=1))
        out.append((float(m["loss"]), float(m["grad_norm"])))
        grads.append(state.grads.detach().double().cpu())
        n_enc = sum(p.numel() for p in state.online.encoder.parameters())
        del state
    cos = torch.nn.functional.cosine_similarity
    return (out, float(cos(grads[0], grads[1], dim=0)),
            float(cos(grads[0][:n_enc], grads[1][:n_enc], dim=0)))


def phase_crosscheck(layers: int = 4, batch: int = 2) -> None:
    """One train step at full width and ``layers`` deep, random features
    off, in bf16 on the card against float32 on the CPU through the plain
    paths, from the same weights and batch.  The bound holds the step
    with the heads' BatchNorm on its running statistics: over a batch of
    2, BatchNorm on batch statistics divides each feature by half the
    difference of its two values, and its backward magnifies bf16's
    rounding of the pooled embeddings until the gradient's direction is
    lost (bf16 against float32, both on the CPU, gives a cosine of -0.34
    there; PERF.md).  That step is measured and printed too."""
    cfg = WavLMConfig.large(num_hidden_layers=layers, hidden_dropout=0.0,
                            activation_dropout=0.0, attention_dropout=0.0,
                            layerdrop=0.0, mask_time_prob=0.0)
    sd = init_byol_state_dict(cfg, 1024, 2048,
                              torch.Generator().manual_seed(SEED + 5))
    torch.set_num_threads(os.cpu_count() or 1)
    for on_batch_stats in (False, True):
        ((loss_c, gn_c), (loss_f, gn_f)), cos, cos_enc = _crosscheck_step(
            cfg, sd, batch, on_batch_stats)
        stats = "batch statistics, not held to a bound" if on_batch_stats \
            else f"running statistics, cosine >= {COSINE_MIN}"
        log(f"[crosscheck] {layers} layers, batch {batch}, heads' BN on "
            f"{stats}: loss bf16 card {loss_c:.6f} vs f32 CPU {loss_f:.6f} "
            f"(Δ {loss_c - loss_f:.3e}); grad_norm ratio {gn_c / gn_f:.6f}; "
            f"gradient cosine {cos:.6f} (encoder part {cos_enc:.6f})")
        if not on_batch_stats and cos < COSINE_MIN:
            raise RuntimeError(f"gradient cosine {cos} < {COSINE_MIN}")


def main() -> int:
    name = phase_device()
    phase_build()
    kernels = [phase_kernel_a(), phase_kernel_b(), phase_k1(), *phase_k2(),
               phase_k4()]
    launches = phase_serving()
    launches.update({k: v for k, v in phase_training().items()
                     if k not in launches})
    phase_crosscheck()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
