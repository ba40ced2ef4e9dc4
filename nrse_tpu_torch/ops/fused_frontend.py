"""Fused stride-2 conv + channel LayerNorm + exact GELU (K6's wrapper).

Port of ``nrse_tpu/ops/fused_frontend.py`` (``fused_conv_ln_gelu`` and the
custom VJP of its ``_fwd_kernel`` / ``_bwd_kernel``): layers 1–6 of
wavlm-large's conv frontend.  Arguments keep JAX's order and layouts:
``x [B, T_in, C]`` channels-last, ``kernel [k, C_in, C_out]`` (flax
``nn.Conv``; the model hands its state-dict weight ``[C_out, C_in, k]``
permuted), ``bias``, ``scale`` and ``ln_bias`` ``[C]``.  With ``T_out =
(T_in − k) // 2 + 1``:

    z[t]  = Σ_j x[2t + j] · kernel[j] + bias        float32 accumulation
    x̂[t]  = (z[t] − mean) · rstd                    float32 statistics
    out[t] = gelu(x̂[t] · scale + ln_bias)           exact erf

The forward saves ``x``, ``x̂`` (x's dtype) and ``rstd`` (float32 ``[B,
T_out, 1]``), not the float32 ``z``.  The backward recomputes ``ln = x̂ ·
scale + ln_bias`` from ``x̂``, as the TPU kernel does, and gives

    dln = dout · gelu′(ln);  dscale = Σ dln · x̂;  dln_bias = Σ dln
    dz  = rstd · (dln·scale − mean(dln·scale) − x̂ · mean(dln·scale·x̂))
    dbias = Σ dz;  dz rounded to x's dtype for the products
    dx[2t + j] += dz[t] · kernel[j]ᵀ;  dkernel[j] = Σ_t x[2t + j]ᵀ · dz[t]

Supported by the CUDA kernels (``csrc/fused_frontend.cu``, K6, on wgmma +
TMA): stride 2, k ∈ {2, 3}, C_in == C_out == 512 (a forward block holds
all 512 output channels of its rows, so that the LayerNorm sees whole rows
without leaving the chip), bf16 activations.  :func:`fwd_plan` and
:func:`bwd_plan` give what the kernels are launched with, :func:`tma_maps`
the geometry of the tensor maps they read through (handed to the C
entries by :func:`map_geometry`).  The wrapper raises on anything else
for a CUDA tensor; there is no fallback.  For CPU tensors the plain versions
:func:`conv_ln_gelu_plain_fwd` and :func:`conv_ln_gelu_plain_bwd` run at
any k ≥ 1 and C.  Both round the products' operands to x's dtype and sum
in float32, and take the LayerNorm on the unrounded float32 sum; dx is one
float32 sum of all its taps, rounded once (the JAX wrapper rounds each
tap's part, then adds).  The kernel takes the variance as JAX's does,
``max(E[z²] − E[z]², 0)``; the plain forward in two passes
(``ops.pallas_norm.row_stats``, for the reason given there).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.ops.fused_ffn import gelu_grad
from nrse_tpu_torch.ops.pallas_norm import partial_rows, row_stats
from nrse_tpu_torch.runtime import cuda_build

STRIDE = 2
KERNEL_SIZES = (2, 3)
CHANNELS = 512  # the C the CUDA kernels tile: all of a row's channels
SMEM_LIMIT = 232_448  # shared memory a block may have on an H100
K_TILE = 64  # bf16 of K a stage: one 128-byte swizzle row
# the forward: a block owns 64 rows and all channels: a ring of 3 stages of
# x's 64 x 64 and W's 512 x 64, barriers, the statistics' partials
FWD_ROWS = 64
FWD_STAGES = 3
FWD_SMEM = (1024 + FWD_STAGES * (FWD_ROWS + CHANNELS) * K_TILE * 2
            + 2 * FWD_STAGES * 8 + 2 * 2 * FWD_ROWS * 4)
# the backward's products: 128 x 256 output tiles, 4 stages of 48 KB
BWD_TILE_M = 128
BWD_TILE_N = 256
BWD_STAGES = 4
BWD_SMEM = (1024 + BWD_STAGES * (BWD_TILE_M + BWD_TILE_N) * K_TILE * 2
            + 2 * BWD_STAGES * 8)

# Kernel launches since the counts were last reset: K6's forward, K6's
# backward (one count per backward call: its row pass, dx product, dW
# product and the folds of their partials).
LAUNCHES = 0
BWD_LAUNCHES = 0


def out_length(t_in: int, k: int) -> int:
    return (t_in - k) // STRIDE + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_plan(b: int, t_in: int, k: int, sms: int) -> dict:
    """How K6's forward is launched on a card of ``sms`` SMs: persistent
    blocks (one an SM, at most one a tile) walk the 64-row tiles of every
    batch; ``grid`` blocks of ``smem`` bytes."""
    tiles = b * _cdiv(out_length(t_in, k), FWD_ROWS)
    return {"tiles": tiles, "grid": max(1, min(tiles, sms)),
            "k_tiles": k * CHANNELS // K_TILE, "smem": FWD_SMEM}


def dw_chunks(tiles: int, sms: int) -> int:
    """The dW product's row chunks for ``tiles`` output tiles on ``sms``
    SMs: the fewest, up to two waves of blocks, whose blocks fill the
    waves they take best."""
    best, chunks = -1.0, 1
    for c in range(1, max(1, 2 * sms // tiles) + 1):
        fill = tiles * c / (sms * _cdiv(tiles * c, sms))
        if fill > best + 1e-9:
            best, chunks = fill, c
    return chunks


def bwd_plan(b: int, t_in: int, k: int, sms: int) -> dict:
    """How K6's backward is launched on a card of ``sms`` SMs: the row
    pass's partial rows, the dx product's 128-pair-row x 256-column tiles
    (4 a pair-row tile: two halves of a pair, two column halves) over
    persistent blocks, the dW product's 128 x 256 tiles of ``[k C, C]``
    times its row chunks (one block each), the 64-row K-tiles the chunks
    split, the f32 partials' bytes, and the products' shared memory."""
    c = CHANNELS
    t_out = out_length(t_in, k)
    rows = b * t_out
    dx_tiles = b * _cdiv(_cdiv(t_in, 2), BWD_TILE_M) * 4
    dw_tiles = (k * c // BWD_TILE_M) * (c // BWD_TILE_N)
    chunks = dw_chunks(dw_tiles, sms)
    return {"row_partials": partial_rows(rows),
            "dx_tiles": dx_tiles, "dx_grid": max(1, min(dx_tiles, sms)),
            "dw_tiles": dw_tiles, "dw_chunks": chunks,
            "dw_grid": (dw_tiles, chunks),
            "k_tiles": b * _cdiv(t_out, K_TILE),
            "dw_part_bytes": chunks * k * c * c * 4, "smem": BWD_SMEM}


def tma_maps(b: int, t_in: int, k: int) -> dict:
    """The 3-D tensor maps the kernels read x and dz through, as ``name:
    (tensor, first element, dims, strides, box)``: element offsets into
    the named row-major tensor, dims, strides and box innermost first
    (channel, row, batch).  x's taps: row t of batch b is x[b, 2t ..], taps
    0-1 2C wide, tap 2 C wide from x + 2C (the forward and the dW product);
    dz [B, T_out, C], the products' operand.  out, x̂ and dx are stored by
    threads from staging tiles."""
    c = CHANNELS
    t_out = out_length(t_in, k)
    rows_out = ((c, t_out, b), (1, c, t_out * c))
    box = (K_TILE, 64, 1)
    maps = {"x_taps01": ("x", 0, (2 * c, t_out, b), (1, 2 * c, t_in * c),
                         box),
            "dz_dx": ("dz", 0, *rows_out, (K_TILE, BWD_TILE_M, 1)),
            "dz_dw": ("dz", 0, *rows_out, box)}
    if k == 3:
        maps["x_tap2"] = ("x", 2 * c, (c, t_out, b), (1, 2 * c, t_in * c),
                          box)
    return maps


# The maps each C entry takes, in order (k = 2 has no tap 2: taps 0-1
# stand in its place, never read).
FWD_MAPS = ("x_taps01", "x_tap2")
BWD_MAPS = ("dz_dx", "x_taps01", "x_tap2", "dz_dw")


def map_geometry(b: int, t_in: int, k: int, names) -> list:
    """The C entries' map words: for each of ``names`` the :func:`tma_maps`
    entry's first element, dims, strides and box, innermost first, as the
    kernels' tensor maps are made from them."""
    maps = tma_maps(b, t_in, k)
    words = []
    for name in names:
        _, first, dims, strides, box = maps.get(name, maps["x_taps01"])
        words += [first, *dims, *strides, *box]
    return words


def _map_words(b: int, t_in: int, k: int, names):
    words = map_geometry(b, t_in, k, names)
    return (ctypes.c_longlong * len(words))(*words)


def conv_ln_gelu_plain_fwd(x, kernel, bias, scale, ln_bias, eps: float):
    """Plain PyTorch forward: ``(out, xhat, rstd)``; out and xhat in x's
    dtype, rstd float32 ``[B, T_out, 1]``."""
    dt = x.dtype
    w = kernel.to(dt).float().permute(2, 1, 0)          # [C_out, C_in, k]
    z = F.conv1d(x.float().transpose(1, 2), w, stride=STRIDE)
    z = z.transpose(1, 2).contiguous() + bias.float()    # [B, T_out, C]
    mean, rstd = row_stats(z, eps)
    xh = (z - mean) * rstd
    ln = xh * scale.float() + ln_bias.float()
    out = F.gelu(ln, approximate="none")
    return out.to(dt), xh.to(dt), rstd


def conv_ln_gelu_plain_bwd(dout, x, xhat, rstd, kernel, scale, ln_bias):
    """Plain PyTorch backward: ``(dx, dkernel, dbias, dscale, dln_bias)``,
    dx in x's dtype, the rest float32."""
    dt = x.dtype
    k = kernel.shape[0]
    b, t_in, _ = x.shape
    t_out = xhat.shape[1]
    xh = xhat.float()
    gamma = scale.float()
    dln = dout.float() * gelu_grad(xh * gamma + ln_bias.float())
    dscale = (dln * xh).sum((0, 1))
    dln_bias = dln.sum((0, 1))
    dxh = dln * gamma
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xh).mean(-1, keepdim=True)
    dz = rstd * (dxh - m1 - xh * m2)
    dbias = dz.sum((0, 1))
    dzb = dz.to(dt).float()
    w = kernel.to(dt).float().permute(2, 1, 0)          # [C_out, C_in, k]
    dx = F.conv_transpose1d(dzb.transpose(1, 2), w, stride=STRIDE)
    dx = F.pad(dx, (0, t_in - dx.shape[-1])).transpose(1, 2)
    dw = torch.nn.grad.conv1d_weight(x.float().transpose(1, 2), w.shape,
                                     dzb.transpose(1, 2), stride=STRIDE)
    return dx.to(dt), dw.permute(2, 1, 0), dbias, dscale, dln_bias


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_kernel(x, kernel, *vecs):
    k, c_in, c_out = kernel.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K6 takes bf16 activations, got {x.dtype}")
    if k not in KERNEL_SIZES or c_in != c_out or c_in != CHANNELS:
        raise ValueError(f"K6 takes a stride-2 conv of kernel size "
                         f"{KERNEL_SIZES} with C_in == C_out == {CHANNELS}, "
                         f"got kernel {tuple(kernel.shape)}")
    if any(t.device != x.device for t in (kernel, *vecs)):
        raise ValueError("x and the layer's parameters must share a device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K6 takes a contiguous, 16-byte aligned x")
    return k


def _f32(v):
    return v.to(torch.float32).contiguous()


def fwd_weight(kernel):
    """The forward's weight operand ``[C_out, k·C_in]`` bf16: row o holds
    tap j's column o at ``j·C + c``, so that one pair row of x (and the
    next pair's first half for tap 2) is a contiguous run of the input."""
    k, c, c_out = kernel.shape
    w = torch.empty(c_out, k * c, dtype=torch.bfloat16, device=kernel.device)
    w.view(c_out, k, c).copy_(kernel.permute(2, 0, 1))
    return w


def bwd_weight(kernel):
    """The backward's weight operand: ``kernel [k, C_in, C_out]`` in
    bf16."""
    w = torch.empty(kernel.shape, dtype=torch.bfloat16, device=kernel.device)
    w.copy_(kernel)
    return w


def _kernel_fwd(x, kernel, bias, scale, ln_bias, eps: float, save: bool):
    """K6's forward: ``(out, xhat, rstd)``, xhat and rstd None unless
    ``save``."""
    require_no_grad(x, kernel, bias, scale, ln_bias, what="fused_frontend_fwd")
    k = _check_kernel(x, kernel, bias, scale, ln_bias)
    b, t_in, c = x.shape
    t_out = out_length(t_in, k)
    if t_out < 1:
        raise ValueError(f"T_in={t_in} is shorter than the kernel ({k})")
    w = fwd_weight(kernel)
    bias, scale, ln_bias = _f32(bias), _f32(scale), _f32(ln_bias)
    out = torch.empty(b, t_out, c, dtype=torch.bfloat16, device=x.device)
    xhat = torch.empty_like(out) if save else None
    rstd = (torch.empty(b, t_out, 1, dtype=torch.float32, device=x.device)
            if save else None)
    plan = fwd_plan(b, t_in, k, _sms(x.device))
    maps = _map_words(b, t_in, k, FWD_MAPS)
    lib = cuda_build.load()
    with cuda_build.on_device(x.device):
        err = lib.nrse_fused_frontend_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            ln_bias.data_ptr(), out.data_ptr(),
            0 if xhat is None else xhat.data_ptr(),
            0 if rstd is None else rstd.data_ptr(), ctypes.addressof(maps),
            b, t_in, t_out, k, float(eps), plan["grid"], plan["smem"],
            _stream())
    cuda_build.check(err, "fused_frontend_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, xhat, rstd


def _kernel_bwd(dout, x, xhat, rstd, kernel, scale, ln_bias):
    """K6's backward: ``(dx, dkernel, dbias, dscale, dln_bias)``."""
    k = _check_kernel(x, kernel, scale, ln_bias)
    b, t_in, c = x.shape
    t_out = xhat.shape[1]
    dev = x.device
    dout = dout.to(torch.bfloat16).contiguous()
    wk = bwd_weight(kernel)
    scale, ln_bias = _f32(scale), _f32(ln_bias)
    plan = bwd_plan(b, t_in, k, _sms(dev))
    maps = _map_words(b, t_in, k, BWD_MAPS)
    dz = torch.empty(b, t_out, c, dtype=torch.bfloat16, device=dev)
    dx = torch.empty_like(x)
    dkernel = torch.empty(k, c, c, dtype=torch.float32, device=dev)
    vecs = torch.empty(3, c, dtype=torch.float32, device=dev)  # dγ, dβ, db
    vec_part = torch.empty(3, plan["row_partials"], c, dtype=torch.float32,
                           device=dev)
    dw_part = torch.empty(plan["dw_chunks"], k * c, c, dtype=torch.float32,
                          device=dev)
    lib = cuda_build.load()
    with cuda_build.on_device(dev):
        err = lib.nrse_fused_frontend_bwd(
            dout.data_ptr(), x.data_ptr(), xhat.data_ptr(), rstd.data_ptr(),
            wk.data_ptr(), scale.data_ptr(), ln_bias.data_ptr(),
            dz.data_ptr(), dx.data_ptr(), dkernel.data_ptr(),
            vecs.data_ptr(), vec_part.data_ptr(), dw_part.data_ptr(),
            ctypes.addressof(maps), b, t_in, t_out, k, plan["dx_grid"],
            plan["dw_chunks"], plan["smem"], _stream())
    cuda_build.check(err, "fused_frontend_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dx, dkernel, vecs[2], vecs[0], vecs[1]


def _forward(x, kernel, bias, scale, ln_bias, eps, save):
    if x.device.type == "cuda":
        return _kernel_fwd(x, kernel, bias, scale, ln_bias, eps, save)
    if x.device.type != "cpu":
        raise ValueError(f"no fused frontend for device {x.device}")
    return conv_ln_gelu_plain_fwd(x, kernel, bias, scale, ln_bias, eps)


class FusedConvLnGelu(torch.autograd.Function):
    """K6 forward and backward on the card, the plain versions on the CPU;
    saves x, x̂ and rstd."""

    @staticmethod
    def forward(ctx, x, kernel, bias, scale, ln_bias, eps):
        out, xhat, rstd = _forward(x, kernel, bias, scale, ln_bias, eps,
                                   save=True)
        ctx.save_for_backward(x, xhat, rstd, kernel, scale, ln_bias)
        ctx.dtypes = (kernel.dtype, bias.dtype, scale.dtype, ln_bias.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, xhat, rstd, kernel, scale, ln_bias = ctx.saved_tensors
        if x.device.type == "cuda":
            grads = _kernel_bwd(dout, x, xhat, rstd, kernel, scale, ln_bias)
        else:
            grads = conv_ln_gelu_plain_bwd(dout.to(x.dtype), x, xhat, rstd,
                                           kernel, scale, ln_bias)
        dx, *rest = grads
        return (dx, *(g.to(t) for g, t in zip(rest, ctx.dtypes)), None)


def fused_conv_ln_gelu(x, kernel, bias, scale, ln_bias, eps: float = 1e-5):
    """Stride-2 Conv1d + channel LayerNorm + exact GELU of ``x [B, T_in,
    C]`` with ``kernel [k, C, C]``: ``[B, T_out, C]`` in x's dtype;
    differentiable in x and the four parameters."""
    k, c_in, c_out = kernel.shape
    if x.dim() != 3 or x.shape[-1] != c_in or any(
            v.shape != (c_out,) for v in (bias, scale, ln_bias)):
        raise ValueError(f"fused_conv_ln_gelu: x {tuple(x.shape)}, kernel "
                         f"{tuple(kernel.shape)}, bias {tuple(bias.shape)}, "
                         f"scale {tuple(scale.shape)}, ln_bias "
                         f"{tuple(ln_bias.shape)}")
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, kernel, bias, scale, ln_bias)):
        return FusedConvLnGelu.apply(x, kernel, bias, scale, ln_bias, eps)
    return _forward(x, kernel, bias, scale, ln_bias, eps, save=False)[0]
