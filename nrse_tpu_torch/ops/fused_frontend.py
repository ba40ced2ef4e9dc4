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

Supported by the CUDA kernels (``csrc/fused_frontend.cu``, K6): stride 2,
k ∈ {2, 3}, C_in == C_out == 512 (a block holds all 512 output channels of
its rows, so that the LayerNorm sees whole rows without leaving the
chip), bf16 activations.  The wrapper raises on anything else for a CUDA
tensor; there is no fallback.  For CPU tensors the plain versions
:func:`conv_ln_gelu_plain_fwd` and :func:`conv_ln_gelu_plain_bwd` run at
any k ≥ 1 and C.  Both round the products' operands to x's dtype and sum
in float32, and take the LayerNorm on the unrounded float32 sum; dx is one
float32 sum of all its taps, rounded once (the JAX wrapper rounds each
tap's part, then adds).  The kernel takes the variance as JAX's does,
``max(E[z²] − E[z]², 0)``; the plain forward in two passes
(``ops.pallas_norm.row_stats``, for the reason given there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.ops.fused_ffn import gelu_grad
from nrse_tpu_torch.ops.pallas_norm import partial_rows, row_stats
from nrse_tpu_torch.runtime import cuda_build

STRIDE = 2
KERNEL_SIZES = (2, 3)
CHANNELS = 512  # the C the CUDA kernels tile: all of a row's channels
# the dW product's fixed number of row chunks (its float32 partials are
# DW_SPLIT · k · C² · 4 bytes whatever B·T is)
DW_SPLIT = 8

# Kernel launches since the counts were last reset: K6's forward, K6's
# backward (one count per backward call: its row pass, dx product, dW
# product and the folds of their partials).
LAUNCHES = 0
BWD_LAUNCHES = 0


def out_length(t_in: int, k: int) -> int:
    return (t_in - k) // STRIDE + 1


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
    lib = cuda_build.load()
    with torch.cuda.device(x.device):
        err = lib.nrse_fused_frontend_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            ln_bias.data_ptr(), out.data_ptr(),
            0 if xhat is None else xhat.data_ptr(),
            0 if rstd is None else rstd.data_ptr(), b, t_in, t_out, k,
            float(eps), _stream())
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
    rows = b * t_out
    dz = torch.empty(b, t_out, c, dtype=torch.bfloat16, device=dev)
    dx = torch.empty_like(x)
    dkernel = torch.empty(k, c, c, dtype=torch.float32, device=dev)
    vecs = torch.empty(3, c, dtype=torch.float32, device=dev)  # dγ, dβ, db
    vec_part = torch.empty(3, partial_rows(rows), c, dtype=torch.float32,
                           device=dev)
    dw_part = torch.empty(DW_SPLIT, k * c, c, dtype=torch.float32,
                          device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.nrse_fused_frontend_bwd(
            dout.data_ptr(), x.data_ptr(), xhat.data_ptr(), rstd.data_ptr(),
            wk.data_ptr(), scale.data_ptr(), ln_bias.data_ptr(),
            dz.data_ptr(), dx.data_ptr(), dkernel.data_ptr(),
            vecs.data_ptr(), vec_part.data_ptr(), dw_part.data_ptr(), b,
            t_in, t_out, k, DW_SPLIT, _stream())
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
