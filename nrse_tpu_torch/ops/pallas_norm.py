"""Channel LayerNorm over the last axis (K7's wrapper), differentiable.

Port of ``nrse_tpu/ops/pallas_norm.py`` (``pallas_channel_layernorm`` and
the custom VJP of its ``_fwd_kernel`` / ``_bwd_kernel``): flax's
LayerNorm arithmetic, float32 statistics with the fast variance
``max(E[x²] − E[x]², 0)``, ε inside the rsqrt, the affine in float32, the
result rounded to x's dtype.  The forward saves the per-row ``mean`` and
``inv`` (float32 ``[N, 1]``); the backward recomputes ``x̂`` from them:

    g  = dy · scale
    dx = inv · (g − mean(g) − x̂ · mean(g · x̂))
    dscale = Σ_rows dy · x̂,   dbias = Σ_rows dy

The WavLM frontend normalises layer 0's conv output ``[B, T, 512]`` with it
(``models/wavlm.py``).  For CUDA tensors (bf16, C a multiple of 8 up to
1024) the forward and backward are K7, ``csrc/channel_layernorm.cu``: one
warp per row, and dscale/dbias as per-block partials summed in a fixed
order, so two calls give the same bits.  For CPU tensors they are
:func:`channel_layernorm_plain_fwd` and :func:`channel_layernorm_plain_bwd`.
There is no fallback from one to the other.  The JAX wrapper pads N to a
multiple of 512 for its BlockSpec; the kernel masks its own ragged last
block, so nothing is padded here.

The plain forward takes the variance in two passes, ``E[(x − E[x])²]``,
as torch's LayerNorm does; the kernel keeps the fast variance.  Both agree
within float32 rounding where a row's mean is not far above its spread,
as on the frontend's rows (|mean| / std ≤ 0.14 at layer 0; ``chip_smoke.py``
holds K7's mean and inv to the plain version's within 1e-4 and measures
it against a two-pass LayerNorm on real frames).  The BYOL step's
comparison with JAX (``tests/test_torch_train_step.py``: parameter
updates after two Adam steps, 1e-4 of their scale) sits at float32's
rounding floor and passes with this order only: with every row's rstd
scaled by 1 ± 2⁻²³ it reads 3.4e-4, with ``torch.var_mean``'s two-pass
3.1e-4, with the fast variance 3.5e-4 (6.8e-4 with its sums in float64).
None of these is less accurate than another.
"""

from __future__ import annotations

import torch

from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.runtime import cuda_build

# the CUDA kernel: one warp per row, 8 channels per lane per 16-byte load
MAX_C = 1024

# Kernel launches since the counts were last reset: K7's forward, its
# backward.
LAUNCHES = 0
BWD_LAUNCHES = 0


def row_stats(x, eps: float):
    """Per-row ``(mean, rstd)`` of float32 ``x`` over its last axis,
    float32 ``[..., 1]``, the variance taken in two passes (the plain
    versions' statistics: see the module's note)."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def channel_layernorm_plain_fwd(x2, scale, bias, eps: float):
    """Plain PyTorch forward of ``x2 [N, C]``: ``(out, mean, inv)``, out in
    x's dtype, mean and inv float32 ``[N, 1]``."""
    x = x2.float()
    mean, inv = row_stats(x, eps)
    out = (x - mean) * inv * scale.float() + bias.float()
    return out.to(x2.dtype), mean, inv


def channel_layernorm_plain_bwd(dy, x2, mean, inv, scale):
    """Plain PyTorch backward (the arithmetic of the TPU's ``_bwd_kernel``):
    ``(dx, dscale, dbias)``, dx in x's dtype, the rest float32."""
    x = x2.float()
    dyf = dy.float()
    xhat = (x - mean) * inv
    g = dyf * scale.float()
    g_mean = g.mean(-1, keepdim=True)
    gx_mean = (g * xhat).mean(-1, keepdim=True)
    dx = inv * (g - g_mean - xhat * gx_mean)
    return (dx.to(x2.dtype), (dyf * xhat).sum(0), dyf.sum(0))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_kernel(x2, *vecs):
    n, c = x2.shape
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"K7 takes bf16 rows, got {x2.dtype}")
    if c % 8 or c > MAX_C:
        raise ValueError(f"K7 takes C a multiple of 8 up to {MAX_C}, got {c}")
    if any(v.device != x2.device for v in vecs):
        raise ValueError("x and the LayerNorm's parameters must share a "
                         "device")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("K7 takes contiguous, 16-byte aligned rows")
    return n, c


def _f32(v):
    return v.to(torch.float32).contiguous()


def _kernel_fwd(x2, scale, bias, eps: float, save: bool):
    """K7's forward: ``(out, mean, inv)``, mean and inv None unless
    ``save``."""
    require_no_grad(x2, scale, bias, what="channel_layernorm_fwd")
    n, c = _check_kernel(x2, scale, bias)
    scale, bias = _f32(scale), _f32(bias)
    out = torch.empty_like(x2)
    mean = inv = None
    if save:
        mean = torch.empty(n, 1, dtype=torch.float32, device=x2.device)
        inv = torch.empty_like(mean)
    lib = cuda_build.load()
    with torch.cuda.device(x2.device):
        err = lib.nrse_channel_layernorm_fwd(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            0 if mean is None else mean.data_ptr(),
            0 if inv is None else inv.data_ptr(), n, c, float(eps),
            _stream())
    cuda_build.check(err, "channel_layernorm_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, mean, inv


def partial_rows(n: int) -> int:
    """Rows of the partial sums the row backward of ``row_layernorm.cuh``
    (K7's, and K6's row pass) writes: one per block of its grid, a fixed
    function of the row count alone."""
    return max(1, min(512, -(-n // 8)))


def _kernel_bwd(dy, x2, mean, inv, scale):
    """K7's backward: ``(dx, dscale, dbias)``."""
    n, c = _check_kernel(x2, scale)
    dy = dy.to(torch.bfloat16).contiguous()
    scale = _f32(scale)
    dev = x2.device
    dx = torch.empty_like(x2)
    dvec = torch.empty(2, c, dtype=torch.float32, device=dev)  # dscale, dbias
    part = torch.empty(2, partial_rows(n), c, dtype=torch.float32, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        err = lib.nrse_channel_layernorm_bwd(
            dy.data_ptr(), x2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            scale.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
            part.data_ptr(), n, c, _stream())
    cuda_build.check(err, "channel_layernorm_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dx, dvec[0], dvec[1]


def _forward(x2, scale, bias, eps, save):
    if x2.device.type == "cuda":
        return _kernel_fwd(x2, scale, bias, eps, save)
    if x2.device.type != "cpu":
        raise ValueError(f"no channel LayerNorm for device {x2.device}")
    return channel_layernorm_plain_fwd(x2, scale, bias, eps)


class ChannelLayerNorm(torch.autograd.Function):
    """K7 forward and backward on the card, the plain versions on the CPU;
    saves x, mean and inv."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        out, mean, inv = _forward(x2, scale, bias, eps, save=True)
        ctx.save_for_backward(x2, mean, inv, scale)
        ctx.dtypes = (scale.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, dy):
        x2, mean, inv, scale = ctx.saved_tensors
        if x2.device.type == "cuda":
            dx, dscale, dbias = _kernel_bwd(dy, x2, mean, inv, scale)
        else:
            dx, dscale, dbias = channel_layernorm_plain_bwd(dy, x2, mean, inv,
                                                            scale)
        return dx, dscale.to(ctx.dtypes[0]), dbias.to(ctx.dtypes[1]), None


def channel_layernorm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm of ``x [..., C]`` over its last axis, float32 statistics
    and affine, the result in x's dtype; differentiable in x, scale and
    bias."""
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} do not match x[..., {c}]")
    x2 = x.reshape(-1, c).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        out = ChannelLayerNorm.apply(x2, scale, bias, eps)
    else:
        out = _forward(x2, scale, bias, eps, save=False)[0]
    return out.reshape(x.shape)
