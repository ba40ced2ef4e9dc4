"""Dropout with masks drawn inside the kernel (K1's wrapper).

Port of ``nrse_tpu/ops/fused_dropout.py:68-238``.  :func:`hw_dropout` is a
``torch.autograd.Function`` whose backward runs the same kernel on ``dy``
with the mask regenerated from the saved seed: it saves no mask, only the
seed pair.  :func:`hw_dropout_masked` takes an explicit ``{0, 1/(1−p)}``
float32 mask instead (the tests' path), and :func:`dump_dropout_mask`
returns the mask a seed gives.  Masks follow the Philox contract of
``ops/philox.py``.

A CUDA tensor goes to the hand-written kernel in
``nrse_tpu_torch/csrc/fused_dropout.cu`` (bf16 only); a CPU tensor goes to
the plain versions here, whose masks come from the Philox twin, so a seed
gives the same mask on both.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nrse_tpu_torch.ops import philox
from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.runtime import cuda_build

# Kernel launches made by this wrapper since the count was last reset:
# dropout forward and backward passes, and mask dumps.
LAUNCHES = 0
DUMP_LAUNCHES = 0

_MODE_SEEDED, _MODE_MASKED, _MODE_DUMP = 0, 1, 2


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(mode, x, mask, out, n, seed=(0, 0), site=0, p=0.0):
    require_no_grad(x, mask, what="fused_dropout")
    lib = cuda_build.load()
    dev = out.device
    with cuda_build.on_device(dev):  # the launch goes to that card
        err = lib.nrse_dropout(
            0 if x is None else x.data_ptr(),
            0 if mask is None else mask.data_ptr(), out.data_ptr(), n,
            int(seed[0]), int(seed[1]), int(site), float(p),
            philox.keep_scale(p), mode, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "fused_dropout")


def _check_cuda(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {x.dtype}")


def dropout_plain(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x · mask`` in float32, cast back."""
    return (x.float() * mask).to(x.dtype)


def _seeded(x, seed, p, site):
    """One dropout pass (forward, or backward on ``dy``)."""
    if x.device.type == "cpu":
        mask = philox.dump_mask(seed, site, x.shape, p)
        return dropout_plain(x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    _check_cuda(x)
    xc = _aligned(x)
    out = torch.empty_like(xc)
    _launch(_MODE_SEEDED, xc, None, out, xc.numel(), seed, site, p)
    global LAUNCHES
    LAUNCHES += 1
    return out.view(x.shape)


def _masked(x, mask):
    if x.device.type == "cpu":
        return dropout_plain(x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    _check_cuda(x)
    if mask.shape != x.shape or mask.device != x.device:
        raise ValueError("the mask must have x's shape and device")
    xc = _aligned(x)
    mc = _aligned(mask.to(torch.float32))
    out = torch.empty_like(xc)
    _launch(_MODE_MASKED, xc, mc, out, xc.numel())
    global LAUNCHES
    LAUNCHES += 1
    return out.view(x.shape)


class _HwDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, p, site):
        ctx.args = (seed, p, site)
        return _seeded(x, seed, p, site)

    @staticmethod
    def backward(ctx, dy):
        return _seeded(dy, *ctx.args), None, None, None


class _HwDropoutMasked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return _masked(x, mask)

    @staticmethod
    def backward(ctx, dy):
        (mask,) = ctx.saved_tensors
        return _masked(dy, mask), None


def hw_dropout(x: torch.Tensor, seed: Tuple[int, int], p: float,
               site: int = 0) -> torch.Tensor:
    """Bernoulli dropout of ``x`` (any shape) with probability ``p``, the
    mask drawn from Philox under ``seed`` (a pair of 32-bit ints) at
    ``site`` over the flat element index.  ``p = 0`` returns ``x``."""
    if p == 0.0:
        return x
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")
    seed = (int(seed[0]), int(seed[1]))
    if torch.is_grad_enabled() and x.requires_grad:
        return _HwDropout.apply(x, seed, float(p), int(site))
    return _seeded(x, seed, float(p), int(site))  # no graph to record


def hw_dropout_masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x · mask`` with an explicit float32 ``{0, 1/(1−p)}`` mask of x's
    shape; the backward is ``dy · mask`` (the mask gets no gradient)."""
    return _HwDropoutMasked.apply(x, mask)


def dump_dropout_mask(seed: Tuple[int, int], shape, p: float, site: int = 0,
                      device=None) -> torch.Tensor:
    """The float32 ``{0, 1/(1−p)}`` mask :func:`hw_dropout` applies for
    this (seed, shape, p, site): from the kernel on a CUDA device, from the
    Philox twin elsewhere."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return philox.dump_mask(seed, site, tuple(shape), p, device=device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    _launch(_MODE_DUMP, None, None, out, out.numel(), seed, site, p)
    global DUMP_LAUNCHES
    DUMP_LAUNCHES += 1
    return out
