"""Fused transformer FFN (kernel B's wrapper).

Port of ``nrse_tpu/ops/fused_ffn.py:397-446`` for the deterministic
forward: ``dense → exact-erf GELU → cast to the working dtype → dense``.
The weights stay in torch's ``[out, in]`` layout (``nn.Linear.weight``):
``w1 [F, C]``, ``w2 [C, F]``.  A CUDA tensor goes to the hand-written
kernel in ``nrse_tpu_torch/csrc/fused_ffn_fwd.cu``; a CPU tensor goes to
:func:`ffn_plain`, the same composition as
``tests/test_fused_ffn.py::_ref_ffn``.  There is no fallback from one to
the other.  Dropout and the backward come with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nrse_tpu_torch.runtime import cuda_build

# the CUDA kernel's tile: C and F must be multiples of this
TILE = 128

# Kernel launches made by this wrapper since the count was last reset.
LAUNCHES = 0


def ffn_plain(x, w1, b1, w2, b2):
    """Plain PyTorch FFN: products of the working-dtype operands
    accumulated in float32, bias and GELU on the float32 sum, the GELU
    output rounded to x's dtype before the second product."""
    dt = x.dtype
    h = torch.matmul(x.float(), w1.to(dt).float().t()) + b1.float()
    g = F.gelu(h, approximate="none").to(dt)
    o = torch.matmul(g.float(), w2.to(dt).float().t()) + b2.float()
    return o.to(dt)


def _kernel_fwd(rows, w1, b1, w2, b2):
    n, c = rows.shape
    f = w1.shape[0]
    if rows.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got "
                        f"{rows.dtype}")
    if c % TILE or f % TILE:
        raise ValueError(f"the CUDA kernel takes C and F that are multiples "
                         f"of {TILE}, got C={c} F={f}")
    if any(t.device != rows.device for t in (w1, b1, w2, b2)):
        raise ValueError("x and the FFN weights must share a device")
    rows = rows.contiguous()
    w1 = w1.to(torch.bfloat16).contiguous()
    w2 = w2.to(torch.bfloat16).contiguous()
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    h = torch.empty(n, f, dtype=torch.bfloat16, device=rows.device)
    out = torch.empty_like(rows)
    if any(t.data_ptr() % 16 for t in (rows, w1, w2, h, out)):
        raise ValueError("the CUDA kernel needs 16-byte aligned operands")
    lib = cuda_build.load()
    with torch.cuda.device(rows.device):  # the launch goes to the current card
        err = lib.nrse_fused_ffn_fwd(
            rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), h.data_ptr(), out.data_ptr(), n, c, f,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "fused_ffn_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out


def fused_ffn(x, w1, b1, w2, b2):
    """``dense2(gelu(dense1(x)))`` for ``x [..., C]``, ``w1 [F, C]``,
    ``b1 [F]``, ``w2 [C, F]``, ``b2 [C]``.  Returns x's shape and dtype."""
    c = x.shape[-1]
    f = w1.shape[0]
    if w1.shape != (f, c) or w2.shape != (c, f) or b1.shape != (f,) \
            or b2.shape != (c,):
        raise ValueError(
            f"FFN weights do not match x[..., {c}]: w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")
    rows = x.reshape(-1, c)
    if x.device.type == "cuda":
        out = _kernel_fwd(rows, w1, b1, w2, b2)
    elif x.device.type == "cpu":
        out = ffn_plain(rows, w1, b1, w2, b2)
    else:
        raise ValueError(f"no fused FFN for device {x.device}")
    return out.reshape(x.shape)
