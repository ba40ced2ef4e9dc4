"""Fused AdamW + BYOL-EMA update (K4's wrapper).

Port of ``nrse_tpu/ops/fused_optimizer.py:60-338``.  The update, per
element (``fused_optimizer.py:11-17``; eps is added outside ``√v̂`` and the
weight decay is part of the update, as in optax's ``adamw`` and unlike
``torch.optim.AdamW``)::

    ghat = g · clip_scale
    mu'  = b1·mu + (1−b1)·ghat
    nu'  = b2·nu + (1−b2)·ghat²
    p'   = p − lr·((mu'/bc1) / (√(nu'/bc2) + eps) + wd·p)
    pt'  = ema·pt + (1−ema)·p'          (the BYOL target, where present)

The port keeps the state as flat float32 buffers (``train/byol_trainer``):
online parameters ordered encoder, projector, predictor; their gradients,
``mu`` and ``nu`` alike; and the target (encoder, projector), so the EMA
covers a prefix of the online buffer and one launch covers every leaf.
The update is in place.  A CUDA buffer goes to the hand-written kernel in
``nrse_tpu_torch/csrc/fused_adamw_ema.cu``; a CPU buffer goes to
:func:`adamw_ema_plain`, ``_leaf_update_xla`` (``:120-132``) in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.runtime import cuda_build

# Kernel launches made by this wrapper since the count was last reset.
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class FusedAdamWSpec:
    """Hyper-parameters of the fused optimizer + EMA step.  ``schedule``
    is the LR as a function of the Adam step count, or a constant."""

    schedule: Any
    weight_decay: float = 1e-5
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    ema_decay: float = 0.997


def scalars(spec: FusedAdamWSpec, count: int,
            grad_norm: torch.Tensor) -> torch.Tensor:
    """The float32 vector ``[clip_scale, lr, b1, b2, 1/bc1, 1/bc2, wd, eps,
    ema]`` on ``grad_norm``'s device, as ``fused_optimizer.py:274-298``
    builds it: the LR at the Adam count *before* this update (step 0 on the
    first), the bias corrections at the count after it.  Nothing here waits
    for the device."""
    f32 = np.float32
    lr = spec.schedule(count) if callable(spec.schedule) else spec.schedule
    cf = f32(count + 1)
    ibc1 = f32(1.0) / (f32(1.0) - f32(spec.b1) ** cf)
    ibc2 = f32(1.0) / (f32(1.0) - f32(spec.b2) ** cf)
    gn = grad_norm.to(torch.float32).reshape(1)
    clip = torch.where(gn < spec.clip_norm, torch.ones_like(gn),
                       spec.clip_norm / torch.clamp_min(gn, 1e-30))
    rest = torch.tensor(np.array(
        [lr, spec.b1, spec.b2, ibc1, ibc2, spec.weight_decay, spec.eps,
         spec.ema_decay], np.float32)).to(gn.device, non_blocking=True)
    return torch.cat([clip, rest])


def adamw_ema_plain(sc: torch.Tensor, g: torch.Tensor, p: torch.Tensor,
                    mu: torch.Tensor, nu: torch.Tensor,
                    pt: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: ``(p', mu', nu', pt' | None)`` for the
    leading ``len(pt)`` elements' EMA; the same operations in the same
    order as the kernel."""
    ghat = g.float() * sc[0]
    mu_n = sc[2] * mu.float() + (1.0 - sc[2]) * ghat
    nu_n = sc[3] * nu.float() + (1.0 - sc[3]) * ghat * ghat
    pf = p.float()
    upd = (mu_n * sc[4]) / (torch.sqrt(nu_n * sc[5]) + sc[7]) + sc[6] * pf
    p_n = pf - sc[1] * upd
    pt_n = None
    if pt is not None:
        pt_n = sc[8] * pt.float() + (1.0 - sc[8]) * p_n[:pt.numel()]
    return p_n, mu_n, nu_n, pt_n


def _kernel(sc, g, p, mu, nu, pt):
    require_no_grad(g, p, mu, nu, pt, what="fused_adamw_ema")
    bufs = (g, p, mu, nu) + (() if pt is None else (pt,))
    if any(b.dtype != torch.float32 or not b.is_contiguous()
           or b.data_ptr() % 16 or b.device != p.device for b in bufs):
        raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned "
                         "float32 buffers on one device")
    sc = sc.to(device=p.device, dtype=torch.float32).contiguous()
    lib = cuda_build.load()
    with torch.cuda.device(p.device):
        err = lib.nrse_adamw_ema(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            0 if pt is None else pt.data_ptr(), sc.data_ptr(), p.numel(),
            0 if pt is None else pt.numel(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "fused_adamw_ema")
    global LAUNCHES
    LAUNCHES += 1


def fused_adamw_ema_update(grads: torch.Tensor, params: torch.Tensor,
                           mu: torch.Tensor, nu: torch.Tensor,
                           target: Optional[torch.Tensor],
                           spec: FusedAdamWSpec, count: int,
                           grad_norm: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One AdamW + EMA step over flat 1-D buffers, in place: ``params``,
    ``mu``, ``nu`` (all of ``grads``' length) and ``target`` (the EMA of
    the leading ``len(target)`` params; or None).  ``count`` is the Adam
    step count before this update.  Returns the scalar vector used."""
    if not (grads.shape == params.shape == mu.shape == nu.shape) \
            or params.dim() != 1:
        raise ValueError("grads, params, mu and nu must be 1-D of one size")
    if target is not None and (target.dim() != 1
                               or target.numel() > params.numel()):
        raise ValueError("target must be 1-D and no longer than params")
    if grad_norm is None:
        grad_norm = torch.linalg.vector_norm(grads.float())
    sc = scalars(spec, count, grad_norm)
    if params.device.type == "cuda":
        _kernel(sc, grads, params, mu, nu, target)
    elif params.device.type == "cpu":
        p_n, mu_n, nu_n, pt_n = adamw_ema_plain(sc, grads, params, mu, nu,
                                                target)
        params.copy_(p_n)
        mu.copy_(mu_n)
        nu.copy_(nu_n)
        if target is not None:
            target.copy_(pt_n)
    else:
        raise ValueError(f"no fused optimizer for device {params.device}")
    return sc
