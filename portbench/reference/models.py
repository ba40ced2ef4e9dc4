"""The plain heads, losses and optimizer the check holds the program to,
and the three followers: BYOL's first train steps, the fine-tune's first
update, and the evaluator's logits.  Float32 with TF32 off, as functions
of parameter dicts; nothing here comes from the program.

* BYOL (Grill et al., 2020, with the noise-robust views of the port's
  configuration): the views are the clean crop and the crop mixed with
  noise at the batch's SNR, each peak-normalised then z-normalised; the
  online tower (WavLM → mean pool → projector → predictor) and the target
  (WavLM → projector, no gradient) both in training mode, each with its
  own draws; the loss ``2 - 2 cos`` over the valid rows; clip by the
  global norm, AdamW (decay inside the update, eps outside the root), and
  the target's EMA over its parameters.
* The fine-tune (the Odyssey-2024 SER baseline): WavLM → attentive
  statistics pooling (float32 statistics, padded frames out) → Dense →
  LayerNorm → ReLU → dropout → Dense, weighted cross-entropy, the
  micro-steps' gradients averaged and one AdamW update every k.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import draws as D
from portbench.reference.wavlm import WavLM, identity


@contextlib.contextmanager
def exact_float32():
    """TF32 off for products and convs inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def batch_norm(x, w, b, eps=1e-5):
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _dense(p, name, x, q):
    return F.linear(q(x), q(p[name + ".weight"]), p[name + ".bias"])


def projector(p, pre, x, q=identity):
    h = F.relu(batch_norm(_dense(p, pre + "dense_0", x, q),
                          p[pre + "bn_0.weight"], p[pre + "bn_0.bias"]))
    return batch_norm(_dense(p, pre + "dense_1", h, q),
                      p[pre + "bn_1.weight"], p[pre + "bn_1.bias"])


def predictor(p, pre, x, q=identity):
    h = F.relu(batch_norm(_dense(p, pre + "dense_0", x, q),
                          p[pre + "bn_0.weight"], p[pre + "bn_0.bias"]))
    h = F.relu(batch_norm(_dense(p, pre + "dense_1", h, q),
                          p[pre + "bn_1.weight"], p[pre + "bn_1.bias"]))
    return _dense(p, pre + "dense_2", h, q)


def byol_views(clean, noise, snr):
    sp = (clean ** 2).mean(-1)
    npow = (noise ** 2).mean(-1)
    scale = torch.sqrt(sp / (npow * 10.0 ** (snr / 10.0) + 1e-10))
    valid = (sp >= 1e-10) & (npow >= 1e-10) & torch.isfinite(scale) \
        & (scale <= 1e6)
    noisy = clean + noise * torch.where(valid, scale, 0.0)[:, None]

    def norm(x):
        x = x / (x.abs().amax(-1, keepdim=True) + 1e-8)
        m = x.mean(-1, keepdim=True)
        return (x - m) / torch.sqrt(((x - m) ** 2).mean(-1, keepdim=True)
                                    + 1e-7)
    return norm(clean), norm(noisy), valid


def byol_loss(pred, proj, valid):
    o = pred + 1e-10
    t = proj + 1e-10
    o = o / o.norm(dim=1, keepdim=True).clamp_min(1e-10)
    t = t / t.norm(dim=1, keepdim=True).clamp_min(1e-10)
    per = 2.0 - 2.0 * (o * t).sum(1).clamp(-1.0, 1.0)
    w = valid.float()
    return (per * w).sum() / w.sum().clamp_min(1.0)


def cosine_lr(base: float, total: int, count: int) -> float:
    t = min(count, total)
    return base * 0.5 * (1.0 + math.cos(math.pi * t / total))


def adamw(params, grads, mu, nu, count: int, lr: float, opt: Dict):
    """One AdamW update in place (``count`` updates before this one)."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    t = count + 1
    for k in params:
        g = grads[k]
        mu[k].mul_(b1).add_((1 - b1) * g)
        nu[k].mul_(b2).add_((1 - b2) * g * g)
        upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t))
                                         + eps) + wd * params[k]
        params[k].sub_(lr * upd)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def byol_follow(cfg: Dict, params: Dict[str, torch.Tensor],
                batches: List[Dict], seed: int, q: Callable = identity
                ) -> Dict:
    """BYOL's first ``len(batches)`` train steps from ``params`` (the
    online tower's float32 state dict, parameters only; the target starts
    as a copy of its encoder and projector).  Returns the readings: each
    step's loss, each leaf's norm of the first clipped gradient, and each
    leaf's norm of the change over the steps (``online.<name>`` and
    ``target.<name>``); ``grads``, each step's norms of its clipped
    gradient."""
    enc, model, opt = cfg["encoder"], cfg["model"], cfg["optimizer"]
    online = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    target = {k: v.detach().clone() for k, v in params.items()
              if not k.startswith("predictor.")}
    start = {("online." + k): v.detach().clone() for k, v in online.items()}
    start.update({("target." + k): v.clone() for k, v in target.items()})
    mu = {k: torch.zeros_like(v) for k, v in online.items()}
    nu = {k: torch.zeros_like(v) for k, v in online.items()}
    losses, norms = [], []
    with exact_float32():
        for step, batch in enumerate(batches):
            clean, noisy, valid = byol_views(batch["clean"].float(),
                                             batch["noise"].float(),
                                             batch["snr"].float())
            _, pooled, _ = WavLM(enc, online, "encoder.", q).forward(
                clean, None, D.StepDraws(seed, step, 0))
            proj = projector(online, "projector.", pooled, q)
            pred = predictor(online, "predictor.", proj, q)
            with torch.no_grad():
                _, tp, _ = WavLM(enc, target, "encoder.", q).forward(
                    noisy, None, D.StepDraws(seed, step, 1))
                tproj = projector(target, "projector.", tp, q)
            loss = byol_loss(pred, tproj, valid)
            names = list(online)
            g = torch.autograd.grad(loss, [online[k] for k in names],
                                    allow_unused=True)
            grads = {k: (torch.zeros_like(online[k]) if gi is None else gi)
                     for k, gi in zip(names, g)}
            gn = math.sqrt(sum(float((v.double() ** 2).sum())
                               for v in grads.values()))
            clip = 1.0 if gn < opt["clip_norm"] else opt["clip_norm"] / gn
            grads = {k: v * clip for k, v in grads.items()}
            norms.append(_norms(grads))
            losses.append(float(loss.detach()))
            lr = cosine_lr(opt["learning_rate"], opt["schedule_steps"], step)
            with torch.no_grad():
                adamw(online, grads, mu, nu, step, lr, opt)
                ema = model["ema_decay"]
                for k, t in target.items():
                    t.mul_(ema).add_((1 - ema) * online[k])
            del grads, g
    with torch.no_grad():
        change = {k: (online[k[7:]] if k.startswith("online.")
                      else target[k[7:]]) - v for k, v in start.items()}
    return {"loss": losses, "grad": norms[0], "grads": norms,
            "change": _norms(change)}


def asp(p, pre, seq, wav_mask, q=identity):
    """Attentive statistics pooling over the frames the waveform mask
    covers at a 20 ms shift: ``[B, 2C]``."""
    b, t, _ = seq.shape
    lengths = (wav_mask.to(torch.int64).sum(1) - 1) // 320 + 1
    fm = torch.arange(t, device=seq.device)[None] < lengths[:, None]
    h = torch.tanh(torch.matmul(q(seq), q(p[pre + "sap_linear_kernel"]))
                   + p[pre + "sap_linear_bias"])
    logits = torch.matmul(h, p[pre + "attention"])[..., 0]
    w = torch.softmax(logits.masked_fill(~fm, -1e9), dim=1)[..., None]
    mu = (seq * w).sum(1)
    var = (seq * seq * w).sum(1) - mu * mu
    return torch.cat([mu, torch.sqrt(var.clamp_min(1e-5))], dim=1)


def ser_logits(cfg: Dict, p: Dict, x, mask, dr: Optional[D.StepDraws],
               q=identity):
    enc, head = cfg["encoder"], cfg["head"]
    seq, _, _ = WavLM(enc, p, "ssl.", q).forward(x, mask, dr)
    h = _dense(p, "ser.fc_0", asp(p, "pool.", seq, mask, q), q)
    h = F.relu(F.layer_norm(h, h.shape[-1:], p["ser.norm_0.weight"],
                            p["ser.norm_0.bias"], 1e-6))
    if dr is not None:
        keep = dr.head_keep(1, x.shape[0], head["head_dim"],
                            head["dropout"])[0].to(x.device)
        h = torch.where(keep, h / (1.0 - head["dropout"]),
                        torch.zeros_like(h))
    return _dense(p, "ser.out", h, q)


def weighted_ce(logits, labels, weights):
    nll = -torch.log_softmax(logits, -1).gather(
        -1, labels.long()[:, None])[:, 0]
    w = weights[labels.long()]
    return (nll * w).sum() / w.sum()


def ft_follow(cfg: Dict, params: Dict[str, torch.Tensor],
              batches: List[Dict], seed: int, weights: torch.Tensor,
              q: Callable = identity) -> Dict:
    """The fine-tune's first update: ``len(batches)`` micro-steps (the
    accumulation count) from ``params``, each micro-step ``i`` drawing
    from step ``i``'s streams, their gradients averaged, one AdamW update.
    Readings: each micro-step's loss, each leaf's norm of the averaged
    gradient, and of the change the update made."""
    opt = cfg["optimizer"]
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in p.items()}
    acc = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    names = list(p)
    with exact_float32():
        for step, batch in enumerate(batches):
            logits = ser_logits(cfg, p, batch["input_values"].float(),
                                batch["attention_mask"].float(),
                                D.StepDraws(seed, step, 0), q)
            loss = weighted_ce(logits, batch["label"], weights)
            g = torch.autograd.grad(loss, [p[k] for k in names],
                                    allow_unused=True)
            with torch.no_grad():
                for k, gi in zip(names, g):
                    if gi is not None:
                        acc[k].add_((gi - acc[k]) / (step + 1))
                    else:
                        acc[k].sub_(acc[k] / (step + 1))
            losses.append(float(loss.detach()))
            del g
        first = _norms(acc)
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        with torch.no_grad():
            adamw(p, acc, mu, nu, 0, opt["learning_rate"], opt)
            change = {k: p[k] - v for k, v in start.items()}
    return {"loss": losses, "grad": first, "change": _norms(change)}


@torch.no_grad()
def eval_logits(cfg: Dict, params: Dict[str, torch.Tensor], x, mask,
                q: Callable = identity) -> torch.Tensor:
    with exact_float32():
        return ser_logits(cfg, params, x.float(), mask.float(), None, q)
