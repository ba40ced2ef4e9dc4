"""BYOL's pre-mixed updates: the port's gap to JAX beside JAX's own spread.

    JAX_PLATFORMS=cpu python3 tools/premixed_spread.py [--eps 0.1] \
        [--seeds 0 1 2 3 4 5 6 7]

For each batch seed of ``tests/test_torch_train_step.py`` (``_batch``),
the views JAX's device mixing makes of it go through two train steps of
the tiny BYOL model on the CPU, at Adam's ``--eps``:

- JAX's pre-mixed step on the views (its kernel configuration, the
  test's reference), and again: on the same views (``jax_repeat``: 0),
  on the views moved up or down by one float32 ulp (``np.nextafter``),
  with its XLA FFN and dropout in place of its kernels (``jax_xla``), and
  with its block attention kernel in place of XLA's attention
  (``jax_block``): JAX's own spread, each way;
- the port's pre-mixed step on the same views: the port's gap (to the
  kernel configuration, and ``port_vs_xla`` to the XLA one).

Each is the test's error of the online parameters' updates (the largest
per-tensor ``max|Δ|`` over the step's scale, with 0 and with 2 float32
spacings of each parameter's value allowed), of the EMA target and of the
BatchNorm statistics.  Prints a line a seed and a JSON summary.

    JAX_PLATFORMS=cpu python3 tools/premixed_spread.py --gradients 6

compares instead the first step's gradients of the same batch against
the port's in float64 (its modules cast to float64 and every ``.float()``
of its forward made a float64 cast): JAX's kernel and XLA
configurations, the port in float32, and the port with only its heads'
products (the projector's and predictor's ``nn.Linear``) in float64; the
tensors farthest from float64, each ``max|Δ|`` over the largest float64
gradient entry.  Imports both packages; the CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import test_torch_train_step as tts  # noqa: E402
from nrse_tpu_torch.models.convert import (  # noqa: E402
    byol_variables_to_state_dicts,
)


def _worst(errors: dict) -> dict:
    return {group: float(max(errs.values())) for group, errs in errors.items()}


def measure(seed: int, eps: float) -> dict:
    views = tts._premixed(tts._batch(seed))
    start, end, _, _ = tts._jax_run(views, False, False, eps)
    runs = {"jax_repeat": (views, False, True)}
    for name, way in (("jax_nudge_up", np.inf), ("jax_nudge_down", -np.inf)):
        runs[name] = ({k: np.nextafter(v, np.float32(way))
                       for k, v in views.items()}, False, True)
    runs["jax_xla"] = (views, False, False)
    runs["jax_block"] = (views, True, True)
    ends = {}
    for name, (v, block, kernels) in runs.items():
        start_of, ends[name], _, _ = tts._jax_run(v, block, False, eps,
                                                  kernels=kernels)
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(start), jax.tree.leaves(start_of)))
    port = tts._runs(False, on_device_mixing=False, eps=eps, seed=seed)
    cfg = port[8]
    online0 = byol_variables_to_state_dicts(start, cfg)[0]
    out = {"seed": seed}
    got = {name: byol_variables_to_state_dicts(e, cfg)
           for name, e in ends.items()}
    got["port"] = tts._state_dicts(port[5])
    for spacings in (0, tts.PREMIXED_SPACINGS):
        for name, sds in got.items():
            out[f"{name}@{spacings}"] = _worst(tts.group_errors(
                end, online0, sds, cfg, spacings))
        # the port against JAX's XLA configuration
        out[f"port_vs_xla@{spacings}"] = _worst(tts.group_errors(
            ends["jax_xla"], online0, got["port"], cfg, spacings))
    return out


def _jax_gradients(views, kernels: bool):
    """JAX's first-step gradient of the online parameters (its loss as its
    train step takes it), and the state's variables."""
    import jax.numpy as jnp

    from nrse_tpu.models.byol import BYOLSpeechModel, byol_loss
    from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
    from nrse_tpu.train.byol_trainer import create_train_state
    from nrse_tpu.train.schedules import make_byol_optimizer

    impls = dict(ffn_impl="fused", dropout_impl="kernel") if kernels else {}
    model = BYOLSpeechModel({"model": {"projection_dim": tts.PROJ,
                                       "prediction_dim": tts.PRED,
                                       "ema_decay": 0.997}},
                            encoder_config=JaxConfig.tiny(**impls,
                                                          **tts.QUIET))
    state = create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((4, 3200)),
        make_byol_optimizer(tts.LR, 1e-5, total_steps=tts.STEPS_TOTAL))
    var = state.variables
    clean, noisy = (jnp.asarray(views[k]) for k in
                    ("clean_input_values", "noisy_input_values"))
    rngs = {k: jax.random.PRNGKey(1)
            for k in ("dropout", "layerdrop", "spec_augment")}

    def loss_fn(params):
        v = type(var)(online={**var.online, "params": params},
                      target=var.target)
        pred, proj, _ = model.apply(v, clean, noisy, deterministic=False,
                                    rngs=rngs)
        return byol_loss(pred, proj)

    return jax.grad(loss_fn)(var.online["params"]), var


def _port_gradients(views, online_sd, target_sd, cfg, double=False,
                    heads_double=False):
    """The port's first-step gradient of the online parameters, by name
    (float64 arrays), from the eager step's pieces."""
    import torch
    import torch.nn.functional as F

    from nrse_tpu_torch.models.byol import byol_loss
    from nrse_tpu_torch.train import byol_trainer as bt

    state = tts.create_train_state(cfg, online_sd, tts.PROJ, tts.PRED, "cpu",
                                   target_state_dict=target_sd)
    spec = tts.FusedAdamWSpec(schedule=tts.cosine_annealing(
        tts.LR, tts.STEPS_TOTAL), eps=tts.PREMIXED_EPS)
    batch = {k: torch.from_numpy(v) for k, v in views.items()}
    rngs = bt.step_inputs(state, batch, False).stage(state, spec)
    if heads_double:
        for tower in (state.online, state.target):
            for name, m in tower.named_modules():
                if isinstance(m, torch.nn.Linear) and \
                        not name.startswith("encoder"):
                    m.forward = (lambda mod: lambda x: F.linear(
                        x.double(), mod.weight.double(),
                        mod.bias.double()).float())(m)
    real_float = torch.Tensor.float
    if double:
        state.online.double()
        state.target.double()
        torch.Tensor.float = lambda t: t.double() \
            if t.is_floating_point() else real_float(t)
        batch = {k: v.double() for k, v in batch.items()}
    try:
        clean, noisy, valid = bt.byol_views(batch, False)
        pred, _, _ = state.online(clean, rngs[0])
        with torch.no_grad():
            proj, _ = state.target(noisy, rngs[1])
        byol_loss(pred, proj, weights=valid).backward()
    finally:
        torch.Tensor.float = real_float
    return {k: p.grad.detach().double().numpy()
            for k, p in state.online.named_parameters()}


def gradients(seed: int, top: int = 8) -> dict:
    views = tts._premixed(tts._batch(seed))
    grads_k, var = _jax_gradients(views, True)
    grads_x, _ = _jax_gradients(views, False)
    cfg = tts.WavLMConfig.tiny(**tts.QUIET)

    def named(g):
        return byol_variables_to_state_dicts(
            type(var)(online={**var.online, "params": g}, target=var.target),
            cfg)[0]

    online_sd, target_sd = byol_variables_to_state_dicts(var, cfg)
    truth = _port_gradients(views, online_sd, target_sd, cfg, double=True)
    sides = {"jax_kernels": named(grads_k), "jax_xla": named(grads_x),
             "port": _port_gradients(views, online_sd, target_sd, cfg),
             "port_heads_f64": _port_gradients(views, online_sd, target_sd,
                                               cfg, heads_double=True)}
    scale = max(np.abs(v).max() for v in truth.values())
    rows = sorted(((k, {side: float(np.abs(np.asarray(g[k], np.float64)
                                           - truth[k]).max() / scale)
                        for side, g in sides.items()}) for k in truth),
                  key=lambda kv: -max(kv[1].values()))[:top]
    for k, errs in rows:
        print(f"seed {seed} {k}: " + ", ".join(
            f"{side} {e:.2e}" for side, e in errs.items()), flush=True)
    return {"seed": seed, "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--eps", type=float, default=tts.PREMIXED_EPS)
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    p.add_argument("--gradients", type=int, default=None, metavar="SEED",
                   help="compare the first step's gradients with float64")
    args = p.parse_args(argv)
    if args.gradients is not None:
        print(json.dumps(gradients(args.gradients)))
        return 0
    rows = []
    for seed in args.seeds:
        row = measure(seed, args.eps)
        rows.append(row)
        print(f"seed {seed}: " + "; ".join(
            f"{k} update {v['update']:.3e} target {v['target']:.3e} "
            f"bn {v['bn_stats']:.3e}" for k, v in row.items()
            if k != "seed"), flush=True)
    print(json.dumps({"eps": args.eps, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
