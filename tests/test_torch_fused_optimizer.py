"""K4's plain version against the JAX package's fused optimizer and
against optax.

A small tree of three collections (encoder, projector, predictor; the
target holds the first two) with one leaf of 256 × 512 = 128 Ki
elements, so that JAX takes its Pallas kernel (interpret mode) there and
its XLA formula for the rest.  The port keeps flat buffers in its own
order (encoder, projector, predictor) and is compared leaf by leaf.
Three steps on a cosine schedule from a numpy seed; the second step's
gradients are scaled up so that the global-norm clip acts.

Tolerance: 1e-6 ``max|Δ|/max|ref|`` per leaf on the parameters, ``mu``,
``nu`` and the target, against JAX's fused update (the same operations in
float32; both are handed the same grad norm, so that two summation orders
of the norm do not enter) and against ``optax.chain(clip_by_global_norm,
adamw)`` + the EMA lerp, which computes its own norm and divides by the
bias corrections where the fused kernels multiply by their inverses.
Against optax ``nu`` alone is held to 2e-5: optax rounds ``1 − b2`` from
double precision (float32(0.001)), the fused kernels of both packages
compute it in float32 (0.00099998713), 1.3e-5 apart; a spec with
``optax_rates`` folds that ratio into the bias corrections, and its
updates are plain ``optax.adamw``'s to 1e-6 of the largest update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nrse_tpu.ops.fused_optimizer import FusedAdamWSpec as JaxSpec
from nrse_tpu.ops.fused_optimizer import _find_adam_state
from nrse_tpu.ops.fused_optimizer import fused_adamw_ema_update as jax_update
from nrse_tpu.train.schedules import cosine_annealing as jax_cosine
from nrse_tpu.train.schedules import make_byol_optimizer
from nrse_tpu_torch.ops import fused_optimizer as port
from nrse_tpu_torch.train.schedules import cosine_annealing

torch.set_num_threads(1)

TOL = 1e-6
NU_OPTAX_TOL = 2e-5
LR, TOTAL, WD, EMA = 1e-3, 4, 1e-2, 0.9
SHAPES = {"encoder": {"big": (256, 512), "b": (64,)},
          "projector": {"w": (32, 16)},
          "predictor": {"w": (16, 8), "b": (8,)}}
ORDER = [(c, k) for c in ("encoder", "projector", "predictor")
         for k in SHAPES[c]]
N_EMA = sum(int(np.prod(SHAPES[c][k])) for c, k in ORDER
            if c != "predictor")


def _tree(rng, scale=1.0):
    return {c: {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in leaves.items()} for c, leaves in SHAPES.items()}


def _flat(tree):
    return torch.from_numpy(np.concatenate(
        [np.asarray(tree[c][k], np.float32).reshape(-1) for c, k in ORDER
         if c in tree]))


def _unflat(flat):
    out, off = {}, 0
    for c, k in ORDER:
        if off == flat.numel():  # the target ends before the predictor
            break
        n = int(np.prod(SHAPES[c][k]))
        out[(c, k)] = flat[off:off + n].numpy().reshape(SHAPES[c][k])
        off += n
    return out


def _grads(rng, step):
    return _tree(rng, scale=5.0 if step == 1 else 0.01)  # step 1 clips


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_grads(rng, i) for i in range(3)]
    target0 = {c: {k: v + 0.01 for k, v in params[c].items()}
               for c in ("encoder", "projector")}

    optimizer = make_byol_optimizer(LR, WD, total_steps=TOTAL)
    spec = JaxSpec(schedule=jax_cosine(LR, TOTAL), weight_decay=WD,
                   ema_decay=EMA)
    jp, jt = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             target0)
    jstate = optimizer.init(jp)
    # optax: the same chain through optimizer.update, EMA after the step
    op, ot, ostate = jp, jt, optimizer.init(jp)
    fused, reference = [], []
    norms = [np.float32(np.sqrt(sum(np.sum(np.square(x, dtype=np.float64))
                                    for x in jax.tree.leaves(g))))
             for g in grads]
    for g, norm in zip(grads, norms):
        jg = jax.tree.map(jnp.asarray, g)
        jp, jstate, jt = jax_update(jg, jp, jstate, jt, spec,
                                    grad_norm=jnp.float32(norm))
        adam = _find_adam_state(jstate)[0]
        fused.append((jp, adam.mu, adam.nu, jt))
        upd, ostate = optimizer.update(jg, ostate, op)
        op = optax.apply_updates(op, upd)
        ot = {c: jax.tree.map(lambda t, o: EMA * t + (1 - EMA) * o, ot[c],
                              op[c]) for c in ot}
        oadam = _find_adam_state(ostate)[0]
        reference.append((op, oadam.mu, oadam.nu, ot))

    pspec = port.FusedAdamWSpec(schedule=cosine_annealing(LR, TOTAL),
                                weight_decay=WD, ema_decay=EMA)
    p, t = _flat(params), _flat(target0)
    assert t.numel() == N_EMA
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    ours = []
    for count, (g, norm) in enumerate(zip(grads, norms)):
        port.fused_adamw_ema_update(_flat(g), p, mu, nu, t, pspec, count,
                                    torch.tensor(norm))
        ours.append((p.clone(), mu.clone(), nu.clone(), t.clone()))
    return fused, reference, ours


def _compare(theirs, ours):
    worst = {}
    for step, (jp, jmu, jnu, jt) in enumerate(theirs):
        p, mu, nu, t = (_unflat(x) for x in ours[step])
        for name, mine, ref in (("p", p, jp), ("mu", mu, jmu),
                                ("nu", nu, jnu), ("target", t, jt)):
            for (c, k), got in mine.items():
                want = np.asarray(ref[c][k])
                worst[(step, name, c, k)] = float(
                    np.abs(got - want).max() / np.abs(want).max())
    return worst


@pytest.mark.parametrize("against", ["jax_fused", "optax"])
def test_plain_update_matches(runs, against):
    fused, reference, ours = runs
    worst = _compare(fused if against == "jax_fused" else reference, ours)
    tol = {"nu": NU_OPTAX_TOL if against == "optax" else TOL}
    bad = {k: v for k, v in worst.items() if v > tol.get(k[1], TOL)}
    assert not bad, bad


def test_scalars_follow_the_fused_layout():
    spec = port.FusedAdamWSpec(schedule=cosine_annealing(1.0, 10))
    sc = port.scalars(spec, 0, torch.tensor(4.0))
    # the first LR is the schedule at step 0; bias corrections at step 1
    assert sc[1] == 1.0
    assert sc[0] == pytest.approx(0.25)   # clip 1.0 / grad norm 4.0
    f32 = np.float32  # 1 / (1 - b**1), rounded as float32 rounds it
    assert sc[4] == f32(1) / (f32(1) - f32(0.9))
    assert sc[5] == f32(1) / (f32(1) - f32(0.999))
    assert port.scalars(spec, 5, torch.tensor(0.5))[0] == 1.0


def test_cpu_buffers_launch_nothing():
    before = port.LAUNCHES
    x = torch.ones(10)
    port.fused_adamw_ema_update(x.clone(), x.clone(), x * 0, x * 0, None,
                                port.FusedAdamWSpec(schedule=1e-3), 0)
    assert port.LAUNCHES == before


@pytest.mark.parametrize("optax_rates", [True, False])
def test_optax_rates_give_optax_adamw_updates(optax_rates):
    """``FusedAdamWSpec.optax_rates`` (the fine-tune's AdamW): three
    updates of plain ``optax.adamw`` (Python float betas, no clip) to 1e-6
    of the largest update.  K4's own rounding of the rates (``1 − b2``
    from float32 ``b2``) is 6.4e-6 of an update off at the first step."""
    rng = np.random.default_rng(1)
    # parameters of the updates' size, so that p' − p resolves the update
    p0 = (LR * rng.standard_normal(4096)).astype(np.float32)
    grads = [rng.standard_normal(4096).astype(np.float32) for _ in range(3)]
    opt = optax.adamw(LR, weight_decay=1e-4)
    op, want = jnp.asarray(p0), []
    state = opt.init(op)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, op)
        op = optax.apply_updates(op, upd)
        want.append(np.asarray(upd))
    spec = port.FusedAdamWSpec(schedule=LR, weight_decay=1e-4,
                               clip_norm=float("inf"),
                               optax_rates=optax_rates)
    p = torch.from_numpy(p0.copy())
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    worst = 0.0
    for count, (g, w) in enumerate(zip(grads, want)):
        before = p.clone()
        port.fused_adamw_ema_update(torch.from_numpy(g), p, mu, nu, None,
                                    spec, count, torch.tensor(1.0))
        got = (p - before).numpy()
        worst = max(worst, float(np.abs(got - w).max() / np.abs(w).max()))
    assert (worst < TOL) == optax_rates, worst
