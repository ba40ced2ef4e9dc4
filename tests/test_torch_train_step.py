"""The port's BYOL train step and eval step against the JAX package's.

Tiny BYOL (projection 32, prediction 64) with every random feature off
(dropout, LayerDrop, SpecAugment), the JAX side in its kernel
configuration (``ffn_impl="fused"`` and ``dropout_impl="kernel"``: the
fused FFN in interpret mode, and ``FusedAdamWSpec``, whose leaves are all
below the kernel's 128 Ki elements here), the port on its plain CPU paths.
Both start from the same weights (the JAX init, converted) and take two
steps on the same batch of 4 × 3200 samples at lr 1e-3 (cosine over 10
steps), so that the updates are visible.

Tolerances, float32 on both sides: the loss to 1e-5 absolute; grad_norm,
the parameter deltas, the EMA target and the BatchNorm statistics to 1e-4
relative (see each test for the scale): the two differ in summation
order and in the fused FFN's A&S erf against the exact erf.

A second test turns dropout, LayerDrop and SpecAugment on and checks the
port alone: the run is finite, the same seed gives the same result twice,
and another step draws other masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.ops.fused_optimizer import FusedAdamWSpec as JaxSpec
from nrse_tpu.train.byol_trainer import create_train_state as jax_state
from nrse_tpu.train.byol_trainer import make_byol_eval_step as jax_eval
from nrse_tpu.train.byol_trainer import make_byol_train_step as jax_step
from nrse_tpu.train.schedules import cosine_annealing as jax_cosine
from nrse_tpu.train.schedules import make_byol_optimizer
from nrse_tpu_torch.models.convert import (
    byol_variables_to_state_dicts,
    init_byol_state_dict,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_eval_step,
    make_byol_train_step,
)
from nrse_tpu_torch.train.schedules import cosine_annealing

torch.set_num_threads(1)

LOSS_TOL = 1e-5
REL_TOL = 1e-4
LR, STEPS_TOTAL, PROJ, PRED = 1e-3, 10, 32, 64
# Adam's eps for the comparison: some gradients are zero in exact
# arithmetic (a Dense bias feeding a BatchNorm, the key bias under the
# softmax, the final LayerNorm's bias before pooling and BN) and float32
# noise in either framework; with eps = 1e-8 Adam's first update turns
# that noise into ±lr, a different sign on each side.  eps = 1e-3 damps
# such noise below the tolerance and leaves real gradients (typically
# 1e-2 here) normalised as before.
EPS = 1e-3
QUIET = dict(hidden_dropout=0.0, activation_dropout=0.0,
             attention_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0)


def _batch(seed=2, t=3200):
    """Four unlike clips (a tone, a chirp, a noise burst, a square wave),
    so that the heads' BatchNorm over a batch of 4 sees features that
    vary across it: with near-alike clips a feature's batch variance is a
    small difference of large terms (flax's ``E[x²] − E[x]²``), and the
    normalisation magnifies float32 rounding by orders of magnitude."""
    rng = np.random.default_rng(seed)
    ax = np.arange(t) / 16000.0
    clean = np.stack([
        0.5 * np.sin(2 * np.pi * rng.uniform(100, 3000) * ax),
        np.sin(2 * np.pi * (200 + rng.uniform(1e4, 1e5) * ax) * ax),
        rng.standard_normal(t) * (ax > 0.1),
        np.sign(np.sin(2 * np.pi * rng.uniform(50, 400) * ax))])
    clean = clean + 0.01 * rng.standard_normal((4, t))
    noise = 0.2 * rng.standard_normal((4, t))
    snr = rng.choice([2.0, 5.0, 10.0, 20.0], 4)
    return {"clean": clean.astype(np.float32),
            "noise": noise.astype(np.float32),
            "snr": snr.astype(np.float32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def runs():
    """Two steps of each side from the same start, and the eval step of
    each after them."""
    jcfg = JaxConfig.tiny(ffn_impl="fused", dropout_impl="kernel", **QUIET)
    model = BYOLSpeechModel({"model": {"projection_dim": PROJ,
                                       "prediction_dim": PRED,
                                       "ema_decay": 0.997}},
                            encoder_config=jcfg)
    optimizer = make_byol_optimizer(LR, 1e-5, total_steps=STEPS_TOTAL)
    batch = _batch()
    state = jax_state(model, jax.random.PRNGKey(0),
                      jnp.zeros((4, 3200)), optimizer)
    start = _np(state.variables)
    step = jax_step(model, optimizer, fused_optimizer=JaxSpec(
        schedule=jax_cosine(LR, STEPS_TOTAL), weight_decay=1e-5, eps=EPS,
        ema_decay=0.997))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    for _ in range(2):
        state, m = step(state, jbatch)
        jmetrics.append(_np(m))
    jeval = _np(jax_eval(model)(state, jbatch))

    cfg = WavLMConfig.tiny(**QUIET)
    online_sd, target_sd = byol_variables_to_state_dicts(start, cfg)
    pstate = create_train_state(cfg, online_sd, PROJ, PRED,
                                target_state_dict=target_sd)
    pstep = make_byol_train_step(FusedAdamWSpec(
        schedule=cosine_annealing(LR, STEPS_TOTAL), weight_decay=1e-5,
        eps=EPS, ema_decay=0.997))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pmetrics = [pstep(pstate, tbatch) for _ in range(2)]
    peval = make_byol_eval_step()(pstate, tbatch)
    return (start, _np(state.variables), jmetrics, jeval, online_sd,
            pstate, pmetrics, peval, cfg)


def test_loss_and_grad_norm_match_jax(runs):
    _, _, jm, _, _, _, pm, _, _ = runs
    for j, p in zip(jm, pm):
        assert abs(float(p["loss"]) - float(j["loss"])) < LOSS_TOL
        assert _rel(float(p["grad_norm"]), float(j["grad_norm"])) < REL_TOL
        assert bool(p["finite"]) and float(p["valid_fraction"]) == 1.0
        assert p["layers_online"] == p["layers_target"] == 2


def test_params_ema_and_bn_stats_match_jax(runs):
    """The online parameters' updates, the target's values (after two
    EMA steps) and the BatchNorm statistics, each held to 1e-4 of the
    largest reference value of its group (for the updates the step's
    scale, ~lr): a tensor whose exact gradient is 0 moves by weight decay
    and noise alone and has no scale of its own, and a bias that starts
    at 0 has none either."""
    start, end, _, _, online0, pstate, _, _, cfg = runs
    want_online, want_target = byol_variables_to_state_dicts(end, cfg)
    got_online = {k: v.detach().numpy()
                  for k, v in pstate.online.state_dict().items()}
    got_target = {k: v.detach().numpy()
                  for k, v in pstate.target.state_dict().items()}
    assert set(got_online) == set(want_online)
    assert set(got_target) == set(want_target)
    groups = {"update": {}, "target": {}, "bn_stats": {}}
    for tower, got, want_sd in (("update", got_online, want_online),
                                ("target", got_target, want_target)):
        for k, want in want_sd.items():
            if "running" in k:
                groups["bn_stats"][f"{tower}:{k}"] = (got[k], want)
            elif tower == "update":
                groups[tower][k] = (got[k] - online0[k], want - online0[k])
            else:
                groups[tower][k] = (got[k], want)
    bad = {}
    for name, pairs in groups.items():
        scale = max(np.abs(ref).max() for _, ref in pairs.values())
        assert scale > 0, name
        for k, (got, ref) in pairs.items():
            err = float(np.abs(got - ref).max()) / scale
            if err > REL_TOL:
                bad[f"{name}:{k}"] = err
    assert not bad, bad


def test_eval_step_matches_jax(runs):
    jloss, jsim = runs[3]
    ploss, psim = runs[7]
    assert np.abs(ploss.numpy() - jloss).max() < LOSS_TOL
    assert np.abs(psim.numpy() - jsim).max() < LOSS_TOL


def _noisy_run(step_index=0):
    cfg = WavLMConfig.tiny()  # dropout 0.1 everywhere, LayerDrop 0.1,
    sd = init_byol_state_dict(cfg, PROJ, PRED,  # SpecAugment 0.05 / 10 / 2
                              torch.Generator().manual_seed(0))
    state = create_train_state(cfg, sd, PROJ, PRED, seed=7)
    state.step = step_index
    step = make_byol_train_step(FusedAdamWSpec(
        schedule=cosine_annealing(LR, STEPS_TOTAL)))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    m = step(state, batch)
    return m, state.params.clone()


def test_dropout_layerdrop_specaugment_run():
    m1, p1 = _noisy_run()
    m2, p2 = _noisy_run()
    m3, p3 = _noisy_run(step_index=1)
    assert bool(m1["finite"]) and torch.isfinite(p1).all()
    assert float(m1["loss"]) == float(m2["loss"]) and torch.equal(p1, p2)
    assert float(m3["loss"]) != float(m1["loss"])
