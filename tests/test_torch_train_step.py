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

The same comparison runs a second time with JAX's
``use_flash_attention=True``, so that the JAX side's attention is its
block kernel (forward and backward in interpret mode), the kernel pair the
port's attention (kernel A and K3, plain versions here) was ported from.

A third run feeds JAX's pre-mixed form (``on_device_mixing=False``: the
views ``clean_input_values`` and ``noisy_input_values`` in the batch,
every row valid) the same numpy views on both sides, through the train
step, the eval step and the embed step (the port's eval step with
``embeddings``), at the same tolerances (the embeddings to 1e-4
relative), with Adam's eps at ``PREMIXED_EPS`` (see there); its updates,
EMA target and BatchNorm statistics also over batch seeds 0-7, each
seed's updates held to twice JAX's own spread on it
(``PREMIXED_SEED_BOUNDS``).

A last test turns dropout, LayerDrop and SpecAugment on and checks the
port alone: the run is finite, the same seed gives the same result twice,
and another step draws other masks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.audio.augment import make_byol_views as jax_views
from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.ops.fused_optimizer import FusedAdamWSpec as JaxSpec
from nrse_tpu.train.byol_trainer import create_train_state as jax_state
from nrse_tpu.train.byol_trainer import make_byol_embed_step as jax_embed
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
from torch_init import with_random_biases

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
# The block-kernel run's parameter updates: JAX's own two attention paths
# (XLA's and the block kernel, both float32) give updates that differ by
# 1.44e-4 of the step's scale here (an update normalises a gradient entry
# of ~1e-7 absolute by Adam's eps), so the port is held to 3e-4 there and
# to REL_TOL everywhere else.
BLOCK_UPDATE_TOL = 3e-4
# The pre-mixed run compares its updates where they are not chaotic: at
# eps = 1e-3 an update normalises gradients of the order of eps, so the
# updates carry float32 noise far above 1e-4 of the step's scale (JAX's
# own step moves its updates by 1.7e-4 to 6.9e-3 of it when its views
# move by one float32 ulp, over batch seeds 0-7, and the port's gap to
# JAX reads 1.9e-4 to 1.3e-2 with either form of the views).  At eps =
# 0.1, above every gradient, Adam's first steps are nearly linear in the
# gradient, and the updates are held to REL_TOL, each parameter given
# PREMIXED_SPACINGS float32 spacings of its value (one rounding of the
# parameter a step: a unit-valued weight's spacing is 0.9e-4 of the
# step's scale here).
PREMIXED_EPS = 0.1
PREMIXED_SPACINGS = 2
# The pre-mixed updates over batch seeds 0-7, each held to twice JAX's
# own spread on its seed (``tools/premixed_spread.py``): the largest
# update error, at PREMIXED_SPACINGS, between JAX's step and the same
# step with its views one float32 ulp up or down, with its XLA FFN and
# dropout for its kernels, or with its block attention kernel for XLA's
# attention.  Each of those is a float32 evaluation as good as the
# reference, and two evaluations that each lie within the spread of a
# third lie within twice it of each other.  No bound is below REL_TOL,
# and seed 2 keeps its REL_TOL.  (At seed 6 BatchNorm over the batch of
# 4 magnifies float32 rounding in the heads' products into the first
# conv layer's bias: JAX's own variants move its update by up to 7.8e-4
# of the step's scale, the port's by 1.2e-3.)  Twice each seed's spread,
# rounded up at three digits:
PREMIXED_SEED_BOUNDS = {0: 1.76e-4, 1: 1.48e-4, 2: REL_TOL, 3: 1.61e-4,
                        4: 1.53e-4, 5: 3.50e-4, 6: 1.56e-3, 7: 1.07e-4}
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


def _premixed(batch):
    """The batch's views as JAX's device mixing makes them (so that JAX's
    pre-mixed step is its device-mixed step on them), fed to both sides
    as the same numpy arrays."""
    clean, noisy, _ = jax_views(
        *(jnp.asarray(batch[k]) for k in ("clean", "noise", "snr")))
    return {"clean_input_values": np.array(clean),
            "noisy_input_values": np.array(noisy)}


def _jax_run(batch, use_flash_attention: bool, on_device_mixing: bool,
             eps: float, kernels: bool = True):
    """JAX's two steps on ``batch`` from its seeded start, and its eval
    step after them (with pre-mixed views, the embed step's embeddings
    too): ``(start, end, metrics, eval outputs)``.  ``kernels`` False
    runs JAX's XLA FFN and dropout in place of its kernel configuration
    (the same start: the two configurations hold the same parameters)."""
    impls = dict(ffn_impl="fused", dropout_impl="kernel") if kernels \
        else {}
    jcfg = JaxConfig.tiny(use_flash_attention=use_flash_attention,
                          **impls, **QUIET)
    model = BYOLSpeechModel({"model": {"projection_dim": PROJ,
                                       "prediction_dim": PRED,
                                       "ema_decay": 0.997}},
                            encoder_config=jcfg)
    optimizer = make_byol_optimizer(LR, 1e-5, total_steps=STEPS_TOTAL)
    state = jax_state(model, jax.random.PRNGKey(0),
                      jnp.zeros((4, 3200)), optimizer)
    start = _np(state.variables)
    step = jax_step(model, optimizer, on_device_mixing=on_device_mixing,
                    fused_optimizer=JaxSpec(
                        schedule=jax_cosine(LR, STEPS_TOTAL),
                        weight_decay=1e-5, eps=eps, ema_decay=0.997))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    for _ in range(2):
        state, m = step(state, jbatch)
        jmetrics.append(_np(m))
    jeval = _np(jax_eval(model, on_device_mixing)(state, jbatch))
    if not on_device_mixing:
        jeval = jeval + _np(jax_embed(model, False)(state, jbatch))
    return start, _np(state.variables), jmetrics, jeval


def _runs(use_flash_attention: bool, on_device_mixing: bool = True,
          eps: float = EPS, seed: int = 2):
    """Two steps of each side from the same start on the batch of
    ``seed``, and the eval step of each after them (with pre-mixed views,
    the embed step's embeddings too)."""
    batch = _batch(seed)
    if not on_device_mixing:
        batch = _premixed(batch)
    start, end, jmetrics, jeval = _jax_run(batch, use_flash_attention,
                                           on_device_mixing, eps)

    cfg = WavLMConfig.tiny(**QUIET)
    online_sd, target_sd = byol_variables_to_state_dicts(start, cfg)
    pstate = create_train_state(cfg, online_sd, PROJ, PRED, "cpu",
                                target_state_dict=target_sd)
    pstep = make_byol_train_step(FusedAdamWSpec(
        schedule=cosine_annealing(LR, STEPS_TOTAL), weight_decay=1e-5,
        eps=eps, ema_decay=0.997), on_device_mixing=on_device_mixing)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pmetrics = [pstep(pstate, tbatch) for _ in range(2)]
    peval = make_byol_eval_step(not on_device_mixing,
                                on_device_mixing=on_device_mixing)(
        pstate, tbatch)
    return (start, end, jmetrics, jeval, online_sd, pstate, pmetrics,
            peval, cfg)


@pytest.fixture(scope="module")
def runs():
    """The JAX side on XLA's attention (its default)."""
    return _runs(False)


@pytest.fixture(scope="module")
def block_runs():
    """The JAX side on its block attention kernel."""
    return _runs(True)


@functools.lru_cache(maxsize=None)
def _premixed_seed_runs(seed: int):
    return _runs(False, on_device_mixing=False, eps=PREMIXED_EPS, seed=seed)


@pytest.fixture(scope="module")
def premixed_runs():
    """Both sides fed the same pre-mixed views."""
    return _premixed_seed_runs(2)


@pytest.mark.parametrize("seed", sorted(PREMIXED_SEED_BOUNDS))
def test_pre_mixed_updates_match_jax_over_batch_seeds(seed):
    _check_params_ema_and_bn_stats(_premixed_seed_runs(seed),
                                   PREMIXED_SEED_BOUNDS[seed],
                                   spacings=PREMIXED_SPACINGS)


def test_loss_and_grad_norm_match_jax(runs):
    _check_loss_and_grad_norm(runs)


def test_loss_and_grad_norm_match_jax_block_kernel(block_runs):
    _check_loss_and_grad_norm(block_runs)


def test_loss_and_grad_norm_match_jax_pre_mixed(premixed_runs):
    _check_loss_and_grad_norm(premixed_runs)


def _check_loss_and_grad_norm(runs):
    _, _, jm, _, _, _, pm, _, _ = runs
    for j, p in zip(jm, pm):
        assert abs(float(p["loss"]) - float(j["loss"])) < LOSS_TOL
        assert _rel(float(p["grad_norm"]), float(j["grad_norm"])) < REL_TOL
        assert bool(p["finite"]) and float(p["valid_fraction"]) == 1.0
        assert p["layers_online"] == p["layers_target"] == 2


def test_params_ema_and_bn_stats_match_jax(runs):
    _check_params_ema_and_bn_stats(runs)


def test_params_ema_and_bn_stats_match_jax_block_kernel(block_runs):
    _check_params_ema_and_bn_stats(block_runs, BLOCK_UPDATE_TOL)


def test_params_ema_and_bn_stats_match_jax_pre_mixed(premixed_runs):
    _check_params_ema_and_bn_stats(premixed_runs,
                                   spacings=PREMIXED_SPACINGS)


def _check_params_ema_and_bn_stats(runs, update_tol=REL_TOL, spacings=0):
    """The online parameters' updates, the target's values (after two
    EMA steps) and the BatchNorm statistics, each held to 1e-4 of the
    largest reference value of its group (for the updates the step's
    scale, ~lr): a tensor whose exact gradient is 0 moves by weight decay
    and noise alone and has no scale of its own, and a bias that starts
    at 0 has none either.  Each parameter's update may also differ by
    ``spacings`` float32 spacings of the parameter's value."""
    start, end, _, _, online0, pstate, _, _, cfg = runs
    errors = group_errors(end, online0, _state_dicts(pstate), cfg, spacings)
    bad = {f"{name}:{k}": err for name, errs in errors.items()
           for k, err in errs.items()
           if err > (update_tol if name == "update" else REL_TOL)}
    assert not bad, bad


def _state_dicts(pstate):
    """The port's online and target state dicts, as numpy."""
    return tuple({k: v.detach().numpy() for k, v in
                  getattr(pstate, tower).state_dict().items()}
                 for tower in ("online", "target"))


def group_errors(end, online0, got, cfg, spacings=0):
    """``{group: {name: error}}`` of the towers ``got`` (online and target
    state dicts) after two steps from ``online0`` against the JAX
    variables ``end``: the online parameters' updates (each less
    ``spacings`` float32 spacings of the parameter's value), the target's
    values and the BatchNorm statistics, each over the largest reference
    value of its group."""
    want_online, want_target = byol_variables_to_state_dicts(end, cfg)
    got_online, got_target = got
    assert set(got_online) == set(want_online)
    assert set(got_target) == set(want_target)
    groups = {"update": {}, "target": {}, "bn_stats": {}}
    for tower, got_sd, want_sd in (("update", got_online, want_online),
                                   ("target", got_target, want_target)):
        for k, want in want_sd.items():
            if "running" in k:
                groups["bn_stats"][f"{tower}:{k}"] = (got_sd[k], want)
            elif tower == "update":
                groups[tower][k] = (got_sd[k] - online0[k], want - online0[k],
                                    spacings * np.spacing(np.abs(want)))
            else:
                groups[tower][k] = (got_sd[k], want)
    errors = {}
    for name, pairs in groups.items():
        scale = max(np.abs(pair[1]).max() for pair in pairs.values())
        assert scale > 0, name
        errors[name] = {}
        for k, (got_t, ref, *rounding) in pairs.items():
            diff = np.abs(got_t - ref)
            if rounding:
                diff = np.maximum(diff - rounding[0], 0.0)
            errors[name][k] = float(diff.max()) / scale
    return errors


def test_eval_step_matches_jax(runs):
    _check_eval_step(runs)


def test_eval_step_matches_jax_block_kernel(block_runs):
    _check_eval_step(block_runs)


def test_eval_and_embed_steps_match_jax_pre_mixed(premixed_runs):
    _check_eval_step(premixed_runs)
    for got, want in zip(premixed_runs[7][2:], premixed_runs[3][2:]):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) < REL_TOL


def _check_eval_step(runs):
    jloss, jsim = runs[3][:2]
    ploss, psim = runs[7][:2]
    assert np.abs(ploss.numpy() - jloss).max() < LOSS_TOL
    assert np.abs(psim.numpy() - jsim).max() < LOSS_TOL


def _noisy_run(step_index=0):
    cfg = WavLMConfig.tiny()  # dropout 0.1 everywhere, LayerDrop 0.1,
    sd = with_random_biases(init_byol_state_dict(  # SpecAugment 0.05 / 10 / 2
        cfg, PROJ, PRED, torch.Generator().manual_seed(0)), 0)
    state = create_train_state(cfg, sd, PROJ, PRED, "cpu", seed=7)
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
