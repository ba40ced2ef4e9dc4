"""The port's data-parallel BYOL step: 2 gloo ranks × 2 rows against the
JAX package's single-device step on the global batch of 4.

The harness of ``tests/test_torch_train_step.py`` (tiny BYOL, projection
32, prediction 64, every random feature off, the JAX side with
``ffn_impl="fused"``, ``dropout_impl="kernel"`` and ``FusedAdamWSpec``,
two steps at lr 1e-3 on a cosine over 10 steps, Adam eps 1e-3), on its
four unlike clips, the second one with silent noise: the views' ``valid``
flag is 0 there, on rank 0 only, so the loss's denominator differs
between the ranks and only the global weight sum gives JAX's loss.  (With
the last clip's noise silent instead, the second step's gradient is five
times larger and one process of the port, without any reduction, already
differs from JAX by 1.8e-3 in grad_norm: that batch tests float32's
conditioning, not the reduction.)
Tolerances are that file's: the loss to 1e-5 absolute; grad_norm, the
EMA target and the BatchNorm running statistics to 1e-4 relative (of
their group's largest reference value); the parameter deltas to that
file's ``BLOCK_UPDATE_TOL``, 3e-4 of the step's scale, which it keeps for
two float32 paths that sum in other orders: Adam divides each gradient
element by its own size, so a frontend bias whose gradient is a sum that
cancels turns rounding into update.  Measured on this batch, one process
of the port (no reduction at all) differs from JAX by 1.64e-4 of the
scale (``encoder.feature_extractor.conv_layers.1.conv.bias``) and the two
ranks by 1.26e-4; on the plain batch by 0.62e-4 and 1.37e-4.  The two
ranks' flat buffers and BatchNorm statistics are bit-equal after every
step (``replicas_agree``) and at the end.

With dropout, LayerDrop and SpecAugment on, the data-parallel contract of
the random streams (``models.wavlm.TrainRNG``): every rank skips the same
layers; rank r's SpecAugment spans are rows ``[2r, 2r+2)`` of the
one-rank draw at the global batch, and so are the SER trunks' dropout
draws; rank r's kernel seeds are ``stream_seed ^ MIX_A·(r+1)``; at world
size 1 every seed is the one-process seed.  A 2-rank step with all of
them on is finite and its replicas agree.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.ops.fused_optimizer import FusedAdamWSpec as JaxSpec
from nrse_tpu.ops.kernel_rng import MIX_A as JAX_MIX_A
from nrse_tpu.train.byol_trainer import create_train_state as jax_state
from nrse_tpu.train.byol_trainer import make_byol_train_step as jax_step
from nrse_tpu.train.schedules import cosine_annealing as jax_cosine
from nrse_tpu.train.schedules import make_byol_optimizer
from nrse_tpu_torch.models.convert import (
    byol_variables_to_state_dicts,
    init_byol_state_dict,
)
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import (
    MIX_A,
    STREAM_HEAD_DROPOUT,
    TrainRNG,
    WavLMConfig,
    WavLMModel,
)
from nrse_tpu_torch.ops import philox
from nrse_tpu_torch.parallel.launch import run_ranks

import torch_dp_workers as workers
from test_torch_train_step import (
    BLOCK_UPDATE_TOL,
    EPS,
    LOSS_TOL,
    LR,
    PRED,
    PROJ,
    QUIET,
    REL_TOL,
    STEPS_TOTAL,
    _batch,
    _check_params_ema_and_bn_stats,
    _np,
    _rel,
)

torch.set_num_threads(1)

STEPS = 2


def _dp_batch():
    """The harness's clips; the second one's noise silent (valid = 0)."""
    batch = _batch()
    batch["noise"][1] = 0.0
    return batch


@pytest.fixture(scope="module")
def runs():
    jcfg = JaxConfig.tiny(ffn_impl="fused", dropout_impl="kernel", **QUIET)
    model = BYOLSpeechModel({"model": {"projection_dim": PROJ,
                                       "prediction_dim": PRED,
                                       "ema_decay": 0.997}},
                            encoder_config=jcfg)
    optimizer = make_byol_optimizer(LR, 1e-5, total_steps=STEPS_TOTAL)
    batch = _dp_batch()
    state = jax_state(model, jax.random.PRNGKey(0), jnp.zeros((4, 3200)),
                      optimizer)
    start = _np(state.variables)
    step = jax_step(model, optimizer, fused_optimizer=JaxSpec(
        schedule=jax_cosine(LR, STEPS_TOTAL), weight_decay=1e-5, eps=EPS,
        ema_decay=0.997))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    for _ in range(STEPS):
        state, m = step(state, jbatch)
        jmetrics.append(_np(m))
    cfg = WavLMConfig.tiny(**QUIET)
    online_sd, target_sd = byol_variables_to_state_dicts(start, cfg)
    ranks = run_ranks(workers.byol_steps, 2, (
        QUIET, online_sd, target_sd, batch, PROJ, PRED,
        (LR, STEPS_TOTAL, 1e-5, EPS, 0.997), STEPS))
    return start, _np(state.variables), jmetrics, online_sd, ranks, cfg


def test_loss_and_grad_norm_match_jax(runs):
    _, _, jmetrics, _, ranks, _ = runs
    for rank in ranks:
        for j, p in zip(jmetrics, rank["metrics"]):
            assert abs(p["loss"] - float(j["loss"])) < LOSS_TOL
            assert _rel(p["grad_norm"], float(j["grad_norm"])) < REL_TOL
            assert p["finite"] and p["valid_fraction"] == 0.75
            assert p["layers"] == (2, 2)
    # the invalid item moves JAX's loss: its denominator is 3, not 4
    assert float(jmetrics[0]["valid_fraction"]) == 0.75


def test_params_ema_and_bn_stats_match_jax(runs):
    start, end, _, online_sd, ranks, cfg = runs
    for rank in ranks:
        pstate = types.SimpleNamespace(**{
            tower: types.SimpleNamespace(state_dict=lambda sd=rank[tower]: {
                k: torch.from_numpy(v) for k, v in sd.items()})
            for tower in ("online", "target")})
        _check_params_ema_and_bn_stats(
            (start, end, None, None, online_sd, pstate, None, None, cfg),
            BLOCK_UPDATE_TOL)


def test_replicas_are_bit_equal(runs):
    ranks = runs[4]
    for rank in ranks:
        assert all(m["agree"] for m in rank["metrics"])
    a, b = (r["flat"] for r in ranks)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_mix_constant_is_jax_kernels():
    assert MIX_A == JAX_MIX_A


def test_kernel_seeds_mix_the_rank():
    for seed, step, tower, layer, site in [(7, 0, 0, 3, 1), (2**40 + 5, 9,
                                                             1, 0xFFFF, 0)]:
        base = philox.stream_seed(seed, step, tower, layer, site)
        assert TrainRNG(seed, step, tower).dropout_seed(layer, site) == base
        assert TrainRNG(seed, step, tower, 0, 1).dropout_seed(
            layer, site) == base
        for world in (2, 4):
            for rank in range(world):
                mix = (MIX_A * (rank + 1)) % 2**32
                got = TrainRNG(seed, step, tower, rank, world).dropout_seed(
                    layer, site)
                assert got == (base[0] ^ mix, base[1] ^ mix)


def test_host_draws_follow_the_global_batch():
    cfg = WavLMConfig.tiny()
    model = WavLMModel(cfg)
    one = TrainRNG(3, 5, 0)
    spans = model.time_mask(one, 4, 239)
    assert spans.any()
    keep = model.encoder.layer_keep(one)
    for rank in range(2):
        rng = TrainRNG(3, 5, 0, rank, 2)
        assert torch.equal(model.time_mask(rng, 2, 239),
                           spans[2 * rank:2 * rank + 2])
        assert model.encoder.layer_keep(rng) == keep
    # the SER trunks' dropout: the rank's rows of the one-rank draw
    clf = EmotionClassifier(cfg, hidden_dim=8, dropout=0.5)
    x = torch.ones(4, 8)
    full = clf._trunk("categorical", x, one.generator(STREAM_HEAD_DROPOUT),
                      one)
    for rank in range(2):
        rng = TrainRNG(3, 5, 0, rank, 2)
        part = clf._trunk("categorical", x[2 * rank:2 * rank + 2],
                          rng.generator(STREAM_HEAD_DROPOUT), rng)
        assert torch.equal(part, full[2 * rank:2 * rank + 2])


def test_random_features_on_two_ranks():
    cfg_kwargs = {}  # dropout 0.1 everywhere, LayerDrop 0.1, SpecAugment on
    cfg = WavLMConfig.tiny()
    sd = init_byol_state_dict(cfg, PROJ, PRED,
                              torch.Generator().manual_seed(0))
    online = {k: v.numpy() for k, v in sd.items()}
    ranks = run_ranks(workers.byol_steps, 2, (
        cfg_kwargs, online, None, _batch(), PROJ, PRED,
        (LR, STEPS_TOTAL, 1e-5, 1e-8, 0.997), 3))
    for a, b in zip(*(r["metrics"] for r in ranks)):
        assert a["finite"] and a["agree"] and b["agree"]
        assert a["layers"] == b["layers"]
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
