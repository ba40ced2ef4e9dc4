"""The port's tensor-parallel BYOL step against the JAX package's step
and against the port's own step without a model axis.

The harness of ``tests/test_torch_dp_byol.py`` (tiny BYOL, every random
feature off, its batch of four unlike clips with the second one's noise
silent, two steps at lr 1e-3, Adam eps 1e-3, the JAX side with
``ffn_impl="fused"``, ``dropout_impl="kernel"`` and ``FusedAdamWSpec`` on
one device) and its tolerances: the loss to 1e-5 absolute; grad_norm,
the EMA target and the BatchNorm running statistics to 1e-4 relative;
the parameter deltas to 3e-4 of the step's scale.  The port runs at
``{data: 1, model: 2}`` (2 gloo ranks, the tiny encoder's 4 heads and 128
FFN columns split in two) and at ``{data: 2, model: 2}`` (4 ranks); its
state comes back gathered into the ``model: 1`` layout.

  * The first step's gradients of the replicated parameters each rank
    uses for its own heads (``gru_rel_pos_linear``,
    ``gru_rel_pos_const`` and layer 0's ``rel_attn_embed``) are held to
    ``jax.grad`` of JAX's loss at the same parameters, to 1e-4 of each
    tensor's largest value: a rank that summed only its own heads would
    be off by about half of it.
  * Replicas agree after every step (every rank in the replicated state,
    each data group in its shards), and every rank gathers the same
    ``model: 1`` state.
  * With dropout, LayerDrop and SpecAugment on, the step at ``{data: 1,
    model: 2}`` against the port's step in one process on the same seed
    and the harness's batch: the shards draw the slices of the whole
    layer's masks, so the two runs take the same random choices; and the
    first step's gradients to 1e-4 of each tensor's largest value, but
    for the biases whose exact gradient is 0 (``test_torch_train_step.
    py``'s ``EPS`` comment), which hold float32 noise on both sides.  Each
    gap is held to the larger of its tolerance and twice the one-process
    step's own spread: the largest change of the same quantity when the
    pooled embeddings entering both towers' projectors move one float32
    ulp, by four draws of random signs.  The heads (BatchNorm over 4 rows,
    the cosine) turn such an ulp into up to 4.6e-4 of a gradient on this
    batch, and the model axis' partial sums leave rounding of that size
    there (``tools/tp_heads_spread.py``: over draws 0-5 of the seeded
    start no gradient's gap passed 1.39 times its spread).  (On
    ``test_torch_train_step.py``'s batch the updates of two steps differ by
    4.2e-4 of the step's scale at ``conv_layers.0.conv.bias``, an element
    whose gradient, 5e-3 against Adam's eps of 1e-3, differs by 6e-4 of
    itself while the tensor agrees to 1.2e-5 of its largest value: Adam's
    division turns the two paths' summation orders into update there.)
  * The encoder at 400 frames (over ``BLOCK_MAX_T``: K5's plain path and
    K1 over the merged shard), in training mode, at ``model: 2`` against
    ``model: 1``: its output and every gradient of a weighted sum of it.
  * Checkpoints: a ``model: 1`` checkpoint restored at ``model: 2`` gathers
    back to the file bit for bit, and what the ``model: 2`` run saves after
    a step is restored by a ``model: 1`` state bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.audio.augment import make_byol_views
from nrse_tpu.models.byol import BYOLSpeechModel, BYOLVariables, byol_loss
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.ops.fused_optimizer import FusedAdamWSpec as JaxSpec
from nrse_tpu.train.byol_trainer import _step_rngs
from nrse_tpu.train.byol_trainer import create_train_state as jax_state
from nrse_tpu.train.byol_trainer import make_byol_train_step as jax_step
from nrse_tpu.train.schedules import cosine_annealing as jax_cosine
from nrse_tpu.train.schedules import make_byol_optimizer
from nrse_tpu_torch.models.convert import (
    byol_variables_to_state_dicts,
    init_byol_state_dict,
    init_state_dict,
)
from nrse_tpu_torch.models.wavlm import BLOCK_MAX_T, WavLMConfig
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.parallel.launch import run_ranks
from nrse_tpu_torch.train import checkpoint
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_train_step,
)
from nrse_tpu_torch.train.schedules import cosine_annealing

import torch_dp_workers as dp_workers
import torch_tp_workers as tp_workers
from test_torch_dp_byol import _dp_batch
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
from torch_init import with_random_biases

torch.set_num_threads(1)

STEPS = 2
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}  # name: (ranks, model)
OPT = (LR, STEPS_TOTAL, 1e-5, EPS, 0.997)
PER_HEAD = ("attention.gru_rel_pos_linear.weight",
            "attention.gru_rel_pos_linear.bias",
            "attention.gru_rel_pos_const")


@pytest.fixture(scope="module")
def jax_side():
    """JAX's gradients at the start and its two steps, one device."""
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
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    clean, noisy, valid = make_byol_views(jbatch["clean"], jbatch["noise"],
                                          jbatch["snr"])
    variables = state.variables

    def loss_fn(params):
        pred, proj, _ = model.apply(
            BYOLVariables(online={**variables.online, "params": params},
                          target=variables.target),
            clean, noisy, deterministic=False,
            rngs=_step_rngs(state.rng, state.step))
        return byol_loss(pred, proj, weights=valid)

    grads = _np(jax.grad(loss_fn)(variables.online["params"]))
    jgrads, _ = byol_variables_to_state_dicts(
        {"online": {"params": grads,
                    "batch_stats": start.online["batch_stats"]},
         "target": start.target}, WavLMConfig.tiny(**QUIET))
    step = jax_step(model, optimizer, fused_optimizer=JaxSpec(
        schedule=jax_cosine(LR, STEPS_TOTAL), weight_decay=1e-5, eps=EPS,
        ema_decay=0.997))
    jmetrics = []
    for _ in range(STEPS):
        state, m = step(state, jbatch)
        jmetrics.append(_np(m))
    online_sd, target_sd = byol_variables_to_state_dicts(
        start, WavLMConfig.tiny(**QUIET))
    return {"start": start, "end": _np(state.variables),
            "metrics": jmetrics, "grads": jgrads, "online": online_sd,
            "target": target_sd, "batch": batch}


@pytest.fixture(scope="module", params=list(MESHES))
def tp_run(request, jax_side):
    ranks, model = MESHES[request.param]
    return run_ranks(dp_workers.byol_steps, ranks, (
        QUIET, jax_side["online"], jax_side["target"], jax_side["batch"],
        PROJ, PRED, OPT, STEPS, model))


def test_loss_and_grad_norm_match_jax(jax_side, tp_run):
    for rank in tp_run:
        for j, p in zip(jax_side["metrics"], rank["metrics"]):
            assert abs(p["loss"] - float(j["loss"])) < LOSS_TOL
            assert _rel(p["grad_norm"], float(j["grad_norm"])) < REL_TOL
            assert p["finite"] and p["valid_fraction"] == 0.75
            assert p["layers"] == (2, 2)


def test_params_ema_and_bn_stats_match_jax(jax_side, tp_run):
    cfg = WavLMConfig.tiny(**QUIET)
    for rank in tp_run:
        pstate = types.SimpleNamespace(**{
            tower: types.SimpleNamespace(state_dict=lambda sd=rank[tower]: {
                k: torch.from_numpy(v) for k, v in sd.items()})
            for tower in ("online", "target")})
        _check_params_ema_and_bn_stats(
            (jax_side["start"], jax_side["end"], None, None,
             jax_side["online"], pstate, None, None, cfg), BLOCK_UPDATE_TOL)


def test_per_head_replicated_gradients_match_jax(jax_side, tp_run):
    names = [f"encoder.encoder.layers.{i}.{n}" for i in range(2)
             for n in PER_HEAD]
    names.append("encoder.encoder.layers.0.attention.rel_attn_embed.weight")
    for rank in tp_run:
        for k in names:
            assert _rel(rank["grads"][k], jax_side["grads"][k]) < REL_TOL, k


def test_replicas_agree(tp_run):
    for rank in tp_run:
        assert rank["split"] > 0
        assert all(m["agree"] for m in rank["metrics"])
    first = tp_run[0]["flat"]
    for rank in tp_run[1:]:
        assert rank["flat"].keys() == first.keys()
        for k in first:
            np.testing.assert_array_equal(rank["flat"][k], first[k], k)


def _one_process(cfg, sd, batch, steps, signs=None):
    """The port's step without a mesh: the state after ``steps`` steps,
    their metrics and the first step's gradients (``model: 1`` layout).
    ``signs``: a seed; the pooled embeddings entering both towers'
    projectors move one float32 ulp, each element by a random sign drawn
    from it."""
    state = create_train_state(cfg, sd, PROJ, PRED, "cpu", seed=7)
    if signs is not None:
        for i, head in enumerate((state.online.projector,
                                  state.target.projector)):
            def nudge(module, args, i=i):
                gen = torch.Generator().manual_seed(2 * signs + i)
                sign = 2 * torch.randint(0, 2, tuple(args[0].shape),
                                         generator=gen) - 1
                return (args[0] * (1 + sign * 2.0 ** -23),) + args[1:]
            head.register_forward_pre_hook(nudge)
    step = make_byol_train_step(FusedAdamWSpec(
        schedule=cosine_annealing(LR, STEPS_TOTAL), weight_decay=1e-5,
        eps=EPS, ema_decay=0.997))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics, grads = [], None
    for _ in range(steps):
        metrics.append(step(state, tbatch))
        if grads is None:
            grads = {k: v.numpy().copy() for k, v in
                     state.gathered(state.grads, "online").items()}
    return state, metrics, grads


# gradients that are 0 in exact arithmetic (a Dense bias feeding a
# BatchNorm, the key bias under the softmax, the final LayerNorm's bias
# before pooling and BatchNorm): float32 noise on both sides
ZERO_GRADS = ("projector.dense_0.bias", "projector.dense_1.bias",
              "predictor.dense_0.bias", "predictor.dense_1.bias",
              "projector.bn_1.bias", "encoder.encoder.layer_norm.bias",
              "attention.k_proj.bias")


def _group_gaps(got, want, start):
    """``_check_params_ema_and_bn_stats``'s groups, against the port's
    state dicts: ``{(group, name): gap}``, the online updates over the
    step's scale, the target and the BatchNorm statistics over the
    largest value of their group."""
    groups = {"update": {}, "target": {}, "bn_stats": {}}
    for tower in ("online", "target"):
        for k, ref in want[tower].items():
            if "running" in k:
                groups["bn_stats"][f"{tower}:{k}"] = (got[tower][k], ref)
            elif tower == "online":
                groups["update"][k] = (got[tower][k] - start[k],
                                       ref - start[k])
            else:
                groups["target"][k] = (got[tower][k], ref)
    out = {}
    for name, pairs in groups.items():
        scale = max(np.abs(ref).max() for _, ref in pairs.values())
        for k, (g, ref) in pairs.items():
            out[name, k] = float(np.abs(g - ref).max() / scale)
    return out


# each gap's own tolerance (the harness's), by family
TOLS = {"grad": REL_TOL, "loss": LOSS_TOL, "grad_norm": REL_TOL,
        "update": BLOCK_UPDATE_TOL, "target": REL_TOL, "bn_stats": REL_TOL}


def _gaps(got, want, start):
    """``{(family, name): gap}`` of a run's record (``dp_workers.
    byol_steps``' keys) against ``want``'s: the first step's gradients
    (but :data:`ZERO_GRADS`) over each tensor's largest value, each
    step's loss and grad_norm, and :func:`_group_gaps`."""
    out = {("grad", k): _rel(got["grads"][k], g)
           for k, g in want["grads"].items() if not k.endswith(ZERO_GRADS)}
    for i, (m, p) in enumerate(zip(want["metrics"], got["metrics"])):
        out["loss", i] = abs(p["loss"] - m["loss"])
        out["grad_norm", i] = _rel(p["grad_norm"], m["grad_norm"])
    return {**out, **_group_gaps(got, want, start)}


def test_random_features_match_one_process():
    cfg = WavLMConfig.tiny()  # dropout 0.1, LayerDrop 0.1, SpecAugment on
    sd = with_random_biases(init_byol_state_dict(
        cfg, PROJ, PRED, torch.Generator().manual_seed(0)), 0)
    batch = _dp_batch()
    start = {k: v.numpy() for k, v in sd.items()}

    def one_process(signs=None):
        state, metrics, grads = _one_process(cfg, sd, batch, STEPS, signs)
        return {"grads": grads,
                "metrics": [{"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "layers": (m["layers_online"],
                                        m["layers_target"])}
                            for m in metrics],
                **{tower: {k: v.numpy() for k, v in
                           getattr(state, tower).state_dict().items()}
                   for tower in ("online", "target")}}

    want = one_process()
    spread = {}
    for signs in range(4):
        for key, gap in _gaps(one_process(signs), want, start).items():
            spread[key] = max(spread.get(key, 0.0), gap)
    ranks = run_ranks(dp_workers.byol_steps, 2, (
        {}, {k: v.numpy() for k, v in sd.items()}, None, batch, PROJ, PRED,
        OPT, STEPS, 2))
    for rank in ranks:
        for key, gap in _gaps(rank, want, start).items():
            assert gap < max(TOLS[key[0]], 2 * spread[key]), (key, gap)
        for m, p in zip(want["metrics"], rank["metrics"]):
            assert p["layers"] == m["layers"]
            assert p["agree"]
    # the LayerDrop draws of these two steps skip a layer somewhere
    assert any(p["layers"] != (2, 2) for p in ranks[0]["metrics"])


def test_encoder_beyond_block_attention_matches_model_1():
    cfg = WavLMConfig.tiny()
    sd = {k: v.numpy() for k, v in
          with_random_biases(init_state_dict(
              cfg, torch.Generator().manual_seed(1)), 1).items()}
    samples = 20 * (BLOCK_MAX_T + 16) + 400  # 400 frames of tiny's stride
    waves = np.random.default_rng(3).standard_normal(
        (2, samples)).astype(np.float32)
    one, two = (run_ranks(tp_workers.encoder_k5, n, (n, sd, waves, 11))
                for n in (1, 2))
    ref = one[0]
    assert ref["seq"].shape[1] > BLOCK_MAX_T
    for rank in two:
        assert rank["layers"] == ref["layers"]
        assert _rel(rank["seq"], ref["seq"]) < REL_TOL
        for k, g in ref["grads"].items():
            if not k.endswith(ZERO_GRADS):
                assert _rel(rank["grads"][k], g) < REL_TOL, k


def test_checkpoints_cross_the_model_axis(tmp_path):
    cfg = WavLMConfig.tiny(**QUIET)
    sd = with_random_biases(init_byol_state_dict(
        cfg, PROJ, PRED, torch.Generator().manual_seed(0)), 0)
    state = create_train_state(cfg, sd, PROJ, PRED, "cpu", seed=3)
    make_byol_train_step(FusedAdamWSpec(schedule=1e-3))(
        state, {k: torch.from_numpy(v) for k, v in _batch().items()})
    src, dst = str(tmp_path / "model1"), str(tmp_path / "model2")
    checkpoint.save_checkpoint(src, "last_model", state, {"epoch": 0})
    ranks = run_ranks(tp_workers.tp_checkpoint, 2, (
        2, QUIET, {k: v.numpy() for k, v in sd.items()}, _batch(), src,
        dst))
    for rank in ranks:
        assert rank["restored_bit_equal"] and rank["agree"]
        assert rank["step"] == 2
    assert ranks[0]["loss"] == ranks[1]["loss"]
    back = create_train_state(cfg, sd, PROJ, PRED, "cpu", seed=3)
    checkpoint.restore_checkpoint(dst, "last_model", back)
    saved = torch.load(f"{dst}/last_model/{checkpoint.STATE_FILE}",
                       weights_only=True)["tensors"]
    got = checkpoint.state_tensors(back)
    assert got.keys() == saved.keys() and back.step == 2
    for k, v in saved.items():
        assert torch.equal(got[k].view(torch.int32), v.view(torch.int32)), k


def test_position_bias_gradient_is_the_same_bits_twice():
    """The table's gradient through the dense bias and through the
    generator sums in a fixed order: two backward passes on several
    threads give the same bits (an index's backward, ``index_put_`` with
    accumulation, adds in thread order on the CPU), and the plain index's
    gradient within float64 rounding."""
    from nrse_tpu_torch.ops import rel_pos_bias as rpb

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        g = torch.Generator().manual_seed(5)
        table = torch.randn(320, 16, generator=g, dtype=torch.float64)
        for t, form in ((249, "dense"), (499, "generator")):
            outs = []
            for _ in range(2):
                tab = table.clone().requires_grad_()
                if form == "dense":
                    bias = rpb.compute_position_bias(tab, t, t)
                else:
                    bias = rpb.rel_bias_vector(tab, t)
                w = torch.randn(bias.shape, generator=torch.Generator()
                                .manual_seed(t), dtype=torch.float64)
                (bias * w).sum().backward()
                outs.append(tab.grad)
            assert torch.equal(outs[0], outs[1])
            tab = table.clone().requires_grad_()
            if form == "dense":
                idx = torch.from_numpy(
                    rpb.relative_position_buckets(t, t).copy())
                ref = tab[idx].permute(2, 0, 1)
            else:
                idx = torch.from_numpy(
                    rpb.bucket_of_relative_position(t).copy())
                ref = tab[idx].t()
            assert torch.equal(ref.detach(), bias.detach())
            (ref * w).sum().backward()
            torch.testing.assert_close(outs[0], tab.grad, rtol=1e-12,
                                       atol=1e-12)
    finally:
        torch.set_num_threads(threads)
