"""The SER train step's staged inputs and its graphed parts, on the CPU.

  1. The seed table (``models.wavlm.SeedTable``): every row equals
     ``TrainRNG.dropout_seed(layer, site)`` of its tower, for both towers
     and at world 1 and 2 (both ranks).
  2. The plain versions of K1, kernel A/K3 and kernel B/K2 given a table
     row draw the masks they drew from the pair itself, windows included.
  3. K4's staged scalars (``host_scalars`` on the device, the clip there)
     equal the vector the step built before (a copy of its code here) to
     the bit.
  4. The staged SER step (``make_emotion_train_step``: the draws and K4's
     scalars written to their slots first) equals the step with the
     model's own draws (a copy of the step before staging, here) bit for
     bit over 3 steps with LayerDrop, SpecAugment and every dropout on,
     frozen / top / whole, with a dropped layer among them.
  5. The captured step's parts (``train.step_graphs.StepGraphs`` as
     ``emotion_trainer.ser_step_graphs`` builds them) run eagerly in their
     order give the eager step's loss and gradients bit for bit, frozen /
     top / whole.
  6. ``runtime.graphs.ProgramCache``: one program per shape, a smaller
     request rewrites the padding rows a larger one left, and the outputs
     are copies; the eval step through it equals the eager one.
  7. The same class holds the fine-tune's micro-step
     (``train_ft_cat_ser.ft_step_graphs``): its parts run eagerly in their
     order, then its ``accumulate`` and (on the k-th micro-step) ``apply``
     parts, give the eager micro-step's loss, gradients, mean, moments and
     parameters bit for bit over two micro-steps at k = 2, end to end and
     frozen.
  8. ``ProgramCache`` with three inputs, one of them of another rank,
     rewrites every row of each; the BYOL eval and embed steps and
     ``WavLMEncoder`` through their programs equal their eager forms bit
     for bit, and the towers' modes are restored.
  9. The staged BYOL step (``byol_trainer.BYOLStepInputs``: both towers'
     table, draws and K4's scalars written first) equals the step before
     staging (a copy of its code here) bit for bit over 3 steps with
     dropout, LayerDrop and SpecAugment on, the towers keeping different
     layers and a layer dropped: loss, grad_norm, params, mu, nu, the
     target and both towers' BatchNorm statistics.
     The pre-mixed form on the views the device mixing makes is the
     device-mixed form, bit for bit, train step and eval/embed step.
     A state dropped with its graphs frees them without the cycle
     collector.
 10. ``StepGraphs`` as ``byol_trainer.byol_step_graphs`` builds it (the
     target a forward-only tower), on device-mixed and pre-mixed views:
     the warm-up leaves the BatchNorm statistics where they were and gives
     the eager step's loss and gradients; the parts run in replay order
     with the optimizer's give its loss, grad_norm, K4 update, EMA and
     statistics, bit for bit.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from nrse_tpu_torch.audio.augment import make_byol_views
from nrse_tpu_torch.audio.features import zero_mean_unit_var
from nrse_tpu_torch.baseline import train_ft_cat_ser as ft
from nrse_tpu_torch.baseline.pipeline import BaselineSER
from nrse_tpu_torch.models.convert import (
    init_baseline_state_dict,
    init_byol_state_dict,
    init_emotion_state_dict,
    init_state_dict,
)
from nrse_tpu_torch.models.encoder import WavLMEncoder
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import (
    ENCODER,
    SITES,
    SeedTable,
    TrainRNG,
    WavLMConfig,
)
from nrse_tpu_torch.ops import fused_dropout, fused_ffn, philox
from nrse_tpu_torch.ops.attention import attention_keep_mask
from nrse_tpu_torch.ops.block_attention import block_gated_attention
from nrse_tpu_torch.ops.fused_optimizer import (
    FusedAdamWSpec,
    device_scalars,
    fused_adamw_ema_update,
    host_scalars,
)
from nrse_tpu_torch.runtime.graphs import ProgramCache, audio_inputs
from nrse_tpu_torch.runtime.staging import Staging
from nrse_tpu_torch.models.byol import ONLINE, TARGET, byol_loss
from nrse_tpu_torch.train import byol_trainer as bt
from nrse_tpu_torch.train import emotion_trainer as et
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_eval_step,
)
from torch_init import with_random_biases

torch.set_num_threads(1)

LAYERS = 4
P = 0.3


@pytest.mark.parametrize("world", [1, 2])
def test_seed_table_rows_are_the_streams_pairs(world):
    table = SeedTable(LAYERS, towers=2)
    for rank in range(world):
        table.stage(0x1234_5678_9ABC, 17, rank, world)
        got = table.staging["seeds"]
        for tower in range(2):
            rng = TrainRNG(0x1234_5678_9ABC, 17, tower, rank, world)
            for i, layer in enumerate(list(range(LAYERS)) + [ENCODER]):
                for site in range(SITES):
                    row = table.row(tower, layer, site)
                    assert row.data_ptr() == got[tower, i, site].data_ptr()
                    assert philox.seed_pair(row) == rng.dropout_seed(
                        layer, site)


def test_seed_table_keeps_its_rows_addresses():
    table = SeedTable(LAYERS)
    row = table.row(0, 2, 1)
    ptr = row.data_ptr()
    for step in range(3):
        table.stage(5, step)
        assert table.row(0, 2, 1).data_ptr() == ptr
        assert philox.seed_pair(row) == TrainRNG(5, step).dropout_seed(2, 1)


def test_staging_slots_are_aligned_views_of_one_buffer():
    st = Staging("cpu", {"a": ((3,), torch.bool), "b": ((2, 2), torch.int32),
                         "c": ((5,), torch.float32)})
    for name in ("a", "b", "c"):
        assert st[name].data_ptr() % 16 == 0
        assert st.host(name).data_ptr() == st[name].data_ptr()
    st.begin()
    st.host("c").copy_(torch.arange(5.0))
    st.push()
    assert torch.equal(st["c"], torch.arange(5.0))


@pytest.mark.parametrize("window", [None, (32, 8)])
def test_k1_plain_from_a_table_row_is_the_pairs_mask(window):
    table = SeedTable(LAYERS).stage(9, 3)
    row = table.row(0, 1, 1)
    pair = TrainRNG(9, 3).dropout_seed(1, 1)
    x = torch.randn(2, 7, 16 if window else 32)
    want = philox.dump_mask(pair, 0, x.shape, P, window=window)
    y = fused_dropout.hw_dropout(x, row, P, window=window)
    assert torch.equal(y, x * want)
    assert torch.equal(fused_dropout.dump_dropout_mask(
        row, x.shape, P, window=window), want)


@pytest.mark.parametrize("window", [None, (64, 16)])
def test_kernel_a_k3_plain_from_a_table_row_is_the_pairs_mask(window):
    table = SeedTable(LAYERS).stage(9, 3)
    row = table.row(0, 2, 0)
    pair = TrainRNG(9, 3).dropout_seed(2, 0)
    g = torch.Generator().manual_seed(0)
    b, h, t, d = 2, 2, 37, 16
    q, k, v = (torch.randn(b, h, t, d, generator=g) for _ in range(3))
    gate = torch.rand(b, h, t, generator=g) + 0.5
    bias = torch.randn(h, t, t, generator=g)
    keep = attention_keep_mask(pair, (b, h, t, d), P, window=window)
    outs = []
    for kw in ({"p_drop": P, "dropout_seed": row, "dropout_window": window},
               {"dropout_mask": keep}):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = block_gated_attention(*leaves, gate, bias, **kw)
        out.backward(torch.ones_like(out))
        outs.append([out.detach()] + [x.grad for x in leaves])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("shard", [None, (64, 32)])
def test_kernel_b_k2_plain_from_a_table_row_is_the_pairs_mask(shard):
    table = SeedTable(LAYERS).stage(9, 3)
    row = table.row(0, 3, 2)
    g = torch.Generator().manual_seed(1)
    n, c, f = 9, 16, 32
    args = [torch.randn(n, c, generator=g), torch.randn(f, c, generator=g),
            torch.randn(f, generator=g), torch.randn(c, f, generator=g),
            torch.randn(c, generator=g)]
    pair = TrainRNG(9, 3).dropout_seed(3, 2)
    act = philox.dump_mask(pair, fused_ffn.SITE_ACT, (n, f), P,
                           window=shard)
    hid = philox.dump_mask(pair, fused_ffn.SITE_HID, (n, c), P)
    assert all(torch.equal(a, b) for a, b in zip(
        fused_ffn.dump_masks(row, n, c, f, P, P, shard), (act, hid)))
    runs = []
    for seeded in (True, False):
        leaves = [a.clone().requires_grad_() for a in args]
        if seeded:
            out = fused_ffn.fused_ffn(*leaves, row, P, P, shard=shard)
        else:
            drop = fused_ffn._Drop(masks=(act, hid))
            out = fused_ffn.FusedFFN.apply(*leaves, drop, shard)
        out.backward(torch.ones_like(out))
        runs.append([out.detach()] + [a.grad for a in leaves])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def _scalars_before(spec, count, grad_norm):
    """K4's scalar vector as the step built it before staging."""
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


@pytest.mark.parametrize("count", [0, 1, 7, 999])
@pytest.mark.parametrize("gn", [0.3, 1.0, 42.5])
def test_staged_k4_scalars_are_the_steps_vector(count, gn):
    for spec in (FusedAdamWSpec(schedule=3e-4, weight_decay=1e-4),
                 FusedAdamWSpec(schedule=lambda c: 1e-3 / (c + 1))):
        norm = torch.tensor(gn)
        staged = device_scalars(spec, norm, torch.from_numpy(
            host_scalars(spec, count)))
        assert torch.equal(staged, _scalars_before(spec, count, norm))


def _config(layerdrop: float = 0.3):
    return dataclasses.replace(WavLMConfig.tiny(), num_hidden_layers=LAYERS,
                               layerdrop=layerdrop)


def _state(cfg, seed=0):
    model = EmotionClassifier(cfg, 32, dropout=0.3, device="meta",
                              compute_dtype=torch.float32)
    model.load_state_dict(with_random_biases(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(15), 32), 15), strict=True,
        assign=True)
    return et.create_emotion_state(model, seed)


def _batch(n=4, samples=7680, seed=1):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((n, samples))).astype(np.float32)
    mask = np.ones((n, samples), np.float32)
    x[0, samples // 2:], mask[0, samples // 2:] = 0.0, 0.0
    out = {"input_values": x, "attention_mask": mask,
           "C": rng.integers(0, 10, n).astype(np.int32)}
    for k in ("A", "V", "D"):
        out[k] = rng.uniform(1, 7, n).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _step_before(state, batch, weights, layers, lr, rest):
    """The SER step as it ran before staging: the model draws inline from
    a TrainRNG with a table of its own, K4's scalars are built in the
    step."""
    segments = et.trainable_segments(state, layers, rest)
    state.grads.zero_()
    x = zero_mean_unit_var(batch["input_values"])
    logits, dims = state.model(x, batch["attention_mask"], "both",
                               TrainRNG(state.seed, state.step).with_table(
                                   state.model.encoder_config
                                   .num_hidden_layers, "cpu"))
    loss = et.emotion_loss("both", logits, dims, batch, weights)
    loss.backward()
    spec = et.adamw_spec(lr, 1e-4, 1.0)
    with torch.no_grad():
        grad_norm = et.global_norm(state.grads, segments)
        for lo, hi in segments:
            fused_adamw_ema_update(state.grads[lo:hi], state.params[lo:hi],
                                   state.mu[lo:hi], state.nu[lo:hi], None,
                                   spec, state.step, grad_norm)
    state.step += 1
    return loss.detach(), grad_norm


KEYS = [([], 0.0, 1e-4), ([2, 3], 0.0, 5e-6), ([0, 1, 2, 3], 1.0, 5e-6)]


@pytest.mark.parametrize("layers,rest,lr", KEYS,
                         ids=["frozen", "top", "whole"])
def test_staged_step_is_the_step_before_staging(layers, rest, lr):
    cfg = _config()
    staged, before = _state(cfg), _state(cfg)
    step = et.make_emotion_train_step("both", 1e-4)
    batch, weights = _batch(), torch.linspace(0.5, 1.5, 8)
    dropped = False
    for _ in range(3):
        keep = staged.model.encoder.encoder.layer_keep(
            TrainRNG(staged.seed, staged.step))
        dropped |= not all(keep)
        m = step(staged, batch, weights, layers, lr, rest)
        loss, grad_norm = _step_before(before, batch, weights, layers, lr,
                                       rest)
        assert m["layers_run"] == sum(keep)
        assert torch.equal(m["loss"], loss)
        assert torch.equal(m["grad_norm"], grad_norm)
        for k in ("params", "mu", "nu", "grads"):
            assert torch.equal(getattr(staged, k), getattr(before, k)), k
    assert dropped


@pytest.mark.parametrize("layers,rest,lr", KEYS,
                         ids=["frozen", "top", "whole"])
def test_graphed_parts_give_the_eager_gradients(layers, rest, lr):
    cfg = _config(layerdrop=0.0)  # the parts' warm-up runs every layer
    parts, eager = _state(cfg), _state(cfg)
    batch, weights = _batch(seed=2), torch.linspace(0.5, 1.5, 8)
    spec = et.adamw_spec(lr)
    for st in (parts, eager):
        segments = et.trainable_segments(st, layers, rest)
    inputs = et.step_inputs(eager, batch)
    rng = inputs.stage(eager, "both", spec)
    eager.grads.zero_()
    x = zero_mean_unit_var(batch["input_values"])
    logits, dims = eager.model(x, batch["attention_mask"], "both", rng)
    loss = et.emotion_loss("both", logits, dims, batch, weights)
    loss.backward()
    p_inputs = et.step_inputs(parts, batch)
    graphs = et.ser_step_graphs(parts, "both", spec, segments, batch,
                                weights, p_inputs.stage(parts, "both", spec),
                                p_inputs, key=None)
    assert not graphs.graphs  # nothing is captured on the CPU
    graphs.warm_up()
    assert torch.equal(graphs.loss, loss.detach())
    assert torch.equal(parts.grads, eager.grads)
    assert bool(eager.grads.abs().sum() > 0)


def test_program_cache_one_program_a_shape_padding_rewritten():
    calls = []

    def forward(audio, mask):
        calls.append(tuple(audio.shape))
        return audio.sum(-1) * 2.0, mask.sum(-1)

    cache = ProgramCache(forward, "cpu",
                         audio_inputs(mask_dtype=torch.float32))
    big = torch.arange(12.0).reshape(3, 4)
    out = cache(big, torch.ones(3, 4))
    assert torch.equal(out[0], big.sum(-1) * 2.0)
    small = torch.zeros(3, 4)
    small[0] = 1.0
    out2 = cache(small, torch.zeros(3, 4))
    program = cache.programs[((3, 4), (3, 4))]
    assert torch.equal(program.audio, small)  # the padding rows rewritten
    assert torch.equal(out2[0], small.sum(-1) * 2.0)
    assert torch.equal(out[0], big.sum(-1) * 2.0)  # a copy, untouched
    cache(torch.zeros(2, 8), torch.zeros(2, 8))
    cache.prepare([((3, 4),) * 2, ((2, 8),) * 2, ((1, 4),) * 2])
    assert sorted(cache.programs) == [((1, 4),) * 2, ((2, 8),) * 2,
                                      ((3, 4),) * 2]
    single = ProgramCache(lambda a, m: a * 3.0, "cpu")
    assert torch.equal(single(big, torch.ones(3, 4)), big * 3.0)


def test_eval_step_through_programs_is_the_eager_one():
    cfg = _config()
    state = _state(cfg)
    batch = _batch(seed=3)
    outs = [et.make_emotion_eval_step("both", graphs=g)(state.model, batch)
            for g in (True, False)]
    assert outs[0].keys() == outs[1].keys() == {"logits", "dims"}
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k])
    assert state.model.training  # the modes are restored


def _ft_state(freeze_ssl):
    cfg = dataclasses.replace(WavLMConfig.tiny(), num_hidden_layers=LAYERS,
                              layerdrop=0.0)  # the warm-up runs every layer
    model = BaselineSER(cfg, head_dim=32)
    model.load_state_dict(with_random_biases(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(6), head_dim=32), 6))
    return ft.create_train_state(model)


def _ft_batch(seed, samples=8000):  # 399 frames: K5's plain versions
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((2, samples))).astype(np.float32)
    mask = np.ones((2, samples), np.float32)
    mask[1, samples * 3 // 4:] = 0.0
    return {"input_values": torch.from_numpy(x),
            "attention_mask": torch.from_numpy(mask),
            "label": torch.from_numpy(rng.integers(0, 8, 2).astype(
                np.int32))}


@pytest.mark.parametrize("freeze_ssl", [False, True], ids=["e2e", "frozen"])
def test_fine_tune_parts_give_the_eager_micro_step(freeze_ssl):
    k, spec = 2, ft.adamw_spec(1e-3)
    weights = torch.linspace(0.5, 1.5, 8)
    parts, eager = _ft_state(freeze_ssl), _ft_state(freeze_ssl)
    step = ft.make_train_step(spec, k, freeze_ssl, weights)
    for i in range(k):
        batch = _ft_batch(30 + i)
        loss = step(eager, batch, TrainRNG(4, i))
        inputs = ft.step_inputs(parts, batch)
        rng = inputs.stage(parts, TrainRNG(4, i), spec)
        graphs = ft.ft_step_graphs(parts, spec, freeze_ssl, weights, batch,
                                   rng, inputs, key=None)
        assert not graphs.graphs  # nothing is captured on the CPU
        graphs.warm_up()
        assert [name for name, _ in graphs.optimizer] == ["accumulate",
                                                          "apply"]
        optimizer = dict(graphs.optimizer)
        with torch.no_grad():
            optimizer["accumulate"]()
            if i == k - 1:
                optimizer["apply"]()
        assert torch.equal(graphs.loss, loss), i
        for name in ("grads", "acc", "mu", "nu", "params"):
            assert torch.equal(getattr(parts, name), getattr(eager, name)), \
                (i, name)
        parts.mini_step = eager.mini_step
        parts.count = eager.count
    ssl = slice(0, eager.n_ssl)
    assert (float(eager.grads[ssl].abs().max()) == 0.0) == freeze_ssl
    assert bool(eager.grads[eager.n_ssl:].abs().sum() > 0)
    assert eager.count == 1 and float(eager.acc.abs().max()) == 0.0


def test_program_cache_three_inputs_every_row_rewritten():
    calls = []

    def forward(clean, noise, snr):
        calls.append(1)
        return clean.sum(-1) + noise.sum(-1) * snr, snr * 2.0

    specs = ((torch.float32, 0.0), (torch.float32, 0.0),
             (torch.float32, 0.0))
    cache = ProgramCache(forward, "cpu", specs)
    g = torch.Generator().manual_seed(0)
    clean, noise = torch.randn(3, 5, generator=g), torch.randn(3, 5,
                                                               generator=g)
    snr = torch.tensor([2.0, 5.0, 10.0])
    out = cache(clean, noise, snr)
    program = cache.programs[((3, 5), (3, 5), (3,))]
    again = cache(torch.zeros(3, 5), torch.ones(3, 5), torch.ones(3))
    for buf, want in zip(program.inputs, (torch.zeros(3, 5),
                                          torch.ones(3, 5), torch.ones(3))):
        assert torch.equal(buf, want)  # every row of every input
    assert torch.equal(out[0], clean.sum(-1) + noise.sum(-1) * snr)
    assert torch.equal(out[1], snr * 2.0)  # copies, left alone
    assert torch.equal(again[0], torch.full((3,), 5.0))
    cache(torch.zeros(2, 5), torch.zeros(2, 5), torch.zeros(2))
    assert sorted(cache.programs) == [((2, 5), (2, 5), (2,)),
                                      ((3, 5), (3, 5), (3,))]
    assert len(calls) == 3 and cache.captured == 0
    unmasked = ProgramCache(lambda a, m: a * 2.0 if m is None else a, "cpu",
                            audio_inputs(with_mask=False))
    assert torch.equal(unmasked(clean, torch.ones(3, 5)), clean * 2.0)
    assert list(unmasked.programs) == [((3, 5), None)]


def _byol_batch(seed=3, t=3200):
    rng = np.random.default_rng(seed)
    ax = np.arange(t) / 16000.0
    clean = np.stack([np.sin(2 * np.pi * f * ax) for f in (150, 400, 900)])
    clean = clean + 0.05 * rng.standard_normal((3, t))
    return {"clean": torch.from_numpy(clean.astype(np.float32)),
            "noise": torch.from_numpy(
                (0.2 * rng.standard_normal((3, t))).astype(np.float32)),
            "snr": torch.tensor([2.0, 10.0, 20.0])}


@pytest.mark.parametrize("embeddings", [False, True])
def test_byol_eval_step_through_programs_is_the_eager_one(embeddings):
    cfg = WavLMConfig.tiny()
    state = create_train_state(
        cfg, with_random_biases(init_byol_state_dict(
            cfg, 16, 32, torch.Generator().manual_seed(8)), 8),
        16, 32, "cpu")
    state.target.projector.bn_0.training = False  # a mode to restore
    modes = [m.training for m in state.online.modules()] + \
        [m.training for m in state.target.modules()]
    batch = _byol_batch()
    got = make_byol_eval_step(embeddings)(state, batch)
    want = make_byol_eval_step(embeddings, graphs=False)(state, batch)
    assert len(got) == len(want) == (4 if embeddings else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and bool(torch.isfinite(g).all())
    assert modes == [m.training for m in state.online.modules()] + \
        [m.training for m in state.target.modules()]
    assert list(state.programs) == [(embeddings, True)]
    assert list(state.programs[embeddings, True].programs) == [
        ((3, 3200), (3, 3200), (3,))]
    again = make_byol_eval_step(embeddings)(state, _byol_batch(4))
    assert list(state.programs[embeddings, True].programs) == [
        ((3, 3200), (3, 3200), (3,))]  # the state's cache, reused
    assert not torch.equal(again[0], got[0])


def test_wavlm_encoder_through_programs_is_the_eager_one():
    cfg = WavLMConfig.tiny()
    sd = with_random_biases(init_state_dict(
        cfg, torch.Generator().manual_seed(5)), 5)
    enc = WavLMEncoder(config=cfg, state_dict=sd, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 1, 4000, generator=g)
    mask = torch.ones(2, 4000, dtype=torch.int32)
    mask[1, 3000:] = 0
    for m in (None, mask):
        with torch.inference_mode():  # the eager forward
            seq, pooled = enc.model(x, m)
        assert torch.equal(enc(x, m), seq)
        assert torch.equal(enc.encode_pooled(x, m), pooled)
    assert set(enc.programs) == {None, torch.int32}
    assert list(enc.programs[None].programs) == [((2, 4000), None)]
    assert not enc.model.training


def _byol_state(cfg, seed=0):
    return create_train_state(
        cfg, with_random_biases(init_byol_state_dict(
            cfg, 16, 32, torch.Generator().manual_seed(8)), 8),
        16, 32, "cpu", seed=seed)


def _byol_spec():
    return FusedAdamWSpec(schedule=lambda c: 1e-3 / (c + 1),
                          weight_decay=1e-5, ema_decay=0.99)


def _byol_step_before(state, batch, spec, table):
    """The BYOL step as it ran before staging: the towers draw inline
    from their TrainRNGs over a two-tower table staged for the step, K4's
    scalars are built in the step."""
    online, target = state.online, state.target
    clean, noisy, valid = make_byol_views(batch["clean"], batch["noise"],
                                          batch["snr"])
    state.grads.zero_()
    table.stage(state.seed, state.step, 0, 1)
    pred, _, _ = online(clean, TrainRNG(state.seed, state.step, ONLINE,
                                        0, 1, table=table))
    layers_online = online.encoder.encoder.layers_run
    with torch.no_grad():
        proj, _ = target(noisy, TrainRNG(state.seed, state.step, TARGET,
                                         0, 1, table=table))
    layers_target = target.encoder.encoder.layers_run
    loss = byol_loss(pred, proj, weights=valid)
    loss.backward()
    with torch.no_grad():
        loss = loss.detach()
        grad_norm = torch.linalg.vector_norm(state.grads)
        fused_adamw_ema_update(state.grads, state.params, state.mu,
                               state.nu, state.target_params, spec,
                               state.step, grad_norm)
    state.step += 1
    return loss, grad_norm, layers_online, layers_target


def _byol_tensors(state):
    """Every tensor a BYOL step changes, by name."""
    return {**state.tensors(), "grads": state.grads}


def test_staged_byol_step_is_the_step_before_staging():
    cfg = _config()  # dropout 0.1, LayerDrop 0.3, SpecAugment on
    staged, before = _byol_state(cfg), _byol_state(cfg)
    spec, batch = _byol_spec(), _byol_batch()
    step = bt.make_byol_train_step(spec)
    table = SeedTable(LAYERS, 2)
    differ = dropped = False
    for _ in range(3):
        keeps = [staged.online.encoder.encoder.layer_keep(
            TrainRNG(staged.seed, staged.step, tower))
            for tower in (ONLINE, TARGET)]
        differ |= keeps[0] != keeps[1]
        dropped |= not all(keeps[0] + keeps[1])
        m = step(staged, batch)
        loss, grad_norm, on, tg = _byol_step_before(before, batch, spec,
                                                    table)
        assert (m["layers_online"], m["layers_target"]) == (
            on, tg) == tuple(map(sum, keeps))
        assert torch.equal(m["loss"], loss)
        assert torch.equal(m["grad_norm"], grad_norm)
        assert bool(m["finite"]) and float(m["valid_fraction"]) > 0
        want = _byol_tensors(before)
        for k, v in _byol_tensors(staged).items():
            assert torch.equal(v, want[k]), k
    assert differ and dropped
    assert staged.step == before.step == 3


def test_byol_step_graphs_free_with_their_state():
    cfg = _config(layerdrop=0.0)
    state, spec, batch = _byol_state(cfg), _byol_spec(), _byol_batch()
    inputs = bt.step_inputs(state, batch)
    views = {k: batch[k] for k in bt.VIEW_KEYS[True]}
    state.graphs = bt.byol_step_graphs(state, spec, views,
                                       inputs.stage(state, spec), inputs,
                                       True, key=None)
    refs = [weakref.ref(x) for x in (state, state.graphs)]
    gc.disable()  # freed by their counts alone: no cycle holds them
    try:
        del state
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def _premixed(batch):
    clean, noisy, _ = make_byol_views(batch["clean"], batch["noise"],
                                      batch["snr"])
    return {"clean_input_values": clean, "noisy_input_values": noisy}


def test_byol_pre_mixed_views_are_the_device_mixed_step():
    cfg = _config()
    mixed, premixed = _byol_state(cfg, 2), _byol_state(cfg, 2)
    batch = _byol_batch()
    steps = {form: bt.make_byol_train_step(_byol_spec(),
                                           on_device_mixing=form)
             for form in (True, False)}
    for _ in range(2):
        a = steps[True](mixed, batch)
        b = steps[False](premixed, _premixed(batch))
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
        want = _byol_tensors(mixed)
        for k, v in _byol_tensors(premixed).items():
            assert torch.equal(v, want[k]), k
    for embeddings in (False, True):
        got = make_byol_eval_step(embeddings, on_device_mixing=False)(
            premixed, _premixed(batch))
        want = make_byol_eval_step(embeddings)(mixed, batch)
        assert len(got) == len(want) == (4 if embeddings else 2)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sorted(premixed.programs) == [(False, False), (True, False)]


@pytest.mark.parametrize("mixing", [True, False],
                         ids=["on_device", "pre_mixed"])
def test_byol_graphed_parts_give_the_eager_step(mixing):
    cfg = _config(layerdrop=0.0)  # the parts' warm-up runs every layer
    parts, eager = _byol_state(cfg, 3), _byol_state(cfg, 3)
    spec = _byol_spec()
    batch = _byol_batch()
    if not mixing:
        batch = _premixed(batch)
    for _ in range(2):  # the second step's statistics start moved
        m = bt.make_byol_train_step(spec, on_device_mixing=mixing)(eager,
                                                                   batch)
        inputs = bt.step_inputs(parts, batch, mixing)
        rngs = inputs.stage(parts, spec)
        views = {k: batch[k] for k in bt.VIEW_KEYS[mixing]}
        graphs = bt.byol_step_graphs(parts, spec, views, rngs, inputs,
                                     mixing, key=None)
        assert not graphs.graphs  # nothing is captured on the CPU
        stats = [b.clone() for b in graphs.buffers]
        assert len(stats) == 12  # both towers' BatchNorm statistics
        graphs.warm_up()
        assert all(torch.equal(b, s) for b, s in zip(graphs.buffers, stats))
        assert torch.equal(graphs.loss, m["loss"])
        assert torch.equal(parts.grads, eager.grads)
        graphs._build(None, optimizer=True)  # the parts in replay order
        grad_norm, valid_fraction, finite = graphs.outputs["optimizer"]
        assert torch.equal(graphs.loss, m["loss"])
        assert torch.equal(grad_norm, m["grad_norm"])
        assert torch.equal(valid_fraction, m["valid_fraction"])
        assert bool(finite) and bool(m["finite"])
        want = _byol_tensors(eager)
        for k, v in _byol_tensors(parts).items():
            assert torch.equal(v, want[k]), k
        assert not all(torch.equal(b, s) for b, s in zip(graphs.buffers,
                                                         stats))
        parts.step += 1
