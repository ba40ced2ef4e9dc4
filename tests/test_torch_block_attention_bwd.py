"""K3 on the CPU: the port's block attention with output dropout, forward
and backward (the plain versions its wrapper takes for CPU tensors),
against the JAX Pallas kernel in interpret mode differentiated by
``jax.vjp``; the dropout-mask contract; and a tiny train step through the
kernel route against the separate-dropout route (plain attention under
autograd, then K1 at the attention-output site).

Float32 throughout.  Tolerances: out and every gradient ≤ 1e-4 of the
reference's max|·| against JAX (the two differ only in the order of float32
sums); the mask bit for bit; the train step's loss and flat gradient
≤ 1e-5 relative (the routes differ only in where float32 rounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops.attention import gated_bias_attention as jax_xla_attention
from nrse_tpu.ops.block_attention import (
    block_gated_attention as jax_block_attention,
)
from nrse_tpu_torch.models import wavlm
from nrse_tpu_torch.models.convert import init_byol_state_dict
from nrse_tpu_torch.models.wavlm import SITE_ATTN, TrainRNG, WavLMConfig
from nrse_tpu_torch.ops import block_attention, fused_dropout, philox
from nrse_tpu_torch.ops.attention import (
    attention_keep_mask,
    gated_bias_attention,
    gated_bias_attention_bwd,
    gated_bias_attention_lse,
    grouped_dbias,
    mask_add,
)
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_train_step,
)
from torch_init import with_random_biases

torch.set_num_threads(1)

B, H, D = 2, 4, 16
P_DROP = 0.25
JAX_TOL = 1e-4
ROUTE_TOL = 1e-5
NAMES = ("out", "dq", "dk", "dv", "dgate", "dbias")
H100_SMS = 132


def make_inputs(t, seed=0, fully_masked=False, b=B):
    """q, k, v, gate, bias, key mask, dropout keep mask and the output's
    cotangent, as numpy float32.  Sample 0 keeps 70% of its keys; sample 1
    40%, or none; any others all."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, H, t, D)).astype(np.float32)
               for _ in range(3))
    gate = rng.uniform(0.5, 2.5, (b, H, t)).astype(np.float32)
    bias = rng.standard_normal((H, t, t)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[0, int(0.7 * t):] = 0
    mask[1, 0 if fully_masked else int(0.4 * t):] = 0
    keep = ((rng.random((b, H, t, D)) >= P_DROP) / (1 - P_DROP)
            ).astype(np.float32)
    cot = rng.standard_normal((b, H, t, D)).astype(np.float32)
    return (q, k, v, gate, bias), mask, keep, cot


def _jax_run(fn, arrays, mask, keep, cot):
    jm, jk = jnp.asarray(mask), jnp.asarray(keep)

    def f(q, k, v, gate, bias):
        return fn(q, k, v, gate, bias, jm, jk)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(cot)))]


def _jax_block(arrays, mask, keep, cot):
    return _jax_run(lambda *a: jax_block_attention(*a[:6], dropout_mask=a[6]),
                    arrays, mask, keep, cot)


def _port_run(arrays, mask, **drop):
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = block_attention.block_gated_attention(
        *tensors, torch.from_numpy(mask), **drop)
    return out, tensors


def _port_block(arrays, mask, keep, cot):
    out, tensors = _port_run(arrays, mask, dropout_mask=torch.from_numpy(keep))
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [x.grad.numpy() for x in tensors]


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("t,fully_masked,b", [(37, False, B),
                                              (128, True, B),
                                              (200, False, B),
                                              pytest.param(
                                                  100, False, 5,
                                                  marks=pytest.mark.fast)],
                         ids=["37-False", "128-True", "200-False",
                              "100-False-B5"])
def test_forward_and_backward_match_jax_block_kernel(t, fully_masked, b):
    """At T = 128 the JAX kernel pads nothing, so the fully masked sample
    is held to it too (both recompute p = exp(s − lse) from the rounded
    lse there; ROADMAP Queue 3).  B = 5 is not a multiple of the plain
    version's dbias group (4): the grouped sum over a group of 4 and one of
    1 against the JAX kernel's sum over the batch."""
    inputs = make_inputs(t, seed=t, fully_masked=fully_masked, b=b)
    ours = _port_block(*inputs)
    ref = _jax_block(*inputs)
    errs = {n: _rel(a, b) for n, a, b in zip(NAMES, ours, ref)}
    assert all(np.isfinite(a).all() for a in ours)
    assert max(errs.values()) <= JAX_TOL, errs


@pytest.mark.parametrize("t", [37, 200])
def test_fully_masked_sample_is_the_uniform_mean(t):
    """Where T is not a multiple of 128 the JAX kernel pads keys with zero
    values, which scales a fully masked row's mean; that sample's output is
    held to JAX's XLA attention (the uniform mean of v, times the keep
    mask) instead, and its gradients must be finite."""
    inputs = make_inputs(t, seed=t + 1, fully_masked=True)
    (q, k, v, gate, bias), mask, keep, cot = inputs
    ours = _port_block(*inputs)
    ref = np.asarray(jax_xla_attention(
        *(jnp.asarray(a) for a in (q, k, v, gate, bias)),
        jnp.asarray(mask))) * keep
    assert _rel(ours[0], ref) <= JAX_TOL
    assert all(np.isfinite(a).all() for a in ours)


@pytest.mark.fast
@pytest.mark.parametrize("b", [1, 2, 5, 36])
@pytest.mark.parametrize("t,route", [(1, "wgmma"), (63, "wgmma"),
                                     (65, "wgmma"), (249, "wgmma"),
                                     (256, "wgmma"), (257, "mma_sync"),
                                     (384, "mma_sync")])
def test_attention_bwd_plan(b, t, route):
    """K3's route by T_pad (wgmma up to 256 frames, as kernel A), and the
    dbias partials the wrapper allocates: on the wgmma route one [H, T, T]
    slice per group of at least 4 batches (the fewest whose dq blocks fit
    an H100's 132 SMs, two an SM, in one wave), none for one group, never
    more than ceil(B/4) slices; on the mma.sync route one a batch.  Two
    wgmma blocks fit an SM's shared memory."""
    h = 16
    plan = block_attention.attention_bwd_plan(b, h, t, H100_SMS)
    assert plan["route"] == route
    assert plan["tiles"] == -(-t // 64)
    if route == "wgmma":
        g = plan["group"]
        assert g >= 4 and plan["groups"] == -(-b // g)
        if g > 4:  # no smaller group fits one wave
            assert plan["tiles"] * h * -(-b // (g - 1)) > 2 * H100_SMS
            assert plan["dq_blocks"] <= 2 * H100_SMS
        assert plan["partial"] == (plan["groups"] * h * t * t
                                   if plan["groups"] > 1 else 0)
        assert plan["partial"] <= -(-b // 4) * h * t * t
        assert plan["dq_blocks"] == plan["tiles"] * h * plan["groups"]
        assert plan["dkdv_blocks"] == plan["tiles"] * b * h
        for smem in (plan["dq_smem"], plan["dkdv_smem"]):
            assert 2 * (smem + 1024) <= block_attention.SM_SMEM
    else:
        assert plan["group"] == 1
        assert plan["partial"] == b * h * t * t


@pytest.mark.fast
@pytest.mark.parametrize("b,t,group,groups", [(1, 249, 4, 1), (2, 249, 4, 1),
                                              (5, 249, 4, 2),
                                              (36, 249, 9, 4),
                                              (36, 65, 5, 8),
                                              (36, 63, 4, 9)])
def test_dbias_groups_at_the_training_shapes(b, t, group, groups):
    """BYOL's batch of 36 at 249 frames: groups of 9 batches, 4 partial
    slices, 256 dq blocks (one wave of two an SM)."""
    plan = block_attention.attention_bwd_plan(b, 16, t, H100_SMS)
    assert (plan["group"], plan["groups"]) == (group, groups)


@pytest.mark.fast
def test_grouped_dbias_is_fixed_order_group_sums():
    """The plain path's dbias order: the gate·ds of each group of batches
    summed in batch order, then the groups in order — bit for bit the loop
    written out, and within float32 rounding of the float64 sum."""
    rng = np.random.default_rng(7)
    b, t = 5, 9
    gate = torch.from_numpy(rng.uniform(0.5, 2.5, (b, H, t))
                            .astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal((b, H, t, t))
                          .astype(np.float32))
    got = grouped_dbias(gate, ds, 4)
    c = gate[..., None] * ds
    want = (((c[0] + c[1]) + c[2]) + c[3]) + c[4]
    assert torch.equal(got, want)
    assert torch.equal(grouped_dbias(gate, ds, 2),
                       ((c[0] + c[1]) + (c[2] + c[3])) + c[4])
    exact = (gate.double()[..., None] * ds.double()).sum(0)
    assert float((got.double() - exact).abs().max()) <= 1e-5 * float(
        exact.abs().max())


def test_plain_backward_matches_autograd_of_plain_forward():
    """The TPU-arithmetic backward (p recomputed from lse) against torch
    autograd through the plain forward, with dropout and a key mask."""
    (q, k, v, gate, bias), mask, keep, cot = make_inputs(96, seed=3)
    tq, tk, tv, tg, tb = (torch.from_numpy(a).requires_grad_()
                          for a in (q, k, v, gate, bias))
    tmask, tkeep, tcot = (torch.from_numpy(a) for a in (mask, keep, cot))
    out, lse = gated_bias_attention_lse(tq, tk, tv, tg, tb, tmask, tkeep)
    out.backward(tcot)
    with torch.no_grad():
        got = gated_bias_attention_bwd(
            tq, tk, tv, tg, tb, mask_add(tmask, B, 96, "cpu"), out, lse,
            tcot, tkeep)
    for name, g, x in zip(NAMES[1:], got, (tq, tk, tv, tg, tb)):
        assert _rel(g.numpy(), x.grad.numpy()) <= ROUTE_TOL, name


def test_seeded_mask_is_k1_mask_at_the_attention_site():
    """The seeded forward drops exactly what K1 drops from the merged
    ``[B, T, C]`` output under the same seed (site 0), bit for bit, and its
    backward regenerates that mask."""
    t = 37
    (q, k, v, gate, bias), mask, _, cot = make_inputs(t, seed=5)
    pair = TrainRNG(11, 3, 0).dropout_seed(2, SITE_ATTN)
    seed = philox.seed_tensor(pair)
    dump = fused_dropout.dump_dropout_mask(seed, (B, t, H * D), P_DROP)
    keep = attention_keep_mask(pair, (B, H, t, D), P_DROP)
    assert torch.equal(keep, dump.view(B, t, H, D).permute(0, 2, 1, 3))

    arrays = (q, k, v, gate, bias)
    seeded, tensors = _port_run(arrays, mask, p_drop=P_DROP,
                                dropout_seed=seed)
    plain = block_attention.block_gated_attention(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(mask))
    merged = plain.transpose(1, 2).reshape(B, t, H * D)
    k1 = fused_dropout.hw_dropout(merged, seed, P_DROP)
    assert torch.equal(seeded.detach(),
                       k1.view(B, t, H, D).transpose(1, 2))

    seeded.backward(torch.from_numpy(cot))
    masked = _port_block(arrays, mask, keep.numpy(), cot)
    for name, x, want in zip(NAMES[1:], tensors, masked[1:]):
        assert np.array_equal(x.grad.numpy(), want), name


def test_lse_is_not_differentiable_and_long_sequences_raise():
    (q, k, v, gate, bias), mask, _, _ = make_inputs(40, seed=6)
    tensors = [torch.from_numpy(a).requires_grad_() for a in
               (q, k, v, gate, bias)]
    out, lse = block_attention.block_gated_attention_lse(
        *tensors, torch.from_numpy(mask), p_drop=0.1,
        dropout_seed=philox.seed_tensor((1, 2)))
    assert out.requires_grad and not lse.requires_grad
    with pytest.raises(ValueError, match="dropout_seed"):
        block_attention.block_gated_attention(*tensors, p_drop=0.1)
    with pytest.raises(ValueError, match="flash"):
        long = block_attention.MAX_T + 1
        block_attention.block_gated_attention(
            *(torch.zeros(s) for s in ((1, 1, long, D),) * 3),
            torch.zeros(1, 1, long), torch.zeros(1, long, long))


# --- the train step: the kernel route against the separate-dropout route --

def _separate_dropout_attention(q, k, v, gate, pos_bias,
                                key_padding_mask=None, *, p_drop=0.0,
                                dropout_seed=None, dropout_window=None):
    """The separate-dropout route: plain float32 attention under autograd,
    then K1 over the merged output at the attention-output site (over its
    window, for a shard of the heads)."""
    out = gated_bias_attention(q, k, v, gate, pos_bias, key_padding_mask)
    if p_drop == 0.0:
        return out
    b, h, t, d = out.shape
    merged = out.transpose(1, 2).reshape(b, t, h * d)
    merged = fused_dropout.hw_dropout(merged, dropout_seed, p_drop,
                                      window=dropout_window)
    return merged.view(b, t, h, d).transpose(1, 2)


def _train_step():
    """One tiny BYOL step with every random feature on (attention dropout
    0.1, hidden/FFN dropout, LayerDrop, SpecAugment): ``(loss, grads)``."""
    cfg = WavLMConfig.tiny()
    sd = with_random_biases(init_byol_state_dict(
        cfg, 16, 32, torch.Generator().manual_seed(0)), 0)
    state = create_train_state(cfg, sd, 16, 32, "cpu", seed=9)
    rng = np.random.default_rng(4)
    t = 3200
    ax = np.arange(t) / 16000.0
    clean = np.stack([np.sin(2 * np.pi * f * ax) for f in (150, 420, 900)]
                     + [rng.standard_normal(t)])
    batch = {"clean": torch.from_numpy(clean.astype(np.float32)),
             "noise": torch.from_numpy(
                 (0.2 * rng.standard_normal((4, t))).astype(np.float32)),
             "snr": torch.tensor([2.0, 5.0, 10.0, 20.0])}
    m = make_byol_train_step(FusedAdamWSpec(schedule=1e-4))(state, batch)
    return float(m["loss"]), state.grads.clone()


def test_train_step_matches_the_separate_dropout_route(monkeypatch):
    loss, grads = _train_step()
    monkeypatch.setattr(wavlm, "block_gated_attention",
                        _separate_dropout_attention)
    ref_loss, ref_grads = _train_step()
    assert abs(loss - ref_loss) <= ROUTE_TOL * abs(ref_loss)
    err = float((grads - ref_grads).abs().max() / ref_grads.abs().max())
    assert err <= ROUTE_TOL, err
