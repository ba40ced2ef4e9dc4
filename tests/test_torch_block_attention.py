"""Port's ``block_gated_attention`` (plain path on the CPU) against the JAX
Pallas kernel (interpret mode) and the JAX XLA attention.

Same inputs, made from a seed with numpy, go to both sides; float32
throughout.  Tolerance 2e-5 absolute, as ``tests/test_block_attention.py``
holds the Pallas kernel to the XLA path: the three differ only in the order
of float32 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops.attention import gated_bias_attention as jax_xla_attention
from nrse_tpu.ops.block_attention import (
    block_gated_attention as jax_block_attention,
)
from nrse_tpu_torch.ops import block_attention
from nrse_tpu_torch.ops.attention import gated_bias_attention

torch.set_num_threads(1)

B, H, D = 2, 3, 16
TOL = 2e-5


def make_inputs(t, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, t, D)).astype(np.float32)
               for _ in range(3))
    gate = rng.uniform(0.5, 2.5, (B, H, t)).astype(np.float32)
    bias = rng.standard_normal((H, t, t)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, t), np.int32)
        mask[1, t // 2:] = 0
    return (q, k, v, gate, bias), mask


def _port(arrays, mask):
    tensors = [torch.from_numpy(a) for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    return block_attention.block_gated_attention(*tensors, m).numpy()


def _jax(fn, arrays, mask):
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), m))


@pytest.mark.parametrize("t,masked", [(64, False), (100, True), (249, False),
                                      (249, True), (256, True)])
def test_matches_jax_block_and_xla(t, masked):
    arrays, mask = make_inputs(t, masked=masked)
    ours = _port(arrays, mask)
    for fn in (jax_block_attention, jax_xla_attention):
        err = np.abs(ours - _jax(fn, arrays, mask)).max()
        assert err < TOL, f"{fn.__module__}: max abs err {err}"


def test_fully_masked_row_finite_and_matches():
    arrays, mask = make_inputs(64, seed=3, masked=True)
    mask[1, :] = 0  # one sample whose keys are all padded
    ours = _port(arrays, mask)
    assert np.isfinite(ours).all()
    # A fully masked row is the uniform mean of v.  The JAX Pallas kernel
    # pads T to 128 with zero keys and values, which halves that mean
    # here, so the row is held to the XLA path; the other row to both.
    err = np.abs(ours - _jax(jax_xla_attention, arrays, mask)).max()
    assert err < TOL, f"max abs err {err}"
    err = np.abs(ours[0] - _jax(jax_block_attention, arrays, mask)[0]).max()
    assert err < TOL, f"max abs err {err}"


def test_lse_matches_logsumexp():
    (q, k, v, gate, bias), mask = make_inputs(100, seed=5, masked=True)
    tq, tk, tv, tg, tb = (torch.from_numpy(a).double()
                          for a in (q, k, v, gate, bias))
    _, lse = block_attention.block_gated_attention_lse(
        *(torch.from_numpy(a) for a in (q, k, v, gate, bias)),
        torch.from_numpy(mask))
    s = tq @ tk.transpose(-1, -2) / D ** 0.5 + tg[..., None] * tb[None]
    s = s.masked_fill(torch.from_numpy(mask)[:, None, None, :] == 0, -1e9)
    ref = torch.logsumexp(s, dim=-1)
    assert lse.dtype == torch.float32
    assert float((lse.double() - ref).abs().max()) < 1e-4


def test_plain_attention_is_block_plain_path():
    arrays, mask = make_inputs(96, seed=7, masked=True)
    tensors = [torch.from_numpy(a) for a in arrays]
    m = torch.from_numpy(mask)
    assert torch.equal(gated_bias_attention(*tensors, m),
                       block_attention.block_gated_attention(*tensors, m))


def test_rejects_long_sequences_and_bad_shapes():
    arrays, _ = make_inputs(block_attention.MAX_T + 1, seed=2)
    tensors = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="flash"):
        block_attention.block_gated_attention(*tensors)
    q, k, v, gate, bias = [torch.from_numpy(a)
                           for a in make_inputs(32, seed=2)[0]]
    with pytest.raises(ValueError, match="pos_bias"):
        block_attention.block_gated_attention(q, k, v, gate, bias[:, :-1])


def test_attention_fwd_plan_fits_every_t():
    """Kernel A's launch plan for every T it takes: the query tiles cover
    T, a block fits the H100's 232,448 bytes of shared memory and the
    blocks its launch bounds ask for fit an SM's 228 KB, the one-pass
    wgmma route takes T_pad ≤ 256 (two blocks an SM), the two-pass route
    the rest."""
    for t in range(1, block_attention.MAX_T + 1):
        plan = block_attention.attention_fwd_plan(t)
        assert plan["t_pad"] % 64 == 0 and 0 <= plan["t_pad"] - t < 64
        assert plan["query_tiles"] * 64 == plan["t_pad"]
        assert plan["smem"] <= 232448
        assert plan["blocks_per_sm"] * (plan["smem"] + 1024) \
            <= block_attention.SM_SMEM
        if plan["t_pad"] <= 256:
            assert plan["route"] == "wgmma" and plan["blocks_per_sm"] == 2
        else:
            assert plan["route"] == "two_pass"


@pytest.mark.parametrize("t,route", [(1, "wgmma"), (249, "wgmma"),
                                     (256, "wgmma"), (257, "two_pass"),
                                     (384, "two_pass")])
def test_attention_fwd_plan_route_switch(t, route):
    assert block_attention.attention_fwd_plan(t)["route"] == route
