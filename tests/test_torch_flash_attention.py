"""K5's plain version (``flash_gated_attention`` on CPU tensors) against the
JAX Pallas flash kernel (interpret mode), and the Toeplitz bias helpers
against the JAX package's.

Same inputs, made from a seed with numpy, go to both sides; float32
throughout.  Outputs are held to 3e-5 absolute, the bound
``tests/test_flash_attention.py`` holds the Pallas kernel to against the
XLA path (the sides differ only in the order of float32 sums).  T = 100
and 499 take the JAX kernel's single-block branch (t_pad ≤ 512), T = 640
its multi-block online softmax.  Both sides pad the keys to a multiple of
128, so a row whose keys are all padded agrees too.  The CUDA kernels'
launch plan and tensor-map geometry (``k5_plan``, ``map_geometry``),
which the C entries check and build their maps from, and the backward's
delta contract (``bwd_delta``) are checked here as well.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops.flash_attention import (
    flash_gated_attention as jax_flash_attention,
)
from nrse_tpu.ops.rel_pos_bias import (
    bucket_of_relative_position as jax_bucket_of_relative_position,
)
from nrse_tpu.ops.rel_pos_bias import dense_bias_from_rel as jax_dense_bias
from nrse_tpu.ops.rel_pos_bias import rel_bias_vector as jax_rel_bias_vector
from nrse_tpu_torch.ops import flash_attention, rel_pos_bias
from nrse_tpu_torch.ops.attention import gated_bias_attention

torch.set_num_threads(1)

B, H, D = 2, 3, 16
TOL = 3e-5


def make_inputs(t, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, t, D)).astype(np.float32)
               for _ in range(3))
    gate = rng.uniform(0.5, 2.5, (B, H, t)).astype(np.float32)
    bias_rel = rng.standard_normal((H, 2 * t)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, t), np.int32)
        mask[1, t // 2:] = 0
    return (q, k, v, gate, bias_rel), mask


def _port(arrays, mask):
    tensors = [torch.from_numpy(a) for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    return flash_attention.flash_gated_attention(*tensors, m).numpy()


def _jax(arrays, mask):
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in arrays),
                                          m))


@pytest.mark.parametrize("t,masked", [(100, False), (100, True),
                                      (499, False), (499, True),
                                      (640, False), (640, True)])
def test_plain_matches_jax_flash(t, masked):
    arrays, mask = make_inputs(t, seed=t, masked=masked)
    before = flash_attention.LAUNCHES
    ours = _port(arrays, mask)
    assert flash_attention.LAUNCHES == before  # CPU tensors: plain path
    err = np.abs(ours - _jax(arrays, mask)).max()
    assert err < TOL, f"max abs err {err}"


def test_plain_is_dense_gated_attention():
    """The plain version is the block attention's plain forward on the
    keys padded as JAX pads them (zero keys and values, masked, the
    generator read at its clamped index), lse included."""
    (q, k, v, gate, bias_rel), mask = make_inputs(90, seed=4, masked=True)
    tq, tk, tv, tg, tb = (torch.from_numpy(a)
                          for a in (q, k, v, gate, bias_rel))
    m = torch.from_numpy(mask)
    dense = rel_pos_bias.dense_bias_from_rel(tb, 90)
    out, lse = flash_attention.flash_gated_attention_lse(tq, tk, tv, tg, tb,
                                                         m)
    pad = 128 - 90
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (tk, tv))
    rel = np.minimum(89 + np.arange(128)[None, :] - np.arange(90)[:, None],
                     179)
    assert torch.equal(dense, tb[:, rel[:, :90]])
    padded = gated_bias_attention(tq, kp, vp, tg, tb[:, rel],
                                  torch.nn.functional.pad(m, (0, pad)))
    assert torch.equal(out, padded)
    s = (tq.double() @ tk.double().transpose(-1, -2) / D ** 0.5
         + tg.double()[..., None] * dense.double()[None])
    s = s.masked_fill(m[:, None, None, :] == 0, -1e9)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, 90)
    assert float((lse.double() - torch.logsumexp(s, -1)).abs().max()) < 1e-4


@pytest.mark.parametrize("t,buckets,distance", [(499, 320, 800),
                                                (640, 40, 100),
                                                (1499, 320, 800)])
def test_rel_bias_vector_and_dense_match_jax(t, buckets, distance):
    rng = np.random.default_rng(t)
    table = rng.standard_normal((buckets, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        rel_pos_bias.bucket_of_relative_position(t, buckets, distance),
        jax_bucket_of_relative_position(t, buckets, distance))
    ours = rel_pos_bias.rel_bias_vector(torch.from_numpy(table), t, buckets,
                                        distance)
    ref = jax_rel_bias_vector(jnp.asarray(table), t, buckets, distance)
    assert ours.shape == (4, 2 * t)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    dense = rel_pos_bias.dense_bias_from_rel(ours, t)
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jax_dense_bias(ref, t)))
    # the dense form is the gather of the [H, T, T] bias itself
    np.testing.assert_array_equal(
        dense.numpy(), rel_pos_bias.compute_position_bias(
            torch.from_numpy(table), t, t, buckets, distance).numpy())


def test_fully_masked_row_finite_and_as_recorded():
    """A batch row whose keys are all padded (every row that pads a
    bucket's last batch): both sides pad T to t_pad with zero keys and
    values, so the row is the mean of v over the T keys scaled by
    T / t_pad, held to JAX like the other row."""
    t, t_pad = 499, 512
    arrays, mask = make_inputs(t, seed=11, masked=True)
    mask[1, :] = 0
    ours = _port(arrays, mask)
    ref = _jax(arrays, mask)
    assert np.isfinite(ours).all()
    v = arrays[2]
    mean_v = v[1].mean(axis=1, keepdims=True)  # [H, 1, D]
    assert np.abs(ours[1] - mean_v * (t / t_pad)).max() < TOL
    assert np.abs(ours[1] - ref[1]).max() < TOL
    assert np.abs(ours[0] - ref[0]).max() < TOL


@pytest.mark.parametrize("t", [512, 513, 449])
def test_masked_row_padding_matches_jax(t):
    """The keys' padding at T ≡ 0, 1 and 65 (mod 128): none at 512, 127
    keys at 513 (JAX's multi-block branch), 63 at 449; a wholly masked row
    and a ragged one held to JAX's flash kernel."""
    arrays, mask = make_inputs(t, seed=t + 1, masked=True)
    mask[0, :] = 0
    ours = _port(arrays, mask)
    ref = _jax(arrays, mask)
    t_pad = 128 * -(-t // 128)
    mean_v = arrays[2][0].mean(axis=1, keepdims=True)
    assert np.abs(ours[0] - mean_v * (t / t_pad)).max() < TOL
    assert np.abs(ours - ref).max() < TOL


def test_raises_under_autograd_and_on_bad_shapes():
    """Under autograd a gradient flows, the plain backward's (the raw
    entries' raise is for the CUDA kernels alone); bad shapes raise."""
    (q, k, v, gate, bias_rel), _ = make_inputs(40, seed=2)
    tensors = [torch.from_numpy(a) for a in (q, k, v, gate, bias_rel)]
    leaf = tensors[0].clone().requires_grad_()
    out = flash_attention.flash_gated_attention(leaf, *tensors[1:])
    do = torch.ones_like(out)
    out.backward(do)
    madd = torch.zeros(B, 40)
    ref_out, lse = flash_attention.flash_attention_plain_fwd(*tensors, madd)
    dq = flash_attention.flash_attention_plain_bwd(*tensors, madd, ref_out,
                                                   lse, do)[0]
    assert torch.equal(leaf.grad, dq) and float(dq.abs().max()) > 0
    with torch.no_grad():  # no gradient asked for: it runs
        flash_attention.flash_gated_attention(leaf, *tensors[1:])
    with pytest.raises(ValueError, match="bias_rel"):
        flash_attention.flash_gated_attention(*tensors[:4],
                                              tensors[4][:, :-1])
    with pytest.raises(ValueError, match="key_padding_mask"):
        flash_attention.flash_gated_attention(*tensors,
                                              torch.ones(B, 39))


SMS = 132  # an H100 SXM's SMs; the plan takes the count as an argument


@pytest.mark.parametrize("b,t", [(32, 385), (32, 499), (1, 3199),
                                 (1, 65536)])
def test_launch_plan_fits_the_card(b, t):
    """K5's launch plan: keys padded to a multiple of 128, the tiles of
    the padded queries (the forward, the dq kernel) or of the keys below T
    (the dk/dv kernel), each kernel's shared memory within the 227 KB a
    block may have, the dq kernel's scratch, the persistent grids at most
    one block an SM."""
    h = 16
    plan = flash_attention.k5_plan(b, h, t, SMS)
    t_pad = plan["t_pad"]
    assert t_pad % 128 == 0 and 0 <= t_pad - t < 128
    for name in ("fwd", "dq", "dkv"):
        assert plan[name]["smem"] <= flash_attention.SMEM_LIMIT, name
    fwd = plan["fwd"]
    assert fwd["tiles"] == b * h * t_pad // 128
    assert fwd["grid"] == min(fwd["tiles"], SMS)
    assert min(plan[k]["stages"] for k in ("fwd", "dq", "dkv")) >= 2
    assert plan["dq"]["tiles"] == fwd["tiles"]
    assert plan["dq"]["grid"] == min(fwd["tiles"], SMS)
    # the dk/dv kernel's tiles: 128 keys below T of each (b, h)
    per_bh = plan["dkv"]["tiles"] // (b * h)
    assert plan["dkv"]["tiles"] % (b * h) == 0
    assert (per_bh - 1) * 128 < t <= per_bh * 128
    assert plan["dkv"]["grid"] == min(plan["dkv"]["tiles"], SMS)
    # one window of t_pad + 63 diagonal sums a (b, h, 64 queries)
    assert plan["partial"] == b * h * (t_pad // 64) * (t_pad + 63)
    # the SM count is the caller's: a smaller card gets smaller grids
    small = flash_attention.k5_plan(b, h, t, 7)
    assert all(small[k]["grid"] == min(plan[k]["tiles"], 7)
               for k in ("fwd", "dq", "dkv"))


def test_kernels_take_the_plans_shared_memory():
    """The C entries refuse any other shared-memory size than their own
    (static_assert'ed in the sources); those sizes are the plan's."""
    csrc = Path(flash_attention.__file__).resolve().parent.parent / "csrc"
    want = {"flash_attention_fwd.cu": [flash_attention.FWD_SMEM],
            "flash_attention_bwd.cu": [flash_attention.DQ_SMEM,
                                       flash_attention.DKV_SMEM]}
    for name, sizes in want.items():
        found = [int(x) for x in re.findall(
            r"static_assert\(k\w*Smem\w* == (\d+)",
            (csrc / name).read_text())]
        assert found == sizes, name


@pytest.mark.parametrize("maps", ["FWD_MAPS", "DQ_MAPS", "DKV_MAPS"])
def test_tma_maps_read_one_head(maps):
    """Each map's words describe the contiguous ``[B, H, T, 64]`` tensor as
    (channel, row, head): read through them, the tensor's elements land
    where a ``[B·H, T, 64]`` view has them, and a box spans one head (its
    head extent is 1) and the rows the kernels' byte counts assume."""
    b, h, t = 3, 2, 449
    names = getattr(flash_attention, maps)
    words = flash_attention.map_geometry(b, h, t, names)
    assert len(words) == flash_attention.MAP_WORDS * len(names)
    x = np.arange(b * h * t * 64, dtype=np.int64)
    for i, (_, rows) in enumerate(names):
        w = words[9 * i:9 * i + 9]
        dims, strides, box = w[0:3], w[3:6], w[6:9]
        assert dims == [64, t, b * h] and box == [64, rows, 1]
        view = np.lib.stride_tricks.as_strided(
            x, shape=dims[::-1],
            strides=[8 * st for st in strides[::-1]])
        np.testing.assert_array_equal(view, x.reshape(b * h, t, 64))
        assert rows in (64, 128) and rows < t


def test_delta_contract_is_the_rowsum():
    """The backward's delta pre-pass contract (8 columns a thread summed in
    order, then a fixed tree) against ``rowsum(do ⊙ out)`` in float64, and
    on bf16 values (exact products) bit for bit against the same order
    written out in numpy float32."""
    rng = np.random.default_rng(5)
    do, out = (rng.standard_normal((2, 3, 37, 64)).astype(np.float32)
               for _ in range(2))
    got = flash_attention.bwd_delta(torch.from_numpy(do),
                                    torch.from_numpy(out)).numpy()
    ref = (do.astype(np.float64) * out).sum(-1)
    assert got.shape == (2, 3, 37)
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()
    tb, ob = (torch.from_numpy(a).to(torch.bfloat16) for a in (do, out))
    got = flash_attention.bwd_delta(tb, ob).numpy()
    prod = (tb.float() * ob.float()).numpy().reshape(2, 3, 37, 8, 8)
    lanes = np.zeros(prod.shape[:-1], np.float32)
    for c in range(8):
        lanes = (lanes + prod[..., c]).astype(np.float32)
    for step in (1, 2, 4):
        lanes = (lanes + lanes[..., np.arange(8) ^ step]).astype(np.float32)
    np.testing.assert_array_equal(got, lanes[..., 0])
