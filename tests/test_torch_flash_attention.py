"""K5's plain version (``flash_gated_attention`` on CPU tensors) against the
JAX Pallas flash kernel (interpret mode), and the Toeplitz bias helpers
against the JAX package's.

Same inputs, made from a seed with numpy, go to both sides; float32
throughout.  Valid rows are held to 3e-5 absolute, the bound
``tests/test_flash_attention.py`` holds the Pallas kernel to against the
XLA path (the sides differ only in the order of float32 sums).  T = 100
and 499 take the JAX kernel's single-block branch (t_pad ≤ 512), T = 640
its multi-block online softmax.
"""

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
    dense expansion of the generator, lse included."""
    (q, k, v, gate, bias_rel), mask = make_inputs(90, seed=4, masked=True)
    tq, tk, tv, tg, tb = (torch.from_numpy(a)
                          for a in (q, k, v, gate, bias_rel))
    m = torch.from_numpy(mask)
    dense = rel_pos_bias.dense_bias_from_rel(tb, 90)
    out, lse = flash_attention.flash_gated_attention_lse(tq, tk, tv, tg, tb,
                                                         m)
    assert torch.equal(out, gated_bias_attention(tq, tk, tv, tg, dense, m))
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
    bucket's last batch): the uniform mean of v over the T keys in the
    port; the JAX kernel pads T to t_pad with zero keys and values, so its
    row is that mean scaled by T / t_pad (ROADMAP Queue 3).  The other
    batch row is held to JAX as usual."""
    t, t_pad = 499, 512
    arrays, mask = make_inputs(t, seed=11, masked=True)
    mask[1, :] = 0
    ours = _port(arrays, mask)
    ref = _jax(arrays, mask)
    assert np.isfinite(ours).all()
    v = arrays[2]
    mean_v = v[1].mean(axis=1, keepdims=True)  # [H, 1, D]
    assert np.abs(ours[1] - mean_v).max() < TOL
    assert np.abs(ours[1] * (t / t_pad) - ref[1]).max() < TOL
    assert np.abs(ours[0] - ref[0]).max() < TOL


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
