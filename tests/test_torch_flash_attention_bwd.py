"""K5's backward: the port's ``flash_gated_attention`` under autograd on the
CPU (the plain backward, ``flash_attention_plain_bwd``) against ``jax.grad``
of the JAX package's Pallas flash kernel in interpret mode, its resident
kernels and its streamed variants.

Same inputs, made from a seed with numpy, go to both sides; float32
throughout; a fixed cotangent ``w``.  All five gradients (q, k, v, the gate
and the generator ``bias_rel``) are held to 1e-4 of max|ref|: the two sides
differ in the order of float32 sums (the JAX kernel sums its dbias
windows over the batch, then folds them; the port folds the batch-summed
dense ``dbias``).  Both pad T to a multiple of 128 with masked keys, so a
row whose keys are all padded agrees too.  T = 100 and 499 take the JAX
kernels' single-block branch (t_pad ≤ 512), T = 640 their multi-block one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nrse_tpu.ops.flash_attention as jax_fa
from nrse_tpu_torch.ops import flash_attention

torch.set_num_threads(1)

B, H, D = 2, 2, 16
TOL = 1e-4
NAMES = ("dq", "dk", "dv", "dgate", "dbias_rel")


def make_inputs(t, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, t, D)).astype(np.float32)
               for _ in range(3))
    gate = rng.uniform(0.5, 2.5, (B, H, t)).astype(np.float32)
    bias_rel = rng.standard_normal((H, 2 * t)).astype(np.float32)
    w = rng.standard_normal((B, H, t, D)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, t), np.int32)
        mask[1, t // 2:] = 0
    return (q, k, v, gate, bias_rel), mask, w


def port_grads(arrays, mask, w):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    before = (flash_attention.LAUNCHES, flash_attention.DQ_LAUNCHES,
              flash_attention.DKV_LAUNCHES)
    out = flash_attention.flash_gated_attention(*leaves, m)
    (out * torch.from_numpy(w)).sum().backward()
    # CPU tensors: the plain versions, no kernel
    assert (flash_attention.LAUNCHES, flash_attention.DQ_LAUNCHES,
            flash_attention.DKV_LAUNCHES) == before
    return [x.grad.numpy() for x in leaves]


def jax_grads(arrays, mask, w, flash=jax_fa.flash_gated_attention):
    m = None if mask is None else jnp.asarray(mask)
    jw = jnp.asarray(w)

    def loss(q, k, v, gate, bias_rel):
        return jnp.sum(flash(q, k, v, gate, bias_rel, m) * jw)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrays))
    return [np.asarray(g) for g in grads]


def assert_close(ours, ref):
    for name, a, r in zip(NAMES, ours, ref):
        assert a.shape == r.shape, name
        err = np.abs(a - r).max() / np.abs(r).max()
        assert err < TOL, f"{name}: max|Δ|/max|ref| {err}"


@pytest.mark.parametrize("t,masked", [(100, False), (100, True),
                                      (499, False), (499, True),
                                      (640, False), (640, True)])
def test_gradients_match_jax_flash(t, masked):
    arrays, mask, w = make_inputs(t, seed=t, masked=masked)
    assert_close(port_grads(arrays, mask, w), jax_grads(arrays, mask, w))


def test_gradients_match_jax_streamed_kernels(monkeypatch):
    """JAX's streamed variants (``_bwd_dq_streamed_kernel``,
    ``_bwd_dkv_streamed_kernel``), forced at T = 640 by a small threshold:
    the port's one backward serves both regimes."""
    monkeypatch.setattr(jax_fa, "STREAM_THRESHOLD", 256)
    arrays, mask, w = make_inputs(640, seed=9, masked=True)
    assert_close(port_grads(arrays, mask, w), jax_grads(arrays, mask, w))


def test_fully_masked_row_gradient_as_recorded():
    """A batch row whose keys are all padded: its saved ``lse`` rounds to
    −1e9 in float32, so the backward recomputes ``p = 1`` for each of its
    t_pad keys, as JAX's kernel does on its padded keys.  Its dv is then the
    sum of ``do`` over the row's queries at every key; all five gradients
    are held to JAX's, the masked row's against its own scale too."""
    t = 499
    arrays, mask, w = make_inputs(t, seed=12, masked=True)
    mask[1, :] = 0
    ours = port_grads(arrays, mask, w)
    ref = jax_grads(arrays, mask, w)
    assert all(np.isfinite(g).all() for g in ours)
    dv = ours[2][1]
    np.testing.assert_allclose(
        dv, np.broadcast_to(w[1].sum(axis=1, keepdims=True), dv.shape),
        rtol=0, atol=TOL * np.abs(dv).max())
    assert_close(ours, ref)
    for name, a, r in zip(NAMES[:4], ours[:4], ref[:4]):
        for row in (0, 1):
            err = np.abs(a[row] - r[row]).max() / np.abs(r[row]).max()
            assert err < TOL, f"{name} of batch row {row}: {err}"


@pytest.mark.parametrize("t", [512, 513, 449])
def test_masked_row_padding_gradients_match_jax(t):
    """The keys' padding at T ≡ 0, 1 and 65 (mod 128), a wholly masked
    row beside a ragged one: all five gradients held to ``jax.grad`` of
    JAX's flash kernel, the masked row's against its own scale too (its
    padded keys' ``ds = −delta`` enter dgate and fold onto the generator's
    clamped index)."""
    arrays, mask, w = make_inputs(t, seed=t + 2, masked=True)
    mask[0, :] = 0
    ours = port_grads(arrays, mask, w)
    ref = jax_grads(arrays, mask, w)
    assert_close(ours, ref)
    for name, a, r in zip(NAMES[:4], ours[:4], ref[:4]):
        err = np.abs(a[0] - r[0]).max() / np.abs(r[0]).max()
        assert err < TOL, f"{name} of the masked row: {err}"


def test_function_matches_direct_plain_calls():
    """The autograd Function's CPU backward is the plain backward on the
    forward's saved ``out`` and ``lse``, the generator's gradient the dense
    ``dbias`` folded onto its diagonals."""
    arrays, mask, w = make_inputs(70, seed=3, masked=True)
    q, k, v, gate, bias_rel = (torch.from_numpy(a) for a in arrays)
    m = torch.from_numpy(mask)
    madd = flash_attention.mask_add(m, B, 70, q.device)
    out, lse = flash_attention.flash_attention_plain_fwd(q, k, v, gate,
                                                         bias_rel, madd)
    direct = flash_attention.flash_attention_plain_bwd(
        q, k, v, gate, bias_rel, madd, out, lse, torch.from_numpy(w))
    for a, d in zip(port_grads(arrays, mask, w), direct):
        assert np.array_equal(a, d.numpy())
    # the fold is the adjoint of the dense expansion
    dense = torch.randn(H, 70, 70, generator=torch.Generator().manual_seed(0))
    g = torch.randn(H, 140, generator=torch.Generator().manual_seed(1))
    lhs = (flash_attention.dense_bias_from_rel(g, 70) * dense).sum()
    rhs = (g * flash_attention.fold_dense_bias(dense, 70)).sum()
    assert abs(float(lhs - rhs)) < 1e-3
