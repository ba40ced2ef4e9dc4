"""K1's wrapper (plain path on the CPU) against the JAX Pallas kernel.

``hw_dropout_masked``, forward and VJP, against JAX's
``hw_dropout_masked`` (interpret mode) fed the same mask: both compute
``float32(x) · mask`` rounded to x's dtype, so the results must be equal
exactly, in float32 and in bf16.  The seeded ``hw_dropout``'s autograd
gradient must be ``dy · dump_dropout_mask(seed, …)`` exactly: its backward
regenerates the mask from the seed instead of saving it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops.fused_dropout import hw_dropout_masked as jax_masked
from nrse_tpu_torch.ops import fused_dropout as port

torch.set_num_threads(1)

P = 0.1
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    keep = rng.random(shape) >= P
    mask = keep.astype(np.float32) / np.float32(1.0 - P)
    return x, dy, mask


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_masked_matches_jax(dtype):
    _, jdt, tdt = DTYPES[dtype]
    x, dy, mask = _inputs((3, 50, 128))
    jx = jnp.asarray(x).astype(jdt)
    ref, vjp = jax.vjp(jax_masked, jx, jnp.asarray(mask))
    ref_dx = vjp(jnp.asarray(dy).astype(jdt))[0]

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    out = port.hw_dropout_masked(tx, torch.from_numpy(mask))
    out.backward(torch.from_numpy(dy).to(tdt))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(ref_dx.astype(jnp.float32)))


def test_seeded_grad_is_dy_times_dumped_mask():
    x, dy, _ = _inputs((2, 37, 96), seed=1)
    seed = (0xDEAD, 0xBEEF)
    tx = torch.from_numpy(x).requires_grad_()
    out = port.hw_dropout(tx, seed, P)
    out.backward(torch.from_numpy(dy))
    mask = port.dump_dropout_mask(seed, x.shape, P)
    assert torch.equal(out.detach(), torch.from_numpy(x) * mask)
    assert torch.equal(tx.grad, torch.from_numpy(dy) * mask)
    kept = float((mask > 0).float().mean())
    assert 0.85 < kept < 0.95


def test_zero_p_is_identity_and_cpu_launches_nothing():
    x = torch.randn(4, 8)
    before = (port.LAUNCHES, port.DUMP_LAUNCHES)
    assert port.hw_dropout(x, (1, 2), 0.0) is x
    port.hw_dropout(x, (1, 2), 0.5)
    port.dump_dropout_mask((1, 2), (4, 8), 0.5)
    assert (port.LAUNCHES, port.DUMP_LAUNCHES) == before
    with pytest.raises(ValueError):
        port.hw_dropout(x, (1, 2), 1.0)
