"""K6's plain versions against the JAX package's ``fused_conv_ln_gelu``.

The same numpy inputs go through ``nrse_tpu.ops.fused_frontend`` (its
Pallas kernels in interpret mode on the CPU, as its own tests run them) and
the port's ``fused_conv_ln_gelu`` on CPU tensors (the plain versions).
Tolerances are JAX's own (``tests/test_fused_frontend.py``): the forward
within 1e-5 absolute in float32, the five gradients within 2e-5 of the
reference's max|·|; bf16 within 1e-2 of max|ref| (one bf16 rounding of
each output, in other places on the two sides).  C = 128 keeps the cases
quick; the kernel's arithmetic does not depend on C.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops import fused_frontend as jax_ff
from nrse_tpu_torch.ops import fused_frontend

torch.set_num_threads(1)

C = 128
CASES = [(3, 1031), (3, 1030), (2, 1030), (2, 1031), (3, 513), (3, 2051),
         (2, 3), (3, 3), (2, 4), (3, 4), (2, 5), (3, 5)]


def make(k, t_in, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t_in, C)).astype(np.float32),
            (rng.standard_normal((k, C, C)) * 0.05).astype(np.float32),
            (rng.standard_normal(C) * 0.1).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
            (0.1 * rng.standard_normal(C)).astype(np.float32))


def _torch(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("k,t_in", CASES)
def test_forward_matches_jax(k, t_in):
    arrays = make(k, t_in)
    ref = np.asarray(jax_ff.fused_conv_ln_gelu(*map(jnp.asarray, arrays)))
    with torch.no_grad():
        out = fused_frontend.fused_conv_ln_gelu(*_torch(arrays))
    assert out.shape == ref.shape == (2, fused_frontend.out_length(t_in, k),
                                      C)
    assert np.abs(out.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("k,t_in", [(3, 1031), (2, 1030), (2, 1031),
                                    (3, 4), (2, 5)])
def test_residuals_match_jax(k, t_in):
    """The plain forward's (x̂, rstd) are the TPU forward kernel's."""
    arrays = make(k, t_in, seed=3)
    _, res = jax_ff._fwd(*map(jnp.asarray, arrays), 1e-5)
    t_out = fused_frontend.out_length(t_in, k)
    ref_xhat = np.asarray(res[2])[:, :t_out]
    ref_rstd = np.asarray(res[3])[:, :t_out]
    _, xhat, rstd = fused_frontend.conv_ln_gelu_plain_fwd(*_torch(arrays),
                                                          1e-5)
    assert rstd.shape == ref_rstd.shape == (2, t_out, 1)
    assert np.abs(xhat.numpy() - ref_xhat).max() < 1e-5
    assert np.abs(rstd.numpy() / ref_rstd - 1.0).max() < 1e-5


@pytest.mark.parametrize("k,t_in", CASES)
def test_gradients_match_jax(k, t_in):
    arrays = make(k, t_in, seed=1)
    t_out = fused_frontend.out_length(t_in, k)
    w = np.cos(0.01 * np.arange(2 * t_out * C)).reshape(2, t_out, C)
    w = w.astype(np.float32)

    def loss(*a):
        return jnp.sum(jax_ff.fused_conv_ln_gelu(*a) * w)

    refs = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    leaves = _torch(arrays, grad=True)
    (fused_frontend.fused_conv_ln_gelu(*leaves)
     * torch.from_numpy(w)).sum().backward()
    for name, leaf, ref in zip(("dx", "dkernel", "dbias", "dscale",
                                "dln_bias"), leaves, refs):
        ref = np.asarray(ref)
        err = np.abs(leaf.grad.numpy() - ref).max() / (np.abs(ref).max()
                                                        + 1e-6)
        assert err < 2e-5, f"{name}: rel err {err}"


def test_unread_trailing_sample_gets_zero_gradient():
    """k = 2 with odd T_in leaves the last sample unread: its dx is 0."""
    arrays = make(2, 1031, seed=2)
    leaves = _torch(arrays, grad=True)
    fused_frontend.fused_conv_ln_gelu(*leaves).sum().backward()
    assert torch.all(leaves[0].grad[:, -1] == 0.0)
    assert torch.any(leaves[0].grad[:, -2] != 0.0)


def test_bf16_matches_jax():
    arrays = make(3, 1030, seed=4)
    x = jnp.asarray(arrays[0], jnp.bfloat16)
    ref = np.asarray(jax_ff.fused_conv_ln_gelu(
        x, *map(jnp.asarray, arrays[1:])).astype(jnp.float32))
    xt = torch.from_numpy(arrays[0]).to(torch.bfloat16)
    with torch.no_grad():
        out = fused_frontend.fused_conv_ln_gelu(xt, *_torch(arrays[1:]))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


def test_cpu_path_launches_no_kernel():
    before = (fused_frontend.LAUNCHES, fused_frontend.BWD_LAUNCHES)
    leaves = _torch(make(3, 9), grad=True)
    fused_frontend.fused_conv_ln_gelu(*leaves).sum().backward()
    assert (fused_frontend.LAUNCHES, fused_frontend.BWD_LAUNCHES) == before
