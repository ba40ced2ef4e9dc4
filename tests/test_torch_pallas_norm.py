"""K7's plain versions against the JAX package's ``pallas_channel_layernorm``.

The same numpy inputs go through ``nrse_tpu.ops.pallas_norm`` (its Pallas
kernels in interpret mode on the CPU) and the port's ``channel_layernorm``
on CPU tensors (the plain versions), in float32, with N = B·T not a
multiple of the TPU wrapper's 512-row block.  Forward and the three
gradients within 1e-5 of the reference's max|·| (float32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops import pallas_norm as jax_pn
from nrse_tpu_torch.ops import pallas_norm

torch.set_num_threads(1)

TOL = 1e-5


def make(shape, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return ((offset + rng.standard_normal(shape)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _close(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() <= TOL * max(
        1.0, np.abs(ref).max())


# (shape, mean offset): N = 603 and 1 rows; a large channel mean, as a conv
# of raw audio can give, exercises the fast variance's cancellation
SHAPES = [((3, 201, 64), 0.0), ((1, 1, 512), 0.0), ((2, 389, 512), 4.0)]


@pytest.mark.parametrize("shape,offset", SHAPES)
def test_forward_matches_jax(shape, offset):
    x, scale, bias = make(shape, offset=offset)
    ref = jax_pn.pallas_channel_layernorm(*map(jnp.asarray, (x, scale, bias)))
    with torch.no_grad():
        out = pallas_norm.channel_layernorm(*map(torch.from_numpy,
                                                 (x, scale, bias)))
    assert out.shape == x.shape and out.dtype == torch.float32
    assert _close(out.numpy(), ref)


@pytest.mark.parametrize("shape,offset", SHAPES)
def test_gradients_match_jax(shape, offset):
    x, scale, bias = make(shape, seed=1, offset=offset)
    w = np.cos(0.01 * np.arange(x.size)).reshape(x.shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(jax_pn.pallas_channel_layernorm(*a) * w)

    refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                  (x, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    (pallas_norm.channel_layernorm(*leaves) * torch.from_numpy(w)
     ).sum().backward()
    for name, leaf, ref in zip(("dx", "dscale", "dbias"), leaves, refs):
        assert _close(leaf.grad.numpy(), ref), name


def test_saved_statistics_match_jax():
    """mean and inv of the plain forward are the TPU forward kernel's."""
    x, scale, bias = make((4, 128, 64), seed=2, offset=1.0)
    x2 = x.reshape(-1, 64)
    _, mean, inv = jax_pn._ln_fwd_impl(jnp.asarray(x2), jnp.asarray(scale),
                                       jnp.asarray(bias), 1e-5)
    _, t_mean, t_inv = pallas_norm.channel_layernorm_plain_fwd(
        torch.from_numpy(x2), torch.from_numpy(scale),
        torch.from_numpy(bias), 1e-5)
    assert t_mean.shape == t_inv.shape == (512, 1)
    assert _close(t_mean.numpy(), mean)
    assert np.abs(t_inv.numpy() / np.asarray(inv) - 1.0).max() < TOL


def test_bf16_output_dtype_and_no_launch():
    x, scale, bias = make((2, 33, 64), seed=3)
    before = (pallas_norm.LAUNCHES, pallas_norm.BWD_LAUNCHES)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = pallas_norm.channel_layernorm(xt, torch.from_numpy(scale),
                                        torch.from_numpy(bias))
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    assert (pallas_norm.LAUNCHES, pallas_norm.BWD_LAUNCHES) == before
