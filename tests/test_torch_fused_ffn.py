"""Port's ``fused_ffn`` (plain path on the CPU) against the JAX Pallas
kernel (interpret mode) with a zero seed and no dropout.

Float32 throughout.  Tolerance 1e-5 absolute: the JAX kernel's GELU uses
the A&S rational erf (|err| ≤ 1.5e-7, ``nrse_tpu/ops/tpu_math.py``) where
the port uses the exact erf, and the two sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops.fused_ffn import ROW_BLOCK
from nrse_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from nrse_tpu_torch.ops import fused_ffn as port

torch.set_num_threads(1)

TOL = 1e-5


def _params(c, f, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    w1 = (0.1 * rng.standard_normal((c, f))).astype(np.float32)   # [in, out]
    b1 = (0.1 * rng.standard_normal((f,))).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((f, c))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((c,))).astype(np.float32)
    return x, w1, b1, w2, b2


def _port(x, w1, b1, w2, b2):
    # torch keeps Linear weights as [out, in]
    args = [torch.from_numpy(a) for a in (x, w1.T.copy(), b1, w2.T.copy(),
                                          b2)]
    return port.fused_ffn(*args).numpy()


@pytest.mark.parametrize("f", [256, 1024])
def test_matches_jax_fused_ffn(f):
    x, w1, b1, w2, b2 = _params(128, f, ROW_BLOCK + 40)
    ref = jax_fused_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                        jnp.zeros((2,), jnp.uint32), 0.0, 0.0)
    ours = _port(x, w1, b1, w2, b2)
    assert ours.shape == x.shape and ours.dtype == np.float32
    err = np.abs(ours - np.asarray(ref)).max()
    assert err < TOL, f"max abs err {err}"


def test_batched_shape_and_plain_path():
    x, w1, b1, w2, b2 = _params(128, 256, 3 * 50, seed=1)
    args = [torch.from_numpy(a) for a in (w1.T.copy(), b1, w2.T.copy(), b2)]
    xb = torch.from_numpy(x).view(3, 50, 128)
    y = port.fused_ffn(xb, *args)
    assert y.shape == xb.shape
    assert torch.equal(y.reshape(-1, 128),
                       port.ffn_plain(torch.from_numpy(x), *args))


def test_rejects_mismatched_weights():
    x, w1, b1, w2, b2 = _params(128, 256, 8, seed=2)
    with pytest.raises(ValueError, match="weights"):
        port.fused_ffn(torch.from_numpy(x), torch.from_numpy(w1),
                       torch.from_numpy(b1), torch.from_numpy(w2),
                       torch.from_numpy(b2))
