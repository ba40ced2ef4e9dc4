"""Port's ``fused_ffn`` (plain paths on the CPU) against the JAX Pallas
kernels (interpret mode): the deterministic forward with a zero seed,
and ``fused_ffn_masked``'s forward and all five gradients against
``jax.vjp`` of JAX's ``fused_ffn_masked`` with the same masks (p = 0.1).

Float32 throughout.  Tolerances: 1e-5 absolute on the output and 1e-4
``max|Δ|/max|ref|`` on the gradients: the JAX kernels' GELU and GELU′ use
the A&S rational erf (|err| ≤ 1.5e-7, ``nrse_tpu/ops/tpu_math.py``) where
the port uses the exact erf, and the two sum in different orders.  The
seeded ``fused_ffn``'s gradients must equal, exactly, the masked
variant's fed ``dump_masks(seed)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops.fused_ffn import ROW_BLOCK
from nrse_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from nrse_tpu.ops.fused_ffn import fused_ffn_masked as jax_fused_ffn_masked
from nrse_tpu_torch.ops import fused_ffn as port
from nrse_tpu_torch.ops import philox

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4
P = 0.1


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


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _masks(n, c, f, seed=3):
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0) / np.float32(1.0 - P)
    return ((rng.random((n, f)) >= P).astype(np.float32) * scale,
            (rng.random((n, c)) >= P).astype(np.float32) * scale)


@pytest.mark.parametrize("f", [256, 1024])
def test_masked_forward_and_grads_match_jax(f):
    n, c = ROW_BLOCK + 40, 128
    x, w1, b1, w2, b2 = _params(c, f, n, seed=4)
    ma, mh = _masks(n, c, f)
    dout = np.random.default_rng(5).standard_normal((n, c)).astype(
        np.float32)
    ref, vjp = jax.vjp(
        lambda *a: jax_fused_ffn_masked(*a, jnp.asarray(ma), jnp.asarray(mh)),
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    out = port.fused_ffn_masked(*args, torch.from_numpy(ma),
                                torch.from_numpy(mh))
    out.backward(torch.from_numpy(dout))
    assert np.abs(out.detach().numpy() - np.asarray(ref)).max() < TOL
    got = [a.grad.numpy() for a in args]
    got[1], got[3] = got[1].T, got[3].T       # back to flax's [in, out]
    errs = {name: _rel(g, r) for name, g, r in
            zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref_grads)}
    assert max(errs.values()) < GRAD_TOL, errs


def test_seeded_grads_equal_masked_with_dumped_masks():
    n, c, f = 70, 128, 256
    x, w1, b1, w2, b2 = _params(c, f, n, seed=6)
    dout = torch.from_numpy(
        np.random.default_rng(7).standard_normal((n, c)).astype(np.float32))
    seed = philox.seed_tensor((11, 22))
    grads = []
    for masked in (False, True):
        args = [torch.from_numpy(a).requires_grad_()
                for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
        if masked:
            out = port.fused_ffn_masked(
                *args, *port.dump_masks(seed, n, c, f, P, 0.2))
        else:
            out = port.fused_ffn(*args, seed, P, 0.2)
        out.backward(dout)
        grads.append([out.detach()] + [a.grad for a in args])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,want", [
    (1, (1, 1, 32, 8, 4096)),
    (127, (8, 1, 32, 8, 8192)),
    (128, (8, 1, 32, 8, 8192)),
    (8964, (561, 71, 2272, 568, 561 * 1024)),
    (15968, (998, 125, 4000, 1000, 998 * 1024)),
])
def test_dx_plan(n, want):
    """K2's dx kernel at C = 1024, F = 4096: dh2 chunks of 16 rows, 128-row
    tiles of the wgmma products, their 128 x 128 tile counts, and scratch
    for the larger of the two sets of partial column sums."""
    plan = port.dx_plan(n, 1024, 4096)
    assert (plan["dh2_chunks"], plan["row_tiles"], plan["dgd_tiles"],
            plan["dx_tiles"], plan["scratch"]) == want
    assert plan["scratch"] >= max(plan["dh2_chunks"] * 1024,
                                  plan["row_tiles"] * 4096)


@pytest.mark.fast
@pytest.mark.parametrize("n,k_tiles", [(1, 1), (127, 2), (8964, 141),
                                       (15968, 250)])
def test_dw_plan(n, k_tiles):
    """K2's dW kernel at C = 1024, F = 4096: each output tile walks the
    64-row K-tiles of all n rows (the last one ragged), dW1's 256 and
    dW2's 256 tiles of 128 x 128 in one launch, over one persistent block
    an SM of an H100 (132), or over every tile on a card of more SMs than
    tiles."""
    plan = port.dw_plan(n, 1024, 4096, 132)
    assert plan["k_tiles"] == k_tiles
    assert (plan["dw1_tiles"], plan["tiles"], plan["blocks"]) == (
        256, 512, 132)
    assert port.dw_plan(n, 1024, 4096, 600)["blocks"] == 512


@pytest.mark.parametrize("n", [1, 127, 128, 7968, 8964, 15968, 23968])
def test_ffn_fwd_plan(n):
    """Kernel B at C = 1024, F = 4096: 128-row tiles, GEMM1's [n, F] and
    GEMM2's [n, C] 128 x 128 tiles, each entry's GEMM blocks within the
    H100's 232,448 bytes of shared memory, h sized [n, F]."""
    plans = [port.ffn_fwd_plan(n, 1024, 4096, train)
             for train in (False, True)]
    row_tiles = -(-n // 128)
    for plan in plans:
        assert plan["row_tiles"] == row_tiles
        assert plan["gemm1_tiles"] == row_tiles * 32
        assert plan["gemm2_tiles"] == row_tiles * 8
        assert plan["h"] == n * 4096
        assert max(plan["gemm1_smem"], plan["gemm2_smem"]) <= port.SMEM_LIMIT
    # the training entry's epilogues take 4 keep-bit words a consumer thread
    for gemm in ("gemm1_smem", "gemm2_smem"):
        assert plans[1][gemm] - plans[0][gemm] == 2 * 128 * 4 * 4
