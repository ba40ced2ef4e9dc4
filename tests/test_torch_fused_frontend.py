"""K6's plain versions against the JAX package's ``fused_conv_ln_gelu``.

The same numpy inputs go through ``nrse_tpu.ops.fused_frontend`` (its
Pallas kernels in interpret mode on the CPU, as its own tests run them) and
the port's ``fused_conv_ln_gelu`` on CPU tensors (the plain versions).
Tolerances are JAX's own (``tests/test_fused_frontend.py``): the forward
within 1e-5 absolute in float32, the five gradients within 2e-5 of the
reference's max|·|; bf16 within 1e-2 of max|ref| (one bf16 rounding of
each output, in other places on the two sides).  C = 128 keeps the cases
quick; the kernel's arithmetic does not depend on C, and one case runs at
the kernels' C = 512.  The rest hold the CUDA kernels' launch plans and
tensor maps, which this machine cannot run, to their invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.ops import fused_frontend as jax_ff
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import fused_frontend

torch.set_num_threads(1)

C = 128
CASES = [(3, 1031), (3, 1030), (2, 1030), (2, 1031), (3, 513), (3, 2051),
         (2, 3), (3, 3), (2, 4), (3, 4), (2, 5), (3, 5)]


def make(k, t_in, seed=0, c=C):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t_in, c)).astype(np.float32),
            (rng.standard_normal((k, c, c)) * 0.05).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


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


def test_forward_and_gradients_match_jax_at_kernel_width():
    """C = 512, the CUDA kernels' width: k = 3, odd T_in, the JAX kernels
    in interpret mode against the port's plain path, at this file's
    tolerances."""
    c, k, t_in = fused_frontend.CHANNELS, 3, 33
    arrays = make(k, t_in, seed=5, c=c)
    jargs = list(map(jnp.asarray, arrays))
    ref = np.asarray(jax_ff.fused_conv_ln_gelu(*jargs))
    t_out = fused_frontend.out_length(t_in, k)
    w = np.cos(0.01 * np.arange(2 * t_out * c)).reshape(2, t_out, c)
    w = w.astype(np.float32)
    refs = jax.grad(lambda *a: jnp.sum(jax_ff.fused_conv_ln_gelu(*a) * w),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
    leaves = _torch(arrays, grad=True)
    out = fused_frontend.fused_conv_ln_gelu(*leaves)
    assert out.shape == ref.shape == (2, t_out, c)
    assert np.abs(out.detach().numpy() - ref).max() < 1e-5
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, g in zip(("dx", "dkernel", "dbias", "dscale",
                              "dln_bias"), leaves, refs):
        g = np.asarray(g)
        err = np.abs(leaf.grad.numpy() - g).max() / (np.abs(g).max() + 1e-6)
        assert err < 2e-5, f"{name}: rel err {err}"


def _frontend_layers():
    """Every (B, T_in, k) K6 runs on: wavlm-large's layers 1-6 at clips of
    5/10/15/30/64 s and batches 1, 8, 32, 36, and the ragged shapes."""
    cfg = WavLMConfig.large()
    shapes = set()
    for seconds in (5, 10, 15, 30, 64):
        t = (seconds * 16000 - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
        for k, s in zip(cfg.conv_kernel[1:], cfg.conv_stride[1:]):
            shapes.update((b, t, k) for b in (1, 8, 32, 36))
            t = (t - k) // s + 1
    shapes.update((2, t, k) for t in (3, 4, 5, 1030, 1031) for k in (2, 3))
    return sorted(shapes)


LAYERS = _frontend_layers()


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_fwd_plan(sms):
    """K6's forward launch at every frontend shape: persistent blocks, one
    an SM and at most one a 64-row tile, K-tiles of 64 over k C, and
    shared memory within the H100's 232,448 bytes (the C entry refuses a
    plan whose bytes differ from the kernel's)."""
    assert fused_frontend.FWD_SMEM == 223_280
    assert fused_frontend.FWD_SMEM <= fused_frontend.SMEM_LIMIT == 232_448
    for b, t_in, k in LAYERS:
        plan = fused_frontend.fwd_plan(b, t_in, k, sms)
        assert plan["tiles"] == b * -(-fused_frontend.out_length(t_in, k)
                                      // 64)
        assert plan["grid"] == min(plan["tiles"], sms) >= 1
        assert plan["k_tiles"] == 8 * k
        assert plan["smem"] == fused_frontend.FWD_SMEM


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_bwd_plan(sms):
    """K6's backward launch at every frontend shape: the row pass's
    partials, dx's 4 tiles per 128 pair rows of each batch over at most one
    block an SM, dW's 128 x 256 tiles of [k C, C] times row chunks of at
    most two waves (11 and 8 on an H100, filling its 132 SMs: 264 and 128
    blocks), the partials' bytes, and shared memory within 232,448."""
    assert fused_frontend.BWD_SMEM == 197_696 <= fused_frontend.SMEM_LIMIT
    for b, t_in, k in LAYERS:
        plan = fused_frontend.bwd_plan(b, t_in, k, sms)
        t_out = fused_frontend.out_length(t_in, k)
        assert plan["row_partials"] == min(512, -(-b * t_out // 8))
        assert plan["dx_tiles"] == b * (((t_in + 1) // 2 + 127) // 128) * 4
        assert plan["dx_grid"] == min(plan["dx_tiles"], sms)
        assert plan["dw_tiles"] == {2: 16, 3: 24}[k]
        chunks = plan["dw_chunks"]
        assert chunks == 1 or plan["dw_tiles"] * chunks <= 2 * sms
        assert plan["dw_grid"] == (plan["dw_tiles"], chunks)
        assert plan["k_tiles"] == b * -(-t_out // 64)
        assert plan["dw_part_bytes"] == chunks * k * 512 * 512 * 4
        if sms == 132:
            assert chunks == {2: 8, 3: 11}[k]
        if sms == 1:
            assert chunks == 1 and plan["dx_grid"] == 1


@pytest.mark.parametrize("b,t_in,k", LAYERS)
def test_tma_maps_stay_in_their_batch(b, t_in, k):
    """The last element each x and dz map can address lies inside its own
    batch's rows (odd T_in included: no pair view runs into the next
    batch), and boxes are 128-byte rows of at most 256 rows from 16-byte
    aligned addresses.  The C entries make their maps from these
    (:func:`fused_frontend.map_geometry`)."""
    c = fused_frontend.CHANNELS
    t_out = fused_frontend.out_length(t_in, k)
    rows = {"x": t_in, "dz": t_out}
    maps = fused_frontend.tma_maps(b, t_in, k)
    assert ("x_tap2" in maps) == (k == 3)
    for name, (tensor, first, dims, strides, box) in maps.items():
        per_batch = rows[tensor] * c
        assert strides[0] == 1 and strides[2] == per_batch
        assert box[0] * 2 == 128 and box[1] <= 256 and box[2] == 1
        assert (first * 2) % 16 == 0 and (strides[1] * 2) % 16 == 0
        last = first + (dims[0] - 1) + (dims[1] - 1) * strides[1]
        for bi in (0, b - 1):
            assert bi * per_batch <= first + bi * per_batch
            assert last + bi * per_batch < (bi + 1) * per_batch, name


@pytest.mark.parametrize("t_in,k", [(7, 2), (7, 3), (8, 2), (8, 3), (9, 3)])
def test_x_maps_are_the_conv_operand(t_in, k):
    """x's tap maps, side by side along their inner dimension, address
    exactly row t's K = k C operand x[b, 2t .. 2t + k - 1] of every row of
    every batch: taps 0-1, then tap 2."""
    c, b = fused_frontend.CHANNELS, 2
    t_out = fused_frontend.out_length(t_in, k)
    maps = fused_frontend.tma_maps(b, t_in, k)
    parts = []
    for name in ("x_taps01", "x_tap2")[:k - 1]:
        _, first, dims, strides, _ = maps[name]
        assert dims[1:] == (t_out, b)
        parts.append(first + np.arange(dims[0])[None, None, :]
                     + np.arange(t_out)[None, :, None] * strides[1]
                     + np.arange(b)[:, None, None] * strides[2])
    got = np.concatenate(parts, axis=-1)  # [b, t, K] element offsets
    want = ((np.arange(b)[:, None, None] * t_in
             + 2 * np.arange(t_out)[None, :, None]) * c
            + np.arange(k * c)[None, None, :])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("b,t_in,k", [(2, 1031, 2), (2, 1031, 3),
                                      (32, 31999, 3), (36, 15999, 3)])
def test_map_geometry_is_tma_maps(b, t_in, k):
    """The words the C entries make their tensor maps from: each named map
    of :func:`tma_maps` in the entry's order, 10 words (first element,
    dims, strides, box), the box rows the kernels copy (64, and 128 for dz
    in the dx product), taps 0-1 in tap 2's place for k = 2."""
    maps = fused_frontend.tma_maps(b, t_in, k)
    assert ("x_tap2" in maps) == (k == 3)
    for names in (fused_frontend.FWD_MAPS, fused_frontend.BWD_MAPS):
        words = fused_frontend.map_geometry(b, t_in, k, names)
        assert len(words) == 10 * len(names)
        for i, name in enumerate(names):
            got = words[10 * i:10 * (i + 1)]
            _, first, dims, strides, box = maps.get(name, maps["x_taps01"])
            assert got == [first, *dims, *strides, *box]
            assert got[4] == 1
            assert got[7:] == [64, 128 if name == "dz_dx" else 64, 1]
