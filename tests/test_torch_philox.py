"""The dropout-RNG contract (``nrse_tpu_torch/ops/philox.py``, the plain
twin of ``csrc/philox.cuh``).

Known answers are Random123's ``philox4x32_10`` test vectors (exact).  The
keep fraction at p = 0.1 over 10⁶ draws must lie within 5σ of 0.9
(σ = √(p(1−p)/n) = 3e-4).  An element's mask depends only on (seed,
site, element index): the rows of a whole ``[N, F]`` dump equal the dumps
of the same rows alone, exactly.
"""

import numpy as np
import pytest
import torch

from nrse_tpu_torch.ops import philox

torch.set_num_threads(1)

M = 0xFFFFFFFF
KNOWN = [
    ((0, 0), (0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M), (M, M, M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
]


@pytest.mark.parametrize("key,ctr,want", KNOWN)
def test_known_answers(key, ctr, want):
    assert philox.philox4x32(*key, *ctr) == want
    as_tensor = [torch.full((3,), c, dtype=torch.int64) for c in ctr]
    out = philox.philox4x32(*key, *as_tensor)
    assert [w.tolist() for w in out] == [[v] * 3 for v in want]


def test_keep_fraction_and_values():
    n, p = 10 ** 6, 0.1
    mask = philox.keep_mask((12345, 678), 0, p, n)
    kept = float((mask > 0).float().mean())
    assert abs(kept - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n), kept
    scale = np.float32(1.0) / np.float32(1.0 - p)
    assert set(mask.unique().tolist()) == {0.0, float(scale)}


def test_mask_does_not_depend_on_the_split():
    n, f, seed, site, p = 300, 256, (7, 9), 2, 0.1
    whole = philox.dump_mask(seed, site, (n, f), p)
    for r0, r1 in ((0, 1), (5, 133), (256, 300)):
        part = philox.keep_mask(seed, site, p, (r1 - r0) * f, start=r0 * f)
        assert torch.equal(part.view(r1 - r0, f), whole[r0:r1])


def test_streams_are_distinct():
    seeds = {philox.stream_seed(0, step, tower, layer, site)
             for step in range(3) for tower in range(2)
             for layer in range(4) for site in range(3)}
    assert len(seeds) == 3 * 2 * 4 * 3
    assert philox.stream_seed(1, 0, 0, 0, 0) != philox.stream_seed(
        0, 0, 0, 0, 0)
    a = philox.dump_mask(philox.stream_seed(0, 0), 0, (64, 64), 0.5)
    b = philox.dump_mask(philox.stream_seed(0, 1), 0, (64, 64), 0.5)
    assert not torch.equal(a, b)


# --- the grouped contract: one draw per four consecutive elements ---------
#
# A second Philox4x32-10, in numpy uint64 arithmetic (a 32 x 32-bit product
# fits in 64 bits exactly), independent of ops/philox.py.  Element i of a
# site takes word i mod 4 of the draw at the counter (i >> 2 lo, hi, site,
# 0); masks are compared exactly.

U64 = np.uint64
M32 = U64(0xFFFFFFFF)


def _np_philox(k0, k1, c0, c1, c2, c3):
    k0, k1 = U64(k0), U64(k1)
    c = [np.asarray(x, dtype=np.uint64) for x in (c0, c1, c2, c3)]
    for _ in range(10):
        p0 = U64(0xD2511F53) * c[0]
        p1 = U64(0xCD9E8D57) * c[2]
        c = [(p1 >> U64(32)) ^ c[1] ^ k0, p1 & M32,
             (p0 >> U64(32)) ^ c[3] ^ k1, p0 & M32]
        k0 = (k0 + U64(0x9E3779B9)) & M32
        k1 = (k1 + U64(0xBB67AE85)) & M32
    return c


def _np_keep_mask(seed, site, p, count, start=0):
    idx = np.arange(start, start + count, dtype=np.uint64)
    g = idx >> U64(2)
    words = _np_philox(seed[0], seed[1], g & M32, g >> U64(32),
                       np.full_like(g, site), np.zeros_like(g))
    bits = np.choose((idx & U64(3)).astype(np.int64), words)
    u = (bits >> U64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return (u >= np.float32(p)).astype(np.float32) * np.float32(
        philox.keep_scale(p))


def test_numpy_philox_known_answers():
    for key, ctr, want in KNOWN:
        got = _np_philox(*key, *([c] for c in ctr))
        assert [int(w[0]) for w in got] == list(want)


@pytest.mark.parametrize("start", [0, 1, 2, 3, 5, 4099])
@pytest.mark.parametrize("count", [1, 2, 7, 13, 4097])
def test_keep_mask_is_the_grouped_rule(start, count):
    seed, site, p = (0x9E3779B9, 0x7F4A7C15), 3, 0.3
    got = philox.keep_mask(seed, site, p, count, start=start)
    want = _np_keep_mask(seed, site, p, count, start)
    assert got.shape == (count,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_element_bits_are_word_i_mod_4_of_the_group_draw():
    seed, site = (123, 456), 1
    for i in (0, 1, 2, 3, 4, 5, 6, 7, 1021, 1022, 1023, 2 ** 33 + 6):
        words = philox.philox4x32(*seed, (i >> 2) & M, i >> 34, site, 0)
        bits = words[i & 3]
        for p in (0.05, 0.5, 0.95):
            kept = (bits >> 8) * 2.0 ** -24 >= np.float32(p)
            want = philox.keep_scale(p) if kept else 0.0
            got = float(philox.keep_mask(seed, site, p, 1, start=i)[0])
            assert got == np.float32(want), (i, p)


@pytest.mark.parametrize("f", [254, 255, 257])
def test_split_with_unaligned_rows(f):
    n, seed, site, p = 41, (3, 5), 0, 0.2
    whole = philox.dump_mask(seed, site, (n, f), p)
    for r0, r1 in ((0, 1), (1, 2), (3, 17), (40, 41)):
        part = philox.keep_mask(seed, site, p, (r1 - r0) * f, start=r0 * f)
        assert torch.equal(part.view(r1 - r0, f), whole[r0:r1])
    for i0, cnt in ((1, 3), (2, 5), (f - 1, 2), (7 * f + 3, f)):
        part = philox.keep_mask(seed, site, p, cnt, start=i0)
        assert torch.equal(part, whole.reshape(-1)[i0:i0 + cnt])


def test_keep_fraction_in_each_word_position():
    n, p = 4 * 250_000, 0.1
    kept = (philox.keep_mask((2024, 7), 0, p, n) > 0).view(-1, 4).float()
    sigma = np.sqrt(p * (1 - p) / (n // 4))
    for e in range(4):
        frac = float(kept[:, e].mean())
        assert abs(frac - (1 - p)) < 5 * sigma, (e, frac)


def test_no_correlation_between_neighbours_in_a_group():
    n, p = 4 * 250_000, 0.5
    kept = (philox.keep_mask((77, 88), 2, p, n) > 0).view(-1, 4).double()
    z = (kept - kept.mean(0)) / kept.std(0)
    for e in range(3):
        r = float((z[:, e] * z[:, e + 1]).mean())
        assert abs(r) < 5 / np.sqrt(n // 4), (e, r)
