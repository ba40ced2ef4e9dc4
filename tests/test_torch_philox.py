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
