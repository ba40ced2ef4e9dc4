"""The traffic generator repeats for a seed, gives every seed the same
set of lengths, and keeps to the stated distribution."""

import numpy as np
import pytest

from portbench import corpus, run

SR = 16000


def traffic(name):
    return run.load_json(run.BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["pretrain-crops-5s", "msp-like-2-11s",
                                  "msp-like-ragged"])
def test_lengths_keep_to_the_stated_range_and_distribution(name):
    t = traffic(name)
    for group in t["groups"]:
        n = corpus.lengths(group, np.random.default_rng(0), SR)
        lo, hi = group["seconds"]
        assert len(n) == group["count"]
        assert (n >= lo * SR - 1).all() and (n <= hi * SR + 1).all()
        # uniform: the midpoint quantiles, so mean and spread are exact
        assert abs(n.mean() / SR - (lo + hi) / 2) < 1e-3 * max(hi, 1)
        if hi > lo:
            q = np.sort(n) / SR
            expected = lo + (hi - lo) * (np.arange(len(q)) + 0.5) / len(q)
            assert np.abs(q - expected).max() < 1e-3


def test_one_seed_repeats_and_seeds_share_their_lengths():
    t = {"groups": [{"name": "a", "kind": "speech", "count": 12,
                     "seconds": [2.0, 11.5]},
                    {"name": "n", "kind": "noise", "count": 3,
                     "seconds": [1.0, 1.0]}]}
    a, b, c = (corpus.clips(t, s) for s in (2**31 + 5, 2**31 + 5, 7))
    for g in ("a", "n"):
        assert all(np.array_equal(x, y) for x, y in zip(a[g], b[g]))
        assert sorted(map(len, a[g])) == sorted(map(len, c[g]))
    assert any(not np.array_equal(x, y) for x, y in zip(a["a"], c["a"]))
    assert all(np.abs(x).max() <= 1.0 and np.abs(x).max() > 0.01
               for x in a["a"] + a["n"])


def test_labels_take_fixed_counts_from_the_shares():
    t = traffic("msp-like-2-11s")
    a = corpus.labels(t, 256, 11)
    b = corpus.labels(t, 256, 12)
    assert np.array_equal(np.bincount(a, minlength=8),
                          np.bincount(b, minlength=8))
    assert not np.array_equal(a, b)
    shares = np.asarray(t["label_shares"]) / sum(t["label_shares"])
    assert np.abs(np.bincount(a, minlength=8) / 256 - shares).max() < 0.01


def test_epoch_order_keeps_the_first_rows_distinct():
    order = corpus.epoch_order(256, 36 * 20, 3)
    assert len(set(order[:256].tolist())) == 256
    assert len(order) == 720 and order.max() < 256
