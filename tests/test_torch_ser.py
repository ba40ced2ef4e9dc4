"""The port's SER evaluation modules against the JAX package's: ASP pooling
and its masks, the ``EmotionRegression`` head, and the tiny
``BaselineSER`` end to end with the JAX side on its flash attention
(``use_flash_attention=True``), so the dispatch on the frame count is held
too: 16000 samples are 799 tiny frames (the flash path, K5's plain
version), 7680 are 383 (the block path, kernel A's plain version).

Same inputs from numpy seeds on both sides, float32; weights made by JAX
and moved through ``models.convert.baseline_params_to_state_dict``.
Bounds: 1e-5 for the pooling and the head (float32 sums in another order;
flax's LayerNorm takes the variance as E[x²] − E[x]², torch in two
passes), 1e-4 of max|logits| for the whole pipeline, as the port's other
end-to-end tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.baseline.net import EmotionRegression as JaxEmotionRegression
from nrse_tpu.baseline.pipeline import BaselineSER as JaxBaselineSER
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.ops import asp_pooling as jax_asp
from nrse_tpu_torch.baseline.net import EmotionRegression
from nrse_tpu_torch.baseline.pipeline import (
    BaselineSER,
    bucket_length,
    make_baseline_forward,
)
from nrse_tpu_torch.models.convert import (
    baseline_params_to_state_dict,
    init_baseline_state_dict,
)
from nrse_tpu_torch.models.emotion import AttentiveStatisticsPooling
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import asp_pooling, block_attention, flash_attention
from torch_init import with_random_biases

torch.set_num_threads(1)

HEAD_DIM = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _wav_mask(b, n, lengths):
    mask = np.zeros((b, n), np.float32)
    for i, ln in enumerate(lengths):
        mask[i, :ln] = 1.0
    return mask


def test_frame_masks_match_jax():
    mask = _wav_mask(4, 16000, [16000, 9001, 320, 1])
    lengths = asp_pooling.frame_lengths_from_mask(torch.from_numpy(mask))
    assert lengths.tolist() == [50, 29, 1, 1]  # (len − 1) // 320 + 1
    np.testing.assert_array_equal(
        lengths.numpy(),
        np.asarray(jax_asp.frame_lengths_from_mask(jnp.asarray(mask))))
    ours = asp_pooling.frame_mask_from_wav_mask(torch.from_numpy(mask), 60)
    ref = jax_asp.frame_mask_from_wav_mask(jnp.asarray(mask), 60)
    assert ours.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mask_kind", ["wav", "frames", "none"])
def test_attentive_stats_pooling_matches_jax(mask_kind):
    rng = np.random.default_rng(1)
    b, t, d = 3, 40, 24
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) / d ** 0.5).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    v = rng.standard_normal((d, 1)).astype(np.float32)
    mask = {"wav": _wav_mask(b, 800, [800, 500, 100]),
            "frames": _wav_mask(b, t, [40, 17, 3]),
            "none": None}[mask_kind]
    pool = AttentiveStatisticsPooling(d)
    pool.load_state_dict({"sap_linear_kernel": torch.from_numpy(w),
                          "sap_linear_bias": torch.from_numpy(bias),
                          "attention": torch.from_numpy(v)})
    with torch.no_grad():
        ours = pool(torch.from_numpy(x),
                    None if mask is None else torch.from_numpy(mask))
    if mask is None:
        frames = np.ones((b, t), bool)
    elif mask.shape[1] == t:
        frames = mask.astype(bool)
    else:
        frames = np.asarray(jax_asp.frame_mask_from_wav_mask(
            jnp.asarray(mask), t))
    ref = jax_asp.attentive_stats_pool(jnp.asarray(x), jnp.asarray(frames),
                                       jnp.asarray(w), jnp.asarray(bias),
                                       jnp.asarray(v))
    assert ours.shape == (b, 2 * d)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("layers", [1, 2])
def test_emotion_regression_matches_jax(layers):
    rng = np.random.default_rng(layers)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    head = JaxEmotionRegression(hidden_dim=HEAD_DIM, num_layers=layers,
                                output_dim=8)
    params = _np_tree(head.init(jax.random.PRNGKey(layers),
                                jnp.asarray(x))["params"])
    ref = np.asarray(head.apply({"params": params}, jnp.asarray(x)))
    ours = EmotionRegression(48, HEAD_DIM, layers, 8)
    sd = {}
    for name, tree in params.items():  # flax Dense [in, out], LayerNorm
        if name.startswith("norm_"):
            sd[f"{name}.weight"], sd[f"{name}.bias"] = tree["scale"], \
                tree["bias"]
        else:
            sd[f"{name}.weight"], sd[f"{name}.bias"] = tree["kernel"].T, \
                tree["bias"]
    ours.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    assert ours.norm_0.eps == 1e-6  # flax's, not torch's 1e-5
    ours.eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() < 1e-5


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny ``BaselineSER`` on its flash attention and the port's,
    on the same weights."""
    jmodel = JaxBaselineSER(JaxWavLMConfig.tiny(use_flash_attention=True),
                            head_dim=HEAD_DIM)
    # the same parameter tree, initialised without the Pallas kernels
    params = JaxBaselineSER(JaxWavLMConfig.tiny(), head_dim=HEAD_DIM).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
        jnp.ones((1, 4000)))["params"]
    cfg = WavLMConfig.tiny()
    model = BaselineSER(cfg, head_dim=HEAD_DIM)
    model.load_state_dict({
        k: torch.from_numpy(v) for k, v in
        baseline_params_to_state_dict(_np_tree(params), cfg).items()},
        strict=True)
    return jmodel, params, model


class _Counted:
    """Wraps a plain version as a wrapper module looks it up, counting
    calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("samples,frames,path", [(16000, 799, "flash"),
                                                 (7680, 383, "block")])
def test_tiny_baseline_matches_jax(tiny_pair, monkeypatch, samples, frames,
                                   path):
    jmodel, params, model = tiny_pair
    assert int(WavLMConfig.tiny().feature_lengths(samples)) == frames
    rng = np.random.default_rng(samples)
    x = (0.3 * rng.standard_normal((2, samples))).astype(np.float32)
    mask = _wav_mask(2, samples, [samples, samples * 5 // 8])
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(mask), deterministic=True))

    flash = _Counted(flash_attention.flash_attention_plain_fwd)
    block = _Counted(block_attention.gated_bias_attention_fwd)
    monkeypatch.setattr(flash_attention, "flash_attention_plain_fwd", flash)
    monkeypatch.setattr(block_attention, "gated_bias_attention_fwd", block)
    launches = (flash_attention.LAUNCHES, block_attention.LAUNCHES)
    ours = make_baseline_forward(model)(torch.from_numpy(x),
                                        torch.from_numpy(mask)).numpy()
    layers = WavLMConfig.tiny().num_hidden_layers
    want = {"flash": (layers, 0), "block": (0, layers)}[path]
    assert (flash.calls, block.calls) == want
    assert (flash_attention.LAUNCHES, block_attention.LAUNCHES) == launches
    assert ours.shape == (2, 8) and ours.dtype == np.float32
    rel = np.abs(ours - ref).max() / np.abs(ref).max()
    assert rel < 1e-4, f"max|Δ|/max|ref| {rel}"


def test_seeded_init_loads_and_buckets():
    cfg = WavLMConfig.tiny()
    sd = with_random_biases(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(0), head_dim=HEAD_DIM), 0)
    model = BaselineSER(cfg, head_dim=HEAD_DIM)
    model.load_state_dict(sd, strict=True)
    assert torch.equal(sd["ser.norm_0.weight"], torch.ones(HEAD_DIM))
    again = with_random_biases(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(0), head_dim=HEAD_DIM), 0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    # 5 s buckets capped at 30 s (nrse_tpu/baseline/pipeline.py:58-66)
    assert [bucket_length(n) for n in (1, 80000, 80001, 175000, 10 ** 7)] \
        == [80000, 80000, 160000, 240000, 480000]
    # training mode at T > 384 would need K5's backward: it raises
    model.train()
    with pytest.raises(ValueError, match="TrainRNG"):
        model(torch.zeros(1, 16000), torch.ones(1, 16000))
