"""The port's ``EmotionClassifier`` (``nrse_tpu_torch.models.emotion``)
against the JAX package's (``nrse_tpu/models/emotion.py``).

The tiny encoder with every dropout, LayerDrop and SpecAugment at 0 and
the trunks' dropout 0, on both sides; the JAX side on its flash
attention (``use_flash_attention=True``: its Pallas block and flash
kernels in interpret mode), so the dispatch on the frame count is held
too: 7680 samples are 383 tiny frames (the block path, kernel A's and
K3's plain versions), 16000 are 799 (the flash path, K5's plain forward
and backward).  Weights made by JAX and moved through
``models.convert.emotion_params_to_state_dict``; same inputs from numpy
seeds, float32, one ragged row.

  1. The forward for ``task`` ∈ {categorical, dimensional, both} in
     training mode: each branch the task names, the other None; logits
     and A/V/D within 1e-4 of max|ref| (the port's other end-to-end
     bounds: float32 sums in another order, flax's LayerNorm variance as
     E[x²] − E[x]²).
  2. The weighted CE plus the CCC loss (``task="both"``) and every
     parameter's gradient against ``jax.grad``: the loss to 1e-4
     relative, each gradient to 1e-4 of max|ref| with the denominator
     floored at 1e-3 (gradients that are zero analytically are roundoff
     on both sides), as ``tests/test_torch_train_ft_cat_ser.py`` bounds
     them.
  3. The seeded weights load strictly and give finite outputs; in
     training mode the trunks' dropout takes its masks from
     ``TrainRNG``'s head stream in order (shared, then the branches the
     task runs), exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.emotion import EmotionClassifier as JaxEmotionClassifier
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.train.losses import ccc_loss as jax_ccc
from nrse_tpu.train.losses import ce_weight_category as jax_ce
from nrse_tpu_torch.models.convert import (
    emotion_params_to_state_dict,
    init_emotion_state_dict,
)
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMConfig
from nrse_tpu_torch.ops import block_attention, flash_attention
from nrse_tpu_torch.train.losses import ccc_loss, ce_weight_category

torch.set_num_threads(1)

HIDDEN = 32
OFF = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
           layerdrop=0.0, mask_time_prob=0.0)
WEIGHTS = np.array([1.0, 2.0, 0.5, 1.5, 1.0, 1.0, 0.8, 1.2], np.float32)
LENGTHS = [(7680, 383), (16000, 799)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(samples, seed, b=3):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((b, samples))).astype(np.float32)
    mask = np.ones((b, samples), np.float32)
    mask[1, samples * 5 // 8:] = 0.0
    labels = np.array([1, 9, 6], np.int32)[:b]  # 9: masked out of the CE
    avd = rng.uniform(1, 7, (b, 3)).astype(np.float32)
    return x, mask, labels, avd


@pytest.fixture(scope="module")
def pair():
    """The JAX classifier on its flash attention and the port's on the
    same weights."""
    jmodel = JaxEmotionClassifier(
        JaxWavLMConfig.tiny(use_flash_attention=True, **OFF),
        hidden_dim=HIDDEN, dropout=0.0)
    params = JaxEmotionClassifier(JaxWavLMConfig.tiny(**OFF),
                                  hidden_dim=HIDDEN, dropout=0.0).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)),
        jnp.ones((1, 4000)), "both", True)["params"]
    cfg = WavLMConfig.tiny(**OFF)
    model = EmotionClassifier(cfg, hidden_dim=HIDDEN, dropout=0.0)
    model.load_state_dict({
        k: torch.from_numpy(v) for k, v in
        emotion_params_to_state_dict(_np_tree(params), cfg).items()},
        strict=True)
    return jmodel, params, model.train(), cfg


def _rngs(seed):
    key = jax.random.PRNGKey(seed)
    return {"dropout": key, "layerdrop": jax.random.fold_in(key, 1),
            "spec_augment": jax.random.fold_in(key, 2)}


def _counts():
    return (block_attention.LAUNCHES, block_attention.BWD_LAUNCHES,
            flash_attention.LAUNCHES, flash_attention.DQ_LAUNCHES)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("samples,frames", LENGTHS)
def test_forward_matches_jax_for_every_task(pair, samples, frames):
    jmodel, params, model, cfg = pair
    assert int(cfg.feature_lengths(samples)) == frames
    x, mask, _, _ = _batch(samples, 1)
    ref_logits, ref_dims = jax.jit(
        lambda p, x, m: jmodel.apply({"params": p}, x, m, "both", False,
                                     rngs=_rngs(3)))(
        params, jnp.asarray(x), jnp.asarray(mask))
    for task in ("categorical", "dimensional", "both"):
        with torch.no_grad():
            logits, dims = model(torch.from_numpy(x), torch.from_numpy(mask),
                                 task, TrainRNG(7, 0))
        assert (logits is None) == (task == "dimensional")
        assert (dims is None) == (task == "categorical")
        if logits is not None:
            assert logits.shape == (3, 8)
            assert _rel(logits.numpy(), np.asarray(ref_logits)) < 1e-4
        if dims is not None:
            assert dims.shape == (3, 3)
            assert _rel(dims.numpy(), np.asarray(ref_dims)) < 1e-4


@pytest.mark.parametrize("samples,frames", LENGTHS)
def test_losses_and_gradients_match_jax(pair, samples, frames):
    jmodel, params, model, cfg = pair
    x, mask, labels, avd = _batch(samples, 2)
    w = jnp.asarray(WEIGHTS)

    def loss_fn(params):
        logits, dims = jmodel.apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(mask), "both", False,
                                    rngs=_rngs(4))
        return (jax_ce(logits, jnp.asarray(labels), w)
                + jax_ccc(dims, jnp.asarray(avd)))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref = emotion_params_to_state_dict(_np_tree(ref_grads), cfg)

    model.zero_grad()
    before = _counts()
    logits, dims = model(torch.from_numpy(x), torch.from_numpy(mask), "both",
                         TrainRNG(7, 1))
    loss = ce_weight_category(logits, torch.from_numpy(labels),
                              torch.from_numpy(WEIGHTS)) \
        + ccc_loss(dims, torch.from_numpy(avd))
    loss.backward()
    assert _counts() == before  # the CPU runs the plain versions
    ref_loss = float(ref_loss)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-4 * abs(ref_loss)
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    assert "encoder.encoder.layers.0.attention.rel_attn_embed.weight" in ref
    for name, r in ref.items():
        g = grads[name].grad.numpy()
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-3)
        assert err < 1e-4, f"{name}: {err}"
    # both branches and the shared trunk are reached
    for name in ("categorical_out.weight", "dimensional_out.weight",
                 "shared_dense.weight", "pooling.attention"):
        assert np.abs(ref[name]).max() > 0.0


def test_seeded_weights_load_and_run():
    cfg = WavLMConfig.tiny()
    model = EmotionClassifier(cfg, hidden_dim=HIDDEN)
    model.load_state_dict(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(0), HIDDEN), strict=True)
    model.eval()
    x, mask, _, _ = _batch(7680, 5)
    with torch.no_grad():
        logits, dims = model(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.isfinite(logits).all() and torch.isfinite(dims).all()
    with pytest.raises(ValueError, match="task"):
        model(torch.from_numpy(x), torch.from_numpy(mask), "regression")


@pytest.mark.parametrize("task", ["both", "dimensional"])
def test_trunk_dropout_draws_from_the_head_stream(task):
    """The trunks' dropout (flax's: keep with 1 − p, scale 1/(1 − p)) takes
    its masks from ``TrainRNG``'s head stream in order: shared, then the
    branches the task runs."""
    from nrse_tpu_torch.models.wavlm import STREAM_HEAD_DROPOUT

    cfg = WavLMConfig.tiny(**OFF)
    model = EmotionClassifier(cfg, hidden_dim=HIDDEN, dropout=0.5)
    model.load_state_dict(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(1), HIDDEN))
    x, mask, _, _ = _batch(7680, 6)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    rng = TrainRNG(7, 3)
    with torch.no_grad():
        logits, dims = model.train()(x, mask, task, rng)
        seq, _ = model.encoder(x, mask, rng)
        h = model.pooling(seq, mask).float()
        gen = rng.generator(STREAM_HEAD_DROPOUT)

        def trunk(name, h):
            h = torch.relu(getattr(model, f"{name}_norm")(
                getattr(model, f"{name}_dense")(h)))
            keep = torch.rand(h.shape, generator=gen) >= 0.5
            return torch.where(keep, h * 2.0, torch.zeros_like(h))

        shared = trunk("shared", h)
        if task == "both":
            torch.testing.assert_close(
                logits, model.categorical_out(trunk("categorical", shared)),
                rtol=0, atol=0)
        else:
            assert logits is None
        torch.testing.assert_close(
            dims, model.dimensional_out(trunk("dimensional", shared)),
            rtol=0, atol=0)
