"""The port's SER train step (``nrse_tpu_torch.train.emotion_trainer``)
against the JAX package's (``nrse_tpu/train/emotion_trainer.py``) and its
helpers against theirs.

  1. Two train steps of the tiny classifier (``task="categorical"``, class
     weights, weight decay 1e-2, the LR changed between the steps as
     ``ReduceLROnPlateau`` would) against ``make_emotion_train_step`` with
     optax's ``clip_by_global_norm(1.0) → adamw``, from the same weights
     and batches, in three settings: the encoder frozen; the top layer of
     2 unfrozen; the whole encoder (``rest_scale = 1``).  Every dropout,
     LayerDrop and SpecAugment at 0 on both sides; 7680 samples (383
     frames: the port's block path, JAX's XLA attention, its trainer's
     default).  After each step: the loss and the gradients' global norm
     within 1e-4; the moments mu and nu within 1e-4 of max|ref| (the
     denominator floored at 1e-4 and 1e-9, the gradient tests' 1e-3 through
     (1 − b1)·g and (1 − b2)·g²), gradient-level parity of the whole step,
     as the port's gradient tests bound it (float32 sums in another order;
     optax clips as (g / ‖g‖)·c where K4 scales g·(c / ‖g‖)); the
     parameters within 1e-6 of max|ref| of optax fed the step's own
     gradients (gated as the JAX step gates them), as the fine-tune's test
     holds K4 (an Adam step normalizes each element, so a gradient that is
     zero analytically, as k_proj's bias is under the softmax, turns each
     side's roundoff into ±lr: the parameters of two steps that compute
     their own gradients cannot be compared tighter than lr); the frozen
     parameters bit-identical on both sides, their moments zero; the Adam
     count.
  2. ``ReduceLROnPlateau`` on one metric sequence, the unfreeze schedule,
     the class weights, the CCC loss (a batch of one included), the focal
     loss and ``validate_config`` against JAX's.
  3. A non-suffix trainable set is refused; the flat buffers are laid out
     rest, layers, heads, each group 16-byte aligned.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.config.config_utils import validate_config as jax_validate
from nrse_tpu.models.emotion import EmotionClassifier as JaxEmotionClassifier
from nrse_tpu.models.emotion import (
    gradually_unfrozen_layers as jax_unfrozen,
)
from nrse_tpu.models.emotion import layer_gradient_scale
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.train import emotion_trainer as jax_trainer
from nrse_tpu.train import losses as jax_losses
from nrse_tpu.train.schedules import (
    make_emotion_optimizer,
    set_injected_learning_rate,
)
from nrse_tpu_torch.config.config_utils import validate_config
from nrse_tpu_torch.models.convert import emotion_params_to_state_dict
from nrse_tpu_torch.models.emotion import (
    EmotionClassifier,
    gradually_unfrozen_layers,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import fused_optimizer
from nrse_tpu_torch.train import emotion_trainer as trainer
from nrse_tpu_torch.train import losses

torch.set_num_threads(1)

HIDDEN = 32
SAMPLES = 7680  # 383 tiny frames
WD = 1e-2
LRS = (1e-3, 5e-4)
OFF = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
           layerdrop=0.0, mask_time_prob=0.0)
WEIGHTS = np.array([1.0, 2.0, 0.5, 1.5, 1.0, 1.0, 0.8, 1.2], np.float32)
# (unfrozen layers, rest_scale)
SETTINGS = {"frozen": ([], 0.0), "top_layer": ([1], 0.0),
            "whole_encoder": ([0, 1], 1.0)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, b=3):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((b, SAMPLES))).astype(np.float32)
    mask = np.ones((b, SAMPLES), np.float32)
    mask[1, SAMPLES * 5 // 8:] = 0.0
    return {"input_values": x, "attention_mask": mask,
            "C": rng.integers(0, 8, b).astype(np.int32),
            "A": rng.uniform(1, 7, b).astype(np.float32),
            "V": rng.uniform(1, 7, b).astype(np.float32),
            "D": rng.uniform(1, 7, b).astype(np.float32)}


def _views(state, buf):
    """``{name: view of buf}`` in the parameters' layout."""
    base = state.params.data_ptr()
    out = {}
    for name, p in state.model.named_parameters():
        off = (p.data_ptr() - base) // 4
        out[name] = buf[off:off + p.numel()].view(p.shape)
    return out


def _frozen(name, layers, rest):
    if not name.startswith("encoder."):
        return False
    parts = name.split(".")
    if parts[2] == "layers" and not name.endswith("rel_attn_embed.weight"):
        return int(parts[3]) not in layers
    return not rest


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_two_train_steps_match_jax(setting):
    layers, rest = SETTINGS[setting]
    jcfg = JaxWavLMConfig.tiny(**OFF)
    jmodel = JaxEmotionClassifier(jcfg, hidden_dim=HIDDEN, dropout=0.0)
    opt = make_emotion_optimizer(LRS[0], weight_decay=WD)
    batches = [_batch(20 + i) for i in range(2)]
    jstate = jax_trainer.create_emotion_state(
        jmodel, jax.random.PRNGKey(0),
        jax.tree.map(jnp.asarray, batches[0]), opt)
    jstep = jax_trainer.make_emotion_train_step(jmodel, opt, "categorical",
                                                2)
    scale = layer_gradient_scale(2, layers)

    cfg = WavLMConfig.tiny(**OFF)
    model = EmotionClassifier(cfg, hidden_dim=HIDDEN, dropout=0.0)
    model.load_state_dict({
        k: torch.from_numpy(v) for k, v in emotion_params_to_state_dict(
            _np_tree(jstate.params), cfg).items()}, strict=True)
    state = trainer.create_emotion_state(model, seed=5)
    step = trainer.make_emotion_train_step("categorical", weight_decay=WD)
    p0 = {k: v.clone() for k, v in _views(state, state.params).items()}
    launches = fused_optimizer.LAUNCHES
    # optax on the flat buffers, fed the port's gradients, updates gated
    trainable = torch.zeros_like(state.params)
    for name, v in _views(state, trainable).items():
        v.fill_(0.0 if _frozen(name, layers, rest) else 1.0)
    trainable = jnp.asarray(trainable.numpy())
    ref_p = jnp.array(state.params.numpy(), copy=True)  # no shared memory
    ref_opt = opt.init(ref_p)

    for i, (batch, lr) in enumerate(zip(batches, LRS)):
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                                 jnp.asarray(WEIGHTS), scale,
                                 jnp.float32(lr), jnp.float32(rest))
        metrics = step(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                       torch.from_numpy(WEIGHTS), layers, lr, rest)
        assert state.step == i + 1
        set_injected_learning_rate(ref_opt, jnp.float32(lr))
        updates, ref_opt = opt.update(jnp.array(state.grads.numpy(),
                                                copy=True),
                                      ref_opt, ref_p)
        ref_p = ref_p + updates * trainable
        got, ref = state.params.numpy(), np.asarray(ref_p)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) \
            <= 1e-4 * abs(float(jmetrics["loss"]))
        assert abs(float(metrics["grad_norm"])
                   - float(jmetrics["grad_norm"])) \
            <= 1e-4 * float(jmetrics["grad_norm"])
        adam = jstate.opt_state[1].inner_state[0]
        assert int(adam.count) == i + 1
        jparams = emotion_params_to_state_dict(_np_tree(jstate.params), cfg)
        for name, g in _views(state, state.params).items():
            if _frozen(name, layers, rest):  # bit-identical on both sides
                np.testing.assert_array_equal(g.numpy(), p0[name].numpy())
                np.testing.assert_array_equal(jparams[name],
                                              p0[name].numpy(), name)
        for buf, floor in (("mu", 1e-4), ("nu", 1e-9)):
            ref = emotion_params_to_state_dict(
                _np_tree(getattr(adam, buf)), cfg)
            got = _views(state, getattr(state, buf))
            for name, r in ref.items():
                g = got[name].numpy()
                if _frozen(name, layers, rest):
                    assert not g.any() and not r.any(), name
                    continue
                err = np.abs(g - r).max() / max(np.abs(r).max(), floor)
                assert err <= 1e-4, f"step {i}, {buf} {name}: {err}"
    # the trainable part moved, one K4 update per step (its plain version
    # on the CPU launches nothing)
    moved = [n for n, v in _views(state, state.params).items()
             if not torch.equal(v, p0[n])]
    assert "categorical_out.weight" in moved
    assert "dimensional_out.weight" in moved  # decayed, never run
    assert ("encoder.encoder.layers.1.feed_forward.output_dense.weight"
            in moved) == (setting != "frozen")
    assert ("encoder.feature_extractor.conv_layers.0.conv.weight"
            in moved) == (setting == "whole_encoder")
    assert fused_optimizer.LAUNCHES == launches


def test_layout_is_rest_layers_heads_aligned():
    cfg = WavLMConfig.tiny()
    state = trainer.create_emotion_state(EmotionClassifier(cfg, HIDDEN))
    assert len(state.starts) == cfg.num_hidden_layers + 2
    assert all(s % trainer.ALIGN == 0 for s in state.starts)
    views = _views(state, state.params)
    offsets = {n: (state.model.get_parameter(n).data_ptr()
                   - state.params.data_ptr()) // 4 for n in views}
    table = "encoder.encoder.layers.0.attention.rel_attn_embed.weight"
    assert offsets[table] < state.starts[1]  # JAX keeps it outside layers
    assert state.starts[1] <= offsets[
        "encoder.encoder.layers.0.attention.q_proj.weight"] < state.starts[2]
    assert offsets["pooling.attention"] >= state.starts[-1]
    assert trainer.trainable_segments(state, [1]) == \
        [(state.starts[2], state.params.numel())]
    assert trainer.trainable_segments(state, [], 1.0) == \
        [(0, state.starts[1]), (state.starts[-1], state.params.numel())]
    assert not state.model.get_parameter(
        "encoder.encoder.layers.0.attention.q_proj.weight").requires_grad
    with pytest.raises(ValueError, match="top ones"):
        trainer.trainable_segments(state, [0])
    with pytest.raises(ValueError, match="rest_scale"):
        trainer.trainable_segments(state, [0, 1], 0.5)


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [0.1, 0.2, 0.2, 0.15, 0.19, 0.3, 0.1, 0.1, 0.1, 0.05, 0.4]
    for mode in ("max", "min"):
        ours = trainer.ReduceLROnPlateau(1e-3, mode=mode, patience=2,
                                         min_lr=1e-4)
        theirs = jax_trainer.ReduceLROnPlateau(1e-3, mode=mode, patience=2,
                                               min_lr=1e-4)
        assert [ours.step(m) for m in metrics] == \
            [theirs.step(m) for m in metrics]


def test_unfreeze_schedule_and_class_weights_match_jax():
    for total in (1, 3, 10):
        for layers in (2, 24):
            for e in range(total):
                assert gradually_unfrozen_layers(e, total, layers) == \
                    jax_unfrozen(e, total, layers)
    counts = {0: 5, 1: 1, 3: 12, 7: 40, 8: 3, -1: 2}
    np.testing.assert_array_equal(
        losses.compute_class_weights(counts, 8),
        jax_losses.compute_class_weights(counts, 8))


@pytest.mark.parametrize("n", [1, 2, 7])
def test_ccc_and_focal_losses_match_jax(n):
    rng = np.random.default_rng(n)
    p = rng.standard_normal((n, 3)).astype(np.float32)
    t = rng.uniform(1, 7, (n, 3)).astype(np.float32)
    ref = float(jax_losses.ccc_loss(jnp.asarray(p), jnp.asarray(t)))
    got = losses.ccc_loss(torch.from_numpy(p), torch.from_numpy(t))
    assert abs(float(got) - ref) <= 1e-6 * max(abs(ref), 1.0)
    if n == 1:
        assert float(got) == 0.0
    logits = rng.standard_normal((n, 8)).astype(np.float32)
    labels = rng.integers(0, 8, n).astype(np.int32)
    alpha = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    for a in (None, alpha):
        ref = float(jax_losses.focal_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            alpha=None if a is None else jnp.asarray(a)))
        got = float(losses.focal_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels), alpha=a))
        assert abs(got - ref) <= 1e-6 * max(abs(ref), 1.0)


@pytest.mark.parametrize("spelling", ["validataion_dataset_split",
                                      "validation_dataset_split"])
def test_validate_config_matches_jax(spelling):
    config = {"model": {"name": "wavlm-tiny"}, "training": {"seed": 3},
              "emotion": {"labels_file": "x.csv", spelling: "Development",
                          "train_dataset_split": "Train"}}
    ours = validate_config(copy.deepcopy(config))
    theirs = jax_validate(copy.deepcopy(config))
    assert ours.pop("device") == "cuda"  # never a probe
    theirs.pop("device")
    assert ours == theirs
    assert ours["emotion"]["validataion_dataset_split"] == "Development"
