"""The port's data-parallel SER pieces against the JAX package on the
global batch, and pooled validation against one rank.

  1. The weighted cross-entropy and the CCC loss at 2 gloo ranks: the
     ranks' parts add up to JAX's loss on the global batch of 6 (one label
     invalid, on rank 1) and each rank's gradient at its rows is JAX's
     gradient there (1e-6 of the largest value: float32 sums in another
     order).
  2. The SER train step (``task="categorical"``, class weights, weight
     decay 1e-2, two steps at lr 1e-3 then 5e-4) at 2 ranks × 2 rows
     against ``nrse_tpu/train/emotion_trainer.py::make_emotion_train_step``
     on the global batch of 4, frozen and with the top layer unfrozen, at
     ``tests/test_torch_emotion_trainer.py::test_two_train_steps_match_jax``'s
     tolerances: the loss and grad_norm within 1e-4, mu and nu within 1e-4
     of max|ref| (floors 1e-4 and 1e-9), the parameters within 1e-6 of
     max|ref| of optax fed the ranks' summed gradients, the frozen
     parameters bit-identical; the two ranks' buffers bit-equal.
  3. The metrics the trainers now take from pooled sums equal the array
     metrics they took before: macro-F1 and the report from a confusion
     matrix equal ``eval.metrics``' ``f1_scores`` and
     ``classification_report`` exactly; the CCC from moments equals
     ``compute_ccc`` to 1e-9 (float64, one pass against two).
  4. Pooled validation: the categorical and dimensional validations of
     the SER trainers over 2 ranks, on three global batches of 4 (the last
     padded, 3 real rows: 2 on rank 0, 1 on rank 1), equal one process's
     on the same batches: the confusion matrix and the report exactly,
     macro-F1, the CCCs and the losses to 1e-6 (pooled float64 moments
     against one process's); and over 4 ranks at ``{data: 2, model: 2}``.
  5. The step of 2. over 4 ranks at ``{data: 2, model: 2}`` (the model axis
     replicates the classifier, as JAX runs it) against JAX's step on the
     batch and state its ``make_batch_placer`` places on a 2 x 2 mesh of
     the 8 virtual CPU devices, at the same tolerances; all four ranks
     bit-equal; the one checkpoint rank 0 writes restores into a one-process
     state.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.emotion import EmotionClassifier as JaxEmotionClassifier
from nrse_tpu.models.emotion import layer_gradient_scale
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.train import emotion_trainer as jax_trainer
from nrse_tpu.train import losses as jax_losses
from nrse_tpu.train.schedules import (
    make_emotion_optimizer,
    set_injected_learning_rate,
)
from nrse_tpu_torch.eval import metrics
from nrse_tpu_torch.models.convert import emotion_params_to_state_dict
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.parallel.launch import run_ranks
from nrse_tpu_torch.train import checkpoint as trainer_ckpt
from nrse_tpu_torch.train import emotion_trainer as trainer
from nrse_tpu_torch.train import losses

import torch_dp_workers as workers
from test_torch_emotion_trainer import (
    HIDDEN,
    LRS,
    OFF,
    SETTINGS,
    WD,
    WEIGHTS,
    _batch,
    _frozen,
    _np_tree,
    _views,
)

torch.set_num_threads(1)


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def test_losses_and_gradients_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 8)).astype(np.float32)
    labels = rng.integers(0, 8, 6).astype(np.int32)
    labels[4] = -1  # invalid, on rank 1
    preds = rng.standard_normal((6, 3)).astype(np.float32)
    targets = rng.uniform(1, 7, (6, 3)).astype(np.float32)
    outs = run_ranks(workers.loss_gradients, 2,
                     (logits, labels, WEIGHTS, preds, targets))

    def ce(x):
        return jax_losses.ce_weight_category(x, jnp.asarray(labels),
                                             jnp.asarray(WEIGHTS))

    def ccc(p):
        return jax_losses.ccc_loss(p, jnp.asarray(targets))

    for fn, x, key in ((ce, logits, "ce"), (ccc, preds, "ccc")):
        loss, grad = jax.value_and_grad(fn)(jnp.asarray(x))
        _close(sum(o[key] for o in outs), float(loss))
        _close(np.concatenate([o[f"{key}_grad"] for o in outs]),
               np.asarray(grad))


@pytest.mark.parametrize("setting", ["frozen", "top_layer"])
def test_two_dp_train_steps_match_jax(setting):
    _check_steps_against_jax(setting, data=2, model=1)


@pytest.mark.parametrize("setting", ["frozen", "top_layer"])
def test_two_steps_on_a_model_axis_match_jax(setting, tmp_path):
    """Four ranks at ``{data: 2, model: 2}``: the classifier replicated
    over each model group, as JAX's ``make_batch_placer`` replicates the
    state over a 2 x 2 mesh (the reference's batch and state placed by
    it); the ranks of each model group bit-equal, and one checkpoint,
    written by rank 0, restored into a ``model: 1`` state."""
    ranks, state = _check_steps_against_jax(setting, data=2, model=2,
                                            ckpt_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["best_classifier_model"]
    trainer_ckpt.restore_checkpoint(str(tmp_path), "best_classifier_model",
                                    state)
    for k in ("params", "mu", "nu"):
        np.testing.assert_array_equal(getattr(state, k).numpy(),
                                      ranks[0][-1][k], k)
    assert state.step == 2


def _check_steps_against_jax(setting, data, model, ckpt_dir=None):
    """Two SER steps at ``data x model`` gloo ranks against JAX's step on
    the global batch; returns the ranks' results and the one-process
    state at step 0 that gave the layout."""
    layers, rest = SETTINGS[setting]
    jcfg = JaxWavLMConfig.tiny(**OFF)
    jmodel = JaxEmotionClassifier(jcfg, hidden_dim=HIDDEN, dropout=0.0)
    opt = make_emotion_optimizer(LRS[0], weight_decay=WD)
    batches = [_batch(20 + i, b=4) for i in range(2)]
    jstate = jax_trainer.create_emotion_state(
        jmodel, jax.random.PRNGKey(0),
        jax.tree.map(jnp.asarray, batches[0]), opt)
    jstep = jax_trainer.make_emotion_train_step(jmodel, opt, "categorical",
                                                2)
    place_batch = lambda b: jax.tree.map(jnp.asarray, b)  # noqa: E731
    if model > 1:
        place_batch, place_state = jax_trainer.make_batch_placer(
            {"tpu": {"mesh": {"data": data, "model": model}}}, 4)
        jstate = place_state(jstate)
    scale = layer_gradient_scale(2, layers)
    cfg = WavLMConfig.tiny(**OFF)
    sd = emotion_params_to_state_dict(_np_tree(jstate.params), cfg)
    model_t = EmotionClassifier(cfg, hidden_dim=HIDDEN, dropout=0.0)
    model_t.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                            strict=True)
    state = trainer.create_emotion_state(model_t, seed=5)  # the layout
    p0 = {k: v.clone() for k, v in _views(state, state.params).items()}
    ranks = run_ranks(workers.emotion_steps, data * model, (
        sd, HIDDEN, "categorical", batches, WEIGHTS, layers, rest, LRS, WD,
        model, ckpt_dir))

    trainable = torch.zeros_like(state.params)
    for name, v in _views(state, trainable).items():
        v.fill_(0.0 if _frozen(name, layers, rest) else 1.0)
    trainable = jnp.asarray(trainable.numpy())
    ref_p = jnp.array(state.params.numpy(), copy=True)
    ref_opt = opt.init(ref_p)
    for i, (batch, lr) in enumerate(zip(batches, LRS)):
        jstate, jm = jstep(jstate, place_batch(batch),
                           jnp.asarray(WEIGHTS), scale, jnp.float32(lr),
                           jnp.float32(rest))
        got = ranks[0][i]
        for other in ranks[1:]:  # model replicas and data ranks alike
            for k in ("grads", "params", "mu", "nu"):
                np.testing.assert_array_equal(got[k], other[i][k], k)
            assert got["loss"] == other[i]["loss"]
        assert abs(got["loss"] - float(jm["loss"])) \
            <= 1e-4 * abs(float(jm["loss"]))
        assert abs(got["grad_norm"] - float(jm["grad_norm"])) \
            <= 1e-4 * float(jm["grad_norm"])
        set_injected_learning_rate(ref_opt, jnp.float32(lr))
        updates, ref_opt = opt.update(jnp.asarray(got["grads"]), ref_opt,
                                      ref_p)
        ref_p = ref_p + updates * trainable
        ref = np.asarray(ref_p)
        assert np.abs(got["params"] - ref).max() <= 1e-6 * np.abs(ref).max()
        adam = jstate.opt_state[1].inner_state[0]
        params = _views(state, torch.from_numpy(got["params"]))
        for name, g in params.items():
            if _frozen(name, layers, rest):
                np.testing.assert_array_equal(g.numpy(), p0[name].numpy())
        for buf, floor in (("mu", 1e-4), ("nu", 1e-9)):
            refs = emotion_params_to_state_dict(
                _np_tree(getattr(adam, buf)), cfg)
            views = _views(state, torch.from_numpy(got[buf]))
            for name, r in refs.items():
                g = views[name].numpy()
                if _frozen(name, layers, rest):
                    assert not g.any() and not r.any(), name
                    continue
                err = np.abs(g - r).max() / max(np.abs(r).max(), floor)
                assert err <= 1e-4, f"step {i}, {buf} {name}: {err}"
    return ranks, state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_from_sums_equal_array_metrics(seed):
    rng = np.random.default_rng(seed)
    n = 40 + seed
    labels = rng.integers(0, 8 - 2 * seed, n)  # classes absent too
    preds = np.where(rng.uniform(size=n) < 0.5, labels,
                     rng.integers(0, 8, n))
    classes = list(range(8))
    names = [f"c{i}" for i in classes]
    cm = metrics.confusion_matrix(labels, preds, classes)
    assert metrics.macro_f1_from_confusion(cm) == \
        metrics.f1_scores(labels, preds)["macro"]
    assert metrics.report_from_confusion(cm, names) == \
        metrics.classification_report(labels, preds, classes, names)
    p = rng.standard_normal((n, 3)) * 0.7 + 4
    t = p * 0.5 + rng.uniform(1, 7, (n, 3))
    got = losses.ccc_from_moments(losses.ccc_moments(p, t))
    want = [losses.compute_ccc(p[:, i], t[:, i]) for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def _val_batches():
    rng = np.random.default_rng(7)
    batches = []
    for count in (4, 4, 3):
        b = {"logits": rng.standard_normal((4, 8)).astype(np.float32),
             "dims": rng.uniform(1, 7, (4, 3)).astype(np.float32),
             "C": rng.integers(0, 8, 4).astype(np.int32),
             "A": rng.uniform(1, 7, 4).astype(np.float32),
             "V": rng.uniform(1, 7, 4).astype(np.float32),
             "D": rng.uniform(1, 7, 4).astype(np.float32),
             "__count__": np.asarray(count, np.int32)}
        batches.append(b)
    batches[0]["C"][1] = -1  # an invalid label, on rank 0
    return batches


def test_pooled_validation_equals_one_rank():
    _check_pooled_validation(2, 1)


def test_pooled_validation_on_a_model_axis_equals_one_rank():
    """At ``{data: 2, model: 2}`` the validation pools over the data
    group: the replicas of a model group count their rows once."""
    _check_pooled_validation(4, 2)


def _check_pooled_validation(world, model):
    batches = _val_batches()
    one = workers.pooled_validation(0, 1, batches, 4, WEIGHTS)
    outs = run_ranks(workers.pooled_validation, world,
                     (batches, 4, WEIGHTS, model))
    assert one["cm"].sum() == 10  # 11 real rows, one label invalid
    for out in outs:
        np.testing.assert_array_equal(out["cm"], one["cm"])
        assert out["report"] == one["report"]
        for key in ("f1", "ce", "ccc_loss"):
            _close(out[key], one[key])
        for dim, v in one["ccc"].items():
            _close(out["ccc"][dim], v)
