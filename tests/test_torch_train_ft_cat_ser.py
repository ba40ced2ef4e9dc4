"""The port's baseline SER fine-tune (``nrse_tpu_torch.baseline.
train_ft_cat_ser``) against the JAX package's
(``nrse_tpu/baseline/train_ft_cat_ser.py``).

  1. The tiny ``BaselineSER`` in training mode at 8000 samples (399 frames:
     the flash attention, K5's plain forward and backward) with every
     dropout, LayerDrop and SpecAugment at 0: the weighted CE and every
     parameter's gradient (the bucket table ``rel_attn_embed`` and the head
     included) against ``jax.grad`` of the JAX trainer's ``loss_fn`` with
     ``use_flash_attention=True`` (its Pallas kernels in interpret mode),
     to 1e-4 of max|ref| with the denominator floored at 1e-3 as
     ``tests/test_flash_attention.py`` floors it (float32 sums in another
     order; gradients that are zero analytically are roundoff on both
     sides).
  2. Two micro-steps at k = 2, end to end and frozen: the parameters equal
     optax ``MultiSteps(adamw)`` fed the same gradients to 1e-6 of
     max|ref| (K4's plain version against optax's float32 arithmetic), the
     frozen encoder decayed by exactly ``1 − lr·wd``.
  3. The label CSV, class weights, corpus norm stats and crops equal the
     JAX trainer's on the same corpus and numpy generators.
  4. ``main`` on the CPU (``--device cpu``) on the tiny corpus of
     ``tests/test_baseline_e2e.py`` with the CSV written by the ``csv``
     module: it writes ``final_model`` and ``train_norm_stat.pkl``, and
     the evaluator scores every dev file with that model; without
     ``--device`` it asks for the card and raises where there is none.
  5. ``--byol_checkpoint`` starts the encoder from a BYOL checkpoint of
     the port's ``train_byol``.
  6. The staged micro-step (its host draws, K4's scalars and MultiSteps'
     divisor written to one staging first) equals the micro-step before
     staging (a copy of its code here) bit for bit over 8 micro-steps at
     k = 4 (two K4 updates), end to end and frozen, with every random
     feature on and a layer dropped among them; the staged head masks are
     ``EmotionRegression``'s own draw; the dev loss through the dev
     step's program cache equals the eager one.
"""

import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nrse_tpu.baseline.train_ft_cat_ser as jax_trainer
from nrse_tpu.baseline.pipeline import BaselineSER as JaxBaselineSER
from nrse_tpu.baseline.wavset import WavNormStats as JaxWavNormStats
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.train.losses import ce_weight_category as jax_ce
from nrse_tpu_torch.audio.io import save_wav
from nrse_tpu_torch.baseline import eval_cat_ser
from nrse_tpu_torch.baseline import train_ft_cat_ser as trainer
from nrse_tpu_torch.baseline.pipeline import BaselineSER
from nrse_tpu_torch.labels.parsing import BASELINE_EMOTIONS_MAP
from nrse_tpu_torch.models.convert import (
    baseline_params_to_state_dict,
    init_baseline_state_dict,
    init_byol_state_dict,
)
from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMConfig
from nrse_tpu_torch.ops import flash_attention
from nrse_tpu_torch.ops.fused_optimizer import fused_adamw_ema_update
from nrse_tpu_torch.train.byol_trainer import create_train_state
from nrse_tpu_torch.train.checkpoint import load_byol_encoder, save_checkpoint
from nrse_tpu_torch.train.losses import ce_weight_category
from torch_init import with_random_biases

torch.set_num_threads(1)

HEAD_DIM = 32
SAMPLES = 8000  # 399 tiny frames: above the block kernel's 384
OFF = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
           layerdrop=0.0, mask_time_prob=0.0)
WEIGHTS = np.array([1.0, 2.0, 0.5, 1.5, 1.0, 1.0, 0.8, 1.2], np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, b=2, samples=SAMPLES):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((b, samples))).astype(np.float32)
    mask = np.ones((b, samples), np.float32)
    mask[1, samples * 5 // 8:] = 0.0
    labels = rng.integers(0, 8, b).astype(np.int32)
    return x, mask, labels


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny ``BaselineSER`` on its flash attention, random features
    and the head's dropout off, and the port's on the same weights."""
    jmodel = JaxBaselineSER(
        JaxWavLMConfig.tiny(use_flash_attention=True, **OFF),
        head_dim=HEAD_DIM, dropout=0.0)
    params = JaxBaselineSER(JaxWavLMConfig.tiny(**OFF), head_dim=HEAD_DIM,
                            dropout=0.0).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
        jnp.ones((1, 4000)))["params"]
    cfg = WavLMConfig.tiny(**OFF)
    model = BaselineSER(cfg, head_dim=HEAD_DIM, dropout=0.0)
    model.load_state_dict({
        k: torch.from_numpy(v) for k, v in
        baseline_params_to_state_dict(_np_tree(params), cfg).items()},
        strict=True)
    return jmodel, params, model, cfg


def test_loss_and_gradients_match_jax_at_t_over_384(tiny_pair):
    jmodel, params, model, cfg = tiny_pair
    assert int(cfg.feature_lengths(SAMPLES)) == 399
    x, mask, labels = _batch(1)
    w = jnp.asarray(WEIGHTS)

    def loss_fn(params, batch, rng):  # the JAX trainer's
        logits = jmodel.apply(
            {"params": params}, batch["input_values"],
            batch["attention_mask"], deterministic=False,
            rngs={"dropout": rng, "layerdrop": jax.random.fold_in(rng, 1),
                  "spec_augment": jax.random.fold_in(rng, 2)})
        return jax_ce(logits, batch["label"], w)

    jbatch = {"input_values": jnp.asarray(x),
              "attention_mask": jnp.asarray(mask),
              "label": jnp.asarray(labels)}
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(
        params, jbatch, jax.random.PRNGKey(3))
    ref = baseline_params_to_state_dict(_np_tree(ref_grads), cfg)

    model.train()
    model.zero_grad()
    before = (flash_attention.LAUNCHES, flash_attention.DQ_LAUNCHES)
    logits = model(torch.from_numpy(x), torch.from_numpy(mask),
                   TrainRNG(7, 0).with_table(cfg.num_hidden_layers, "cpu"))
    loss = ce_weight_category(logits, torch.from_numpy(labels),
                              torch.from_numpy(WEIGHTS))
    loss.backward()
    assert (flash_attention.LAUNCHES, flash_attention.DQ_LAUNCHES) == before
    ref_loss = float(ref_loss)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-4 * abs(ref_loss)
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    assert "ssl.encoder.layers.0.attention.rel_attn_embed.weight" in ref
    for name, r in ref.items():
        g = grads[name].grad.numpy()
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-3)
        assert err < 1e-4, f"{name}: {err}"


def _optax_params(p0, grads, lr, k):
    opt = optax.MultiSteps(optax.adamw(lr), every_k_schedule=k)
    p = jnp.asarray(p0)
    state = opt.init(p)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
    return np.asarray(p)


@pytest.mark.parametrize("freeze_ssl", [False, True])
def test_two_micro_steps_match_optax_multisteps(freeze_ssl):
    lr, k = 0.1, 2  # a large lr: the frozen decay 1 − lr·wd shows at 1e-5
    cfg = WavLMConfig.tiny(**OFF)
    model = BaselineSER(cfg, head_dim=HEAD_DIM)  # head dropout 0.5, seeded
    model.load_state_dict(with_random_biases(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(0), head_dim=HEAD_DIM), 0))
    state = trainer.create_train_state(model)
    step = trainer.make_train_step(trainer.adamw_spec(lr), k, freeze_ssl,
                                   torch.from_numpy(WEIGHTS))
    p0 = state.params.clone()
    grads = []
    for i in range(k):
        x, mask, labels = _batch(10 + i)
        batch = {"input_values": torch.from_numpy(x),
                 "attention_mask": torch.from_numpy(mask),
                 "label": torch.from_numpy(labels)}
        loss = step(state, batch, TrainRNG(5, i))
        assert torch.isfinite(loss)
        grads.append(state.grads.clone())
    assert (state.mini_step, state.count) == (0, 1)
    ssl = slice(0, state.n_ssl)
    if freeze_ssl:  # the JAX trainer zeroes them; here no graph reaches ssl
        assert all(float(g[ssl].abs().max()) == 0.0 for g in grads)
    else:
        assert all(float(g[ssl].abs().max()) > 0.0 for g in grads)
    ref = _optax_params(p0.numpy(), [g.numpy() for g in grads], lr, k)
    got = state.params.numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert not np.array_equal(got, p0.numpy())
    if freeze_ssl:  # decoupled decay alone: p · (1 − lr · wd)
        want = p0[ssl] * (1.0 - lr * 1e-4)
        assert float((state.params[ssl] - want).abs().max()) \
            <= 1e-6 * float(want.abs().max())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny corpus of tests/test_baseline_e2e.py: 16 WAVs of 0.5–1.5 s,
    10 train and 6 dev, a one-hot CSV written by the csv module, the
    config JSON and the dev label list."""
    rng = np.random.default_rng(42)
    root = tmp_path_factory.mktemp("ft_cat_ser")
    wav_dir = root / "Audios"
    wav_dir.mkdir()
    sr = 16000
    columns = list(BASELINE_EMOTIONS_MAP)
    rows, list_lines = [], []
    for i, c in enumerate(["A", "S", "H", "N"] * 4):
        name = f"MSP-PODCAST_{3000 + i}_{i:04d}.wav"
        t = np.arange(int(sr * rng.uniform(0.5, 1.5))) / sr
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(90, 350) * t)
        x += 0.05 * rng.standard_normal(t.shape)
        save_wav(str(wav_dir / name), x.astype(np.float32), sr)
        rows.append([name] + [1.0 if k == c else 0.0 for k in columns]
                    + ["Train" if i < 10 else "Development"])
        if i >= 10:
            list_lines.append(f"Audios/{name}; {c}; A:4.0; V:4.0; D:4.0;\n")
    with open(root / "labels_onehot.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["FileName"] + columns + ["Split_Set"])
        writer.writerows(rows)
    (root / "eval_list.txt").write_text("".join(list_lines))
    (root / "config.json").write_text(json.dumps({
        "wav_dir": str(wav_dir),
        "label_path": str(root / "labels_onehot.csv")}))
    return root


def test_labels_weights_stats_and_crops_match_jax(corpus):
    label_path = str(corpus / "labels_onehot.csv")
    wav_dir = str(corpus / "Audios")
    for split in ("Train", "Development", None):
        files, labels = trainer.load_onehot_labels(label_path, split)
        ref_files, ref_labels = jax_trainer.load_onehot_labels(label_path,
                                                               split)
        assert files == ref_files
        np.testing.assert_array_equal(labels, ref_labels)
    files, labels = trainer.load_onehot_labels(label_path, "Train")
    assert len(files) == 10
    np.testing.assert_array_equal(
        trainer.class_weights_from_onehot(labels),
        jax_trainer.class_weights_from_onehot(labels))

    stats = trainer.corpus_norm_stats(wav_dir, files, seed=7)
    rng = np.random.default_rng(7)  # the JAX trainer's inline computation
    ref = JaxWavNormStats.from_waveforms(
        w[0] for w in (jax_trainer._load_wav(os.path.join(wav_dir, f),
                                             10 ** 9, rng)
                       for f in files[:2000]) if w is not None)
    assert (stats.mean, stats.std) == (ref.mean, ref.std)

    # 0.8 s crops: the clips of 0.5–1.5 s longer than that take a draw
    ours = trainer.BaselineWavDataset(wav_dir, files, labels, stats, 0.8)
    theirs = jax_trainer.BaselineWavDataset(wav_dir, files, labels, ref, 0.8)
    cropped = 0
    for i in range(len(files)):
        a = ours.sample(i, np.random.default_rng((3, i)))
        b = theirs.sample(i, np.random.default_rng((3, i)))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        cropped += int(a["attention_mask"].all())
    assert 0 < cropped < len(files)


def test_main_trains_and_the_evaluator_scores_its_model(corpus):
    model_path = str(corpus / "model")
    result = trainer.main([
        "--config", str(corpus / "config.json"), "--model_path", model_path,
        "--epochs", "1", "--batch_size", "4", "--accumulation_steps", "2",
        "--lr", "1e-4", "--freeze_ssl", "false", "--head_dim",
        str(HEAD_DIM), "--model_name", "wavlm-tiny", "--max_seconds", "1.0",
        "--device", "cpu"])
    (epoch,) = result["epochs"]
    assert epoch["steps"] == 2 and result["state"].count == 1
    assert np.isfinite(epoch["train_loss"]) and \
        np.isfinite(result["best_dev_loss"])
    assert os.path.isfile(os.path.join(model_path, "final_model",
                                       "state.pt"))
    assert os.path.isfile(os.path.join(model_path, "train_norm_stat.pkl"))
    with open(os.path.join(model_path, "final_model", "meta.json")) as f:
        assert json.load(f) == {"epoch": 0,
                                "dev_loss": result["best_dev_loss"],
                                "freeze_ssl": False}

    metrics, scored = eval_cat_ser.run_inference(
        model_path, str(corpus / "eval_list.txt"), str(corpus),
        batch_size=2, head_dim=HEAD_DIM, model_name="wavlm-tiny",
        device="cpu")
    assert metrics["n_files"] == metrics["n_scored"] == 6
    assert all(np.isfinite(logit).all() for _, logit in scored)


def test_main_defaults_to_the_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.main(["--config", str(corpus / "config.json"),
                      "--model_path", str(corpus / "unused"),
                      "--model_name", "wavlm-tiny"])


def test_byol_checkpoint_starts_the_encoder(corpus, tmp_path):
    cfg = WavLMConfig.tiny()
    byol = create_train_state(
        cfg, with_random_biases(init_byol_state_dict(
            cfg, 16, 32, torch.Generator().manual_seed(4)), 4),
        16, 32, "cpu")
    save_checkpoint(str(tmp_path), "best_val_loss", byol)
    path = str(tmp_path / "best_val_loss")
    want = byol.online.encoder.state_dict()
    got = load_byol_encoder(path, cfg)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="online parameters"):
        load_byol_encoder(path, dataclasses.replace(cfg, num_hidden_layers=1))

    result = trainer.train(
        str(corpus / "config.json"), str(tmp_path / "model"), epochs=0,
        head_dim=HEAD_DIM, byol_checkpoint=path, model_name="wavlm-tiny",
        max_seconds=1.0, num_workers=2, device="cpu")
    ssl = result["state"].model.ssl.state_dict()
    assert all(torch.equal(ssl[k], want[k]) for k in want)


FEATURES = dict(num_hidden_layers=4, layerdrop=0.3)  # drops a layer in 8


def _features_state():
    """A tiny fine-tune state with every random feature on: the encoder's
    dropouts, LayerDrop over 4 layers, SpecAugment, the head's dropout."""
    cfg = dataclasses.replace(WavLMConfig.tiny(), **FEATURES)
    model = BaselineSER(cfg, head_dim=HEAD_DIM)
    model.load_state_dict(with_random_biases(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(2), head_dim=HEAD_DIM), 2))
    return trainer.create_train_state(model)


def _micro_step_before(state, batch, rng, spec, k, freeze_ssl, weights):
    """The micro-step as it ran before staging: the model draws inline
    from a TrainRNG with a table of its own, MultiSteps divides by the
    integer n + 1 and K4 builds its scalars from the count."""
    rng = rng.with_table(state.model.encoder_config.num_hidden_layers,
                         "cpu")
    state.grads.zero_()
    logits = trainer.forward_train(state.model, batch, rng, freeze_ssl)
    loss = ce_weight_category(logits, batch["label"], weights)
    loss.backward()
    with torch.no_grad():
        n = state.mini_step
        state.acc.add_((state.grads - state.acc) / (n + 1))
        if n == k - 1:
            fused_adamw_ema_update(state.acc, state.params, state.mu,
                                   state.nu, None, spec, state.count)
            state.count += 1
            state.acc.zero_()
        state.mini_step = (n + 1) % k
    return loss.detach()


@pytest.mark.parametrize("freeze_ssl", [False, True],
                         ids=["e2e", "frozen"])
def test_staged_micro_step_is_the_micro_step_before_staging(freeze_ssl):
    k, spec = 4, trainer.adamw_spec(1e-3)
    staged, before = _features_state(), _features_state()
    weights = torch.from_numpy(WEIGHTS)
    step = trainer.make_train_step(spec, k, freeze_ssl, weights)
    dropped = False
    for i in range(2 * k):
        x, mask, labels = _batch(20 + i)
        batch = {"input_values": torch.from_numpy(x),
                 "attention_mask": torch.from_numpy(mask),
                 "label": torch.from_numpy(labels)}
        keep = staged.model.ssl.encoder.layer_keep(TrainRNG(9, i))
        dropped |= not all(keep)
        loss = step(staged, batch, TrainRNG(9, i))
        want = _micro_step_before(before, batch, TrainRNG(9, i), spec, k,
                                  freeze_ssl, weights)
        assert staged.model.ssl.encoder.layers_run == sum(keep)
        assert torch.equal(loss, want), i
        for name in ("params", "grads", "acc", "mu", "nu"):
            assert torch.equal(getattr(staged, name),
                               getattr(before, name)), (i, name)
        assert (staged.mini_step, staged.count) == \
            (before.mini_step, before.count)
    assert dropped and staged.count == 2
    assert float(staged.acc.abs().max()) == 0.0  # zeroed by the update


def test_staged_head_masks_are_the_heads_own_draw():
    cfg = WavLMConfig.tiny()
    model = BaselineSER(cfg, head_dim=HEAD_DIM, head_layers=2)
    head = model.ser.train()
    x = torch.randn(3, 2 * cfg.hidden_size,
                    generator=torch.Generator().manual_seed(0))
    rng = TrainRNG(11, 5)
    keep = head.head_keep(rng, 3)
    assert keep.shape == (2, 3, HEAD_DIM) and keep.dtype == torch.bool
    assert 0 < int(keep.sum()) < keep.numel()
    with torch.no_grad():
        assert torch.equal(head(x, rng, keep), head(x, rng))
        assert not torch.equal(head(x, rng, keep), head(x, TrainRNG(11, 6)))


def test_dev_loss_through_its_program_is_the_eager_one(corpus):
    cfg = WavLMConfig.tiny()
    model = BaselineSER(cfg, head_dim=HEAD_DIM)
    model.load_state_dict(with_random_biases(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(3), head_dim=HEAD_DIM), 3))
    files, labels = trainer.load_onehot_labels(
        str(corpus / "labels_onehot.csv"), "Development")
    stats = trainer.corpus_norm_stats(str(corpus / "Audios"), files, 7)
    # 2 s: no clip is cropped, so both passes see the same batches
    ds = trainer.BaselineWavDataset(str(corpus / "Audios"), files, labels,
                                    stats, 2.0)
    loader = trainer.HostDataLoader(ds, np.arange(len(ds)), 4,
                                    shuffle=False, seed=7, num_workers=0,
                                    drop_last=False)
    w = torch.from_numpy(WEIGHTS)
    programs = trainer.make_baseline_forward(model, graphs=True)
    model.train()
    got = trainer.dev_loss(model, loader, "cpu", w, programs)
    assert model.training  # the train step finds its mode again
    assert got == trainer.dev_loss(model, loader, "cpu", w)
    assert np.isfinite(got)
    assert list(programs.programs) == [((4, 32000), (4, 32000))]
