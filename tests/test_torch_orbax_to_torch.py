"""``tools/orbax_to_torch.py``: JAX orbax checkpoints into the port's
checkpoint layout, on the CPU.

  1. A tiny JAX ``train_byol`` state (``create_train_state`` with the
     optax AdamW chain, its moments filled from a numpy seed so that the
     conversion has something to move) saved through
     ``nrse_tpu/train/checkpoint.py::save_checkpoint``, converted, and
     restored by the port's ``restore_checkpoint`` into a state of other
     weights: the online tower's pooled output and projector output within
     1e-4 of max|ref| of JAX's forward on the saved variables; the target
     encoder's the same; ``mu`` and ``nu`` the converter's layout of JAX's
     moments bit for bit; the Adam count carried; ``load_byol_encoder``
     reads the result.
  2. A tiny JAX baseline ``final_model`` converted to the port's
     ``save_model`` layout: ``BaselineSER``'s logits within 1e-4 of
     max|ref| of JAX's.
  3. A tiny JAX ``EmotionTrainState`` (``inject_hyperparams(adamw)``)
     converted to the port's: the classifier's logits and A/V/D within
     1e-4 of max|ref| of JAX's, the Adam count and zero moments carried.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.baseline.pipeline import BaselineSER as JaxBaselineSER
from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.emotion import EmotionClassifier as JaxClassifier
from nrse_tpu.models.heads import ProjectionHead as JaxProjectionHead
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.train import checkpoint as jax_checkpoint
from nrse_tpu.train.byol_trainer import create_train_state as jax_state
from nrse_tpu.train.emotion_trainer import create_emotion_state as jes
from nrse_tpu.train.schedules import (
    make_byol_optimizer,
    make_emotion_optimizer,
)
from nrse_tpu_torch.baseline.pipeline import BaselineSER
from nrse_tpu_torch.models.convert import (
    byol_variables_to_state_dicts,
    init_byol_state_dict,
    init_emotion_state_dict,
)
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train.byol_trainer import create_train_state
from nrse_tpu_torch.train.emotion_trainer import create_emotion_state
from nrse_tpu_torch.train.checkpoint import (
    load_byol_encoder,
    restore_checkpoint,
    restore_model,
)
from torch_init import with_random_biases

torch.set_num_threads(1)

TOL = 1e-4
PROJ, PRED = 16, 32
T = 7680

_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch",
    Path(__file__).resolve().parent.parent / "tools" / "orbax_to_torch.py")
orbax_to_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_torch)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12)


def _audio(seed=0):
    return (0.2 * np.random.default_rng(seed).standard_normal((2, T))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    model = BYOLSpeechModel({"model": {"projection_dim": PROJ,
                                       "prediction_dim": PRED,
                                       "ema_decay": 0.99}},
                            encoder_config=JaxConfig.tiny())
    state = jax_state(model, jax.random.PRNGKey(0), jnp.zeros((1, T)),
                      make_byol_optimizer(1e-4, total_steps=10))
    rng = np.random.default_rng(1)

    def fill(tree):  # moments off zero, nu positive
        return jax.tree.map(lambda x: jnp.asarray(
            np.abs(rng.standard_normal(x.shape)).astype(x.dtype)), tree)

    chain = list(state.opt_state)
    adam = chain[1][0]
    chain[1] = (adam._replace(count=jnp.asarray(7, adam.count.dtype),
                              mu=fill(adam.mu), nu=fill(adam.nu)),
                *chain[1][1:])
    state = state.__class__(variables=state.variables,
                            opt_state=tuple(chain),
                            step=jnp.asarray(7, jnp.int32), rng=state.rng)
    jax_checkpoint.save_checkpoint(str(root / "jax"), "last_model", state,
                                   {"epoch": 4})
    kind = orbax_to_torch.convert(str(root / "jax" / "last_model"),
                                  str(root / "port" / "last_model"),
                                  "wavlm-tiny", seed=11)
    return root, model, state, kind


def test_byol_state_converts(converted):
    root, model, jstate, kind = converted
    assert kind == "byol"
    cfg = WavLMConfig.tiny()
    fresh = create_train_state(
        cfg, with_random_biases(init_byol_state_dict(
            cfg, PROJ, PRED, torch.Generator().manual_seed(99)), 99),
        PROJ, PRED, "cpu")
    state, meta = restore_checkpoint(str(root / "port"), "last_model", fresh)
    assert meta == {"epoch": 4} and (state.step, state.seed) == (7, 11)

    variables = jstate.variables
    x = _audio()
    _, ref_pooled = model.encode(variables, jnp.asarray(x),
                                 deterministic=True)
    ref_proj = JaxProjectionHead(PROJ, PROJ).apply(
        {"params": variables.online["params"]["projector"],
         "batch_stats": variables.online["batch_stats"]["projector"]},
        ref_pooled, use_running_average=True)
    state.online.eval()
    state.target.eval()
    with torch.no_grad():
        _, pooled = state.online.encoder(torch.from_numpy(x))
        proj = state.online.projector(pooled)
        _, target_pooled = state.target.encoder(torch.from_numpy(x))
    assert _rel(pooled.numpy(), ref_pooled) < TOL
    assert _rel(proj.numpy(), ref_proj) < TOL
    assert _rel(target_pooled.numpy(), ref_pooled) < TOL  # a copy at init

    adam = jstate.opt_state[1][0]
    stats = variables.online["batch_stats"]
    for name in ("mu", "nu"):
        moment, _ = byol_variables_to_state_dicts(
            jax.tree.map(np.asarray, {
                "online": {"params": getattr(adam, name),
                           "batch_stats": stats},
                "target": variables.target}), cfg)
        flat = torch.cat([torch.from_numpy(moment[k]).reshape(-1)
                          for k, _ in state.online.named_parameters()])
        assert torch.equal(getattr(state, name), flat), name
        assert bool((getattr(state, name) != 0).any())

    enc = load_byol_encoder(str(root / "port" / "last_model"), cfg)
    for k, v in state.online.encoder.state_dict().items():
        if k in enc:
            assert torch.equal(enc[k], v), k


def test_baseline_final_model_converts(tmp_path):
    jcfg = JaxConfig.tiny(layerdrop=0.0)
    model = JaxBaselineSER(jcfg, head_dim=24, head_layers=2)
    x = _audio(3)
    mask = np.ones((2, T), np.int32)
    mask[1, T // 2:] = 0
    params = model.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x),
                        jnp.asarray(mask))["params"]
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), "final_model",
                                   {"params": params})
    kind = orbax_to_torch.convert(str(tmp_path / "jax" / "final_model"),
                                  str(tmp_path / "port" / "final_model"),
                                  "wavlm-tiny")
    assert kind == "baseline"
    port = BaselineSER(WavLMConfig.tiny(), head_dim=24, head_layers=2,
                       device="meta")
    restore_model(str(tmp_path / "port"), "final_model", port)
    port.eval()
    want = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                       deterministic=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert _rel(got.numpy(), want) < TOL


def test_emotion_state_converts(tmp_path):
    model = JaxClassifier(JaxConfig.tiny(), hidden_dim=16, dropout=0.0)
    x = _audio(5)
    mask = np.ones((2, T), np.int32)
    jstate = jes(model, jax.random.PRNGKey(4),
                 {"input_values": jnp.asarray(x),
                  "attention_mask": jnp.asarray(mask)},
                 make_emotion_optimizer(1e-4))
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), "best", jstate)
    kind = orbax_to_torch.convert(str(tmp_path / "jax" / "best"),
                                  str(tmp_path / "port" / "best"),
                                  "wavlm-tiny")
    assert kind == "emotion"
    cfg = WavLMConfig.tiny()
    fresh = EmotionClassifier(cfg, 16, device="meta")
    fresh.load_state_dict(with_random_biases(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(8), 16), 8), assign=True)
    state, _ = restore_checkpoint(str(tmp_path / "port"), "best",
                                  create_emotion_state(fresh))
    assert state.step == 0 and not bool(state.mu.any())
    want = model.apply({"params": jstate.params}, jnp.asarray(x),
                       jnp.asarray(mask), "both", deterministic=True)
    state.model.eval()
    with torch.no_grad():
        got = state.model(torch.from_numpy(x), torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < TOL
