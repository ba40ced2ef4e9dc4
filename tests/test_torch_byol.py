"""The port's BYOL pieces against the JAX package's.

  * the heads (``models/heads.py``) against flax's, in training mode for
    two steps (outputs and BatchNorm running statistics) and in eval mode
    on the statistics those steps left;
  * ``byol_loss`` with ``valid`` weights and per sample;
  * ``make_byol_views``, with one silent clip (``valid = False``);
  * the BYOL-variable converter: keys, shapes and values, strict loads;
  * ``ema_update`` against the JAX model's.

Float32 throughout.  Tolerances: 1e-5 ``max|Δ|/max|ref|`` on the heads
(the inputs are spread so that each BatchNorm feature's batch variance is
well above float32's rounding of ``E[x²] − E[x]²``), 1e-6 absolute on the
loss and the views, exact for the converter.

The BatchNorm trap: flax advances the running variance with the *biased*
batch variance where ``torch.nn.BatchNorm1d`` uses the unbiased one, and
flax's ``momentum=0.9`` is torch's ``momentum=0.1``;
``test_running_variance_is_biased`` pins both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.audio.augment import make_byol_views as jax_views
from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.byol import byol_loss as jax_loss
from nrse_tpu.models.byol import byol_loss_per_sample as jax_loss_per_sample
from nrse_tpu.models.heads import PredictionHead as JaxPrediction
from nrse_tpu.models.heads import ProjectionHead as JaxProjection
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu_torch.audio.augment import make_byol_views
from nrse_tpu_torch.models.byol import (
    OnlineNetwork,
    TargetNetwork,
    byol_loss,
    byol_loss_per_sample,
    ema_update,
)
from nrse_tpu_torch.models.convert import byol_variables_to_state_dicts
from nrse_tpu_torch.models.heads import (
    BatchNorm,
    PredictionHead,
    ProjectionHead,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig

torch.set_num_threads(1)

HEAD_TOL = 1e-5
TOL = 1e-6
HEADS = {
    "projection": (lambda: JaxProjection(32, 24),
                   lambda: ProjectionHead(48, 32, 24)),
    "prediction": (lambda: JaxPrediction(40, 24),
                   lambda: PredictionHead(48, 40, 24)),
}


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _head_state_dict(params, stats):
    sd = {}
    for name, tree in params.items():
        if name.startswith("dense_"):
            sd[f"{name}.weight"] = np.asarray(tree["kernel"]).T
            sd[f"{name}.bias"] = np.asarray(tree["bias"])
        else:
            sd[f"{name}.weight"] = np.asarray(tree["scale"])
            sd[f"{name}.bias"] = np.asarray(tree["bias"])
            sd[f"{name}.running_mean"] = np.asarray(stats[name]["mean"])
            sd[f"{name}.running_var"] = np.asarray(stats[name]["var"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.mark.parametrize("head", list(HEADS))
def test_heads_match_flax_in_train_and_eval_mode(head):
    jax_head, port_head = (f() for f in HEADS[head])
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal((8, 48)) * rng.uniform(0.5, 2.0, 48)
           + rng.standard_normal(48)).astype(np.float32) for _ in range(3)]
    variables = jax_head.init(jax.random.PRNGKey(1), jnp.asarray(xs[0]))
    module = port_head
    module.load_state_dict(_head_state_dict(variables["params"],
                                            variables["batch_stats"]))
    module.train()
    for x in xs[:2]:
        ref, upd = jax_head.apply(variables, jnp.asarray(x),
                                  use_running_average=False,
                                  mutable=["batch_stats"])
        variables = {**variables, **upd}
        out = module(torch.from_numpy(x))
        assert _rel(out.detach().numpy(), np.asarray(ref)) < HEAD_TOL
    for name, stats in variables["batch_stats"].items():
        bn = getattr(module, name)
        assert _rel(bn.running_mean.numpy(), np.asarray(stats["mean"])) \
            < HEAD_TOL
        assert _rel(bn.running_var.numpy(), np.asarray(stats["var"])) \
            < HEAD_TOL
    module.eval()
    ref = jax_head.apply(variables, jnp.asarray(xs[2]),
                         use_running_average=True)
    with torch.no_grad():
        out = module(torch.from_numpy(xs[2]))
    assert _rel(out.numpy(), np.asarray(ref)) < HEAD_TOL


def test_running_variance_is_biased():
    x = torch.tensor([[0.0], [2.0]])
    bn = BatchNorm(1).train()
    bn(x)
    # biased variance 1 (not the unbiased 2), kept 0.9 of the old value 1
    assert bn.running_var.item() == pytest.approx(0.9 * 1 + 0.1 * 1.0)
    assert bn.running_mean.item() == pytest.approx(0.1 * 1.0)


def test_byol_loss_matches_jax():
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((6, 16)).astype(np.float32)
    proj = rng.standard_normal((6, 16)).astype(np.float32)
    proj[2] = 0.0                    # a zero projection: the guards hold
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    tp, tj = torch.from_numpy(pred), torch.from_numpy(proj)
    got = byol_loss_per_sample(tp, tj).numpy()
    want = np.asarray(jax_loss_per_sample(jnp.asarray(pred),
                                          jnp.asarray(proj)))
    assert np.abs(got - want).max() < TOL
    for w in (None, valid, np.zeros(6, bool)):
        ref = jax_loss(jnp.asarray(pred), jnp.asarray(proj),
                       None if w is None else jnp.asarray(w))
        ours = byol_loss(tp, tj, None if w is None else torch.from_numpy(w))
        assert abs(float(ours) - float(ref)) < TOL


def test_views_match_jax_with_a_silent_clip():
    rng = np.random.default_rng(3)
    clean = (0.3 * rng.standard_normal((4, 3200))).astype(np.float32)
    clean[1] = 0.0                   # silent: no valid mix
    noise = (0.2 * rng.standard_normal((4, 3200))).astype(np.float32)
    snr = np.array([2.0, 5.0, 10.0, 20.0], np.float32)
    ref = jax_views(jnp.asarray(clean), jnp.asarray(noise), jnp.asarray(snr))
    got = make_byol_views(torch.from_numpy(clean), torch.from_numpy(noise),
                          torch.from_numpy(snr))
    assert got[2].tolist() == np.asarray(ref[2]).tolist() == \
        [True, False, True, True]
    for a, b in zip(got[:2], ref[:2]):
        assert np.abs(a.numpy() - np.asarray(b)).max() < TOL


def test_converter_keys_shapes_values():
    cfg = JaxConfig.tiny(layerdrop=0.0)
    model = BYOLSpeechModel({"model": {"projection_dim": 32,
                                       "prediction_dim": 64}},
                            encoder_config=cfg)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3200))))
    pcfg = WavLMConfig.tiny()
    online_sd, target_sd = byol_variables_to_state_dicts(variables, pcfg)
    online = OnlineNetwork(pcfg, 32, 64)
    target = TargetNetwork(pcfg, 32)
    for module, sd in ((online, online_sd), (target, target_sd)):
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == want
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in sd.items()}, strict=True)
    p, s = variables.online["params"], variables.online["batch_stats"]
    np.testing.assert_array_equal(online_sd["predictor.dense_2.weight"],
                                  p["predictor"]["dense_2"]["kernel"].T)
    np.testing.assert_array_equal(online_sd["projector.bn_1.weight"],
                                  p["projector"]["bn_1"]["scale"])
    np.testing.assert_array_equal(online_sd["projector.bn_0.running_var"],
                                  s["projector"]["bn_0"]["var"])
    np.testing.assert_array_equal(
        target_sd["encoder.feature_projection.projection.weight"],
        variables.target["params"]["encoder"]["feature_projection"]
        ["projection"]["kernel"].T)
    assert not any(k.startswith("predictor.") for k in target_sd)


def test_ema_update_matches_jax():
    cfg = JaxConfig.tiny(layerdrop=0.0)
    model = BYOLSpeechModel({"model": {"projection_dim": 32,
                                       "prediction_dim": 64}},
                            encoder_config=cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 3200)))
    rng = np.random.default_rng(4)
    variables.online["params"] = jax.tree.map(
        lambda v: v + rng.standard_normal(v.shape).astype(np.float32),
        variables.online["params"])           # online and target apart
    ref = model.ema_update(variables, 0.9)
    pcfg = WavLMConfig.tiny()
    online_sd, target_sd = byol_variables_to_state_dicts(
        jax.tree.map(np.asarray, variables), pcfg)
    _, want = byol_variables_to_state_dicts(jax.tree.map(np.asarray, ref),
                                            pcfg)
    online, target = OnlineNetwork(pcfg, 32, 64), TargetNetwork(pcfg, 32)
    online.load_state_dict({k: torch.from_numpy(v)
                            for k, v in online_sd.items()})
    target.load_state_dict({k: torch.from_numpy(v)
                            for k, v in target_sd.items()})
    ema_update(target, online, 0.9)
    for k, v in target.state_dict().items():
        assert np.abs(v.numpy() - want[k]).max() <= 1e-6 * max(
            np.abs(want[k]).max(), 1.0), k
