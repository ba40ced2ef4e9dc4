"""The port's seeded start against JAX's initialisers, leaf by leaf.

``models.convert``'s four ``init_*state_dict`` functions against the JAX
modules' ``init`` at one layer of WavLM-large width (1024 wide, 16
heads, FFN 4096, the full conv stack and positional conv), each JAX tree
brought into the port's layout by the converters:

  * the same keys and shapes;
  * every bias exactly zero on both sides (flax's ``zeros``);
  * a leaf JAX fills with one value (norm scales, ``weight_g``,
    ``gru_rel_pos_const``) equal to it;
  * each random leaf's std within ``STD_TOL`` (3%) of the JAX leaf's,
    where the leaf holds at least ``STD_MIN_SIZE`` values; a smaller one
    (the bucket table, ``masked_spec_embed``, the pooling's attention
    vector, the 3- and 8-way outputs) within five standard errors of the
    ratio of two sample stds, ``5/√n``;
  * every LeCun leaf (a Dense or conv weight, the pooling's projection)
    inside flax's truncation, |w| ≤ 2·√(1/fan_in)/0.8796, on both sides,
    and reaching past 97% of it (an untruncated normal would cross it, a
    narrower truncation would not reach it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.baseline.pipeline import BaselineSER as JaxBaselineSER
from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.emotion import EmotionClassifier as JaxEmotionClassifier
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.models.wavlm import WavLMModel as JaxWavLMModel
from nrse_tpu_torch.models.convert import (
    TRUNCATED_NORMAL_STD,
    baseline_params_to_state_dict,
    byol_variables_to_state_dicts,
    emotion_params_to_state_dict,
    init_baseline_state_dict,
    init_byol_state_dict,
    init_emotion_state_dict,
    init_state_dict,
    jax_params_to_state_dict,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig

torch.set_num_threads(1)

STD_TOL = 0.03
STD_MIN_SIZE = 1 << 14  # the std ratio's standard error ≤ 0.8% there
SAMPLES = 3200          # a 0.2 s input for ``init``


def _jax_wavlm():
    cfg = JaxWavLMConfig.large(num_hidden_layers=1, dtype=jnp.float32)
    x = jnp.zeros((1, SAMPLES))
    return jax_params_to_state_dict(jax.tree.map(np.asarray, jax.jit(
        JaxWavLMModel(cfg).init)({"params": jax.random.PRNGKey(1)}, x)),
        _port_cfg())


def _jax_byol():
    cfg = JaxWavLMConfig.large(num_hidden_layers=1, dtype=jnp.float32)
    model = BYOLSpeechModel({"model": {}}, encoder_config=cfg)
    variables = model.init(jax.random.PRNGKey(2), jnp.zeros((2, SAMPLES)))
    return byol_variables_to_state_dicts(
        jax.tree.map(np.asarray, variables), _port_cfg())[0]


def _jax_baseline():
    cfg = JaxWavLMConfig.large(num_hidden_layers=1, dtype=jnp.float32)
    x = jnp.zeros((2, SAMPLES))
    params = jax.jit(JaxBaselineSER(cfg).init)(
        {"params": jax.random.PRNGKey(3)}, x, jnp.ones_like(x))["params"]
    return baseline_params_to_state_dict(jax.tree.map(np.asarray, params),
                                         _port_cfg())


def _jax_emotion():
    cfg = JaxWavLMConfig.large(num_hidden_layers=1, dtype=jnp.float32)
    x = jnp.zeros((2, SAMPLES))
    params = jax.jit(JaxEmotionClassifier(cfg).init, static_argnums=(3, 4))(
        {"params": jax.random.PRNGKey(4)}, x, jnp.ones_like(x), "both",
        True)["params"]
    return emotion_params_to_state_dict(jax.tree.map(np.asarray, params),
                                        _port_cfg())


def _port_cfg():
    return WavLMConfig.large(num_hidden_layers=1)


CASES = {
    "wavlm": (_jax_wavlm, lambda g: init_state_dict(_port_cfg(), g)),
    "byol": (_jax_byol,
             lambda g: init_byol_state_dict(_port_cfg(), 1024, 2048, g)),
    "baseline": (_jax_baseline,
                 lambda g: init_baseline_state_dict(_port_cfg(), g)),
    "emotion": (_jax_emotion,
                lambda g: init_emotion_state_dict(_port_cfg(), g)),
}


def _fan_in(name, shape):
    """The fan-in of a LeCun leaf in the port's layout, or None: Linear
    ``[out, in]`` and conv ``[out, in, k]`` weights (``in·k``), the
    pooling's ``[in, out]`` projection."""
    if name.endswith("sap_linear_kernel"):
        return shape[0]
    if (len(shape) >= 2 and name.endswith(".weight")
            and "rel_attn_embed" not in name):
        return int(np.prod(shape[1:]))
    return None


@pytest.mark.parametrize("kind", sorted(CASES))
def test_init_follows_jax_initialisers(kind):
    make_jax, make_port = CASES[kind]
    want = make_jax()
    got = {k: v.numpy() for k, v in
           make_port(torch.Generator().manual_seed(5)).items()}
    assert set(got) == set(want)
    random = 0
    for name, j in want.items():
        p = got[name]
        assert p.shape == j.shape, name
        if name.endswith("bias"):
            assert not p.any() and not j.any(), name
            continue
        if np.all(j == j.flat[0]):
            np.testing.assert_array_equal(p, j, err_msg=name)
            continue
        random += 1
        ratio = float(p.std()) / float(j.std())
        tol = STD_TOL if j.size >= STD_MIN_SIZE else 5.0 / np.sqrt(j.size)
        assert abs(ratio - 1.0) < tol, (name, ratio, tol)
        fan_in = _fan_in(name, p.shape)
        if fan_in is not None:
            bound = 2.0 * fan_in ** -0.5 / TRUNCATED_NORMAL_STD
            for side in (p, j):
                top = float(np.abs(side).max())
                assert 0.97 * bound < top <= bound * (1 + 1e-6), (
                    name, top, bound)
    assert random > 10


def test_init_is_seeded():
    g = (torch.Generator().manual_seed(7) for _ in range(2))
    a, b = (init_byol_state_dict(WavLMConfig.tiny(), 16, 32, gen)
            for gen in g)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = init_byol_state_dict(WavLMConfig.tiny(), 16, 32,
                             torch.Generator().manual_seed(8))
    assert not torch.equal(a["predictor.dense_0.weight"],
                           c["predictor.dense_0.weight"])
