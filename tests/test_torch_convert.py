"""The port's numpy weight converter and bucket matrix against the JAX
package's own.

``jax_params_to_state_dict`` must give exactly the keys, shapes and values
of ``nrse_tpu.models.export_torch.params_to_hf_wavlm_state``, and the
result must load strictly into the port's module.  The bucket matrix must
equal ``nrse_tpu.ops.rel_pos_bias.relative_position_buckets`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.export_torch import params_to_hf_wavlm_state
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.models.wavlm import WavLMModel as JaxModel
from nrse_tpu.ops.rel_pos_bias import (
    compute_position_bias as jax_position_bias,
)
from nrse_tpu.ops.rel_pos_bias import (
    relative_position_buckets as jax_buckets,
)
from nrse_tpu_torch.models.convert import (
    init_state_dict,
    jax_params_to_state_dict,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from nrse_tpu_torch.ops.rel_pos_bias import (
    compute_position_bias,
    relative_position_buckets,
)

torch.set_num_threads(1)

CONFIGS = {"tiny": (JaxConfig.tiny, WavLMConfig.tiny),
           "base_plus": (JaxConfig.base_plus, WavLMConfig.base_plus)}


def _jax_params(name):
    """Random params in the JAX tree.  tiny: the model's own init from
    PRNGKey(0); base_plus: the tree's shapes from ``eval_shape`` filled
    from a numpy seed (a full-width init on the CPU is slow and adds
    nothing to a layout check)."""
    model = JaxModel(CONFIGS[name][0]())
    x = jnp.zeros((1, 4000), jnp.float32)
    if name == "tiny":
        return jax.tree.map(np.asarray,
                            jax.jit(model.init)(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_matches_export_torch(name):
    params = _jax_params(name)
    cfg = CONFIGS[name][1]()
    ref = params_to_hf_wavlm_state(params, CONFIGS[name][0]())
    ours = jax_params_to_state_dict(params, cfg)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        assert ours[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    model = WavLMModel(cfg, device="meta")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ours.items()},
                          strict=True, assign=True)


@pytest.mark.parametrize("frontend_norm", ["fused", "pallas"])
def test_fused_frontend_params_load_strictly(frontend_norm):
    """JAX's kernel routes of the frontend declare nn.Conv's and
    nn.LayerNorm's tree (``nrse_tpu/ops/fused_frontend.py:332-373``): their
    params convert and load strictly, with the frontend weights where the
    port's K6 and K7 read them."""
    jcfg = JaxConfig.tiny(frontend_norm=frontend_norm)
    params = jax.tree.map(np.asarray, jax.jit(JaxModel(jcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 4000), jnp.float32)))
    cfg = WavLMConfig.tiny()
    sd = jax_params_to_state_dict(params, cfg)
    np.testing.assert_array_equal(
        params["params"]["feature_extractor"]["conv_1"]["kernel"],
        np.transpose(sd["feature_extractor.conv_layers.1.conv.weight"],
                     (2, 1, 0)))
    model = WavLMModel(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    assert model.feature_extractor.conv_layers[1].fused
    assert not model.feature_extractor.conv_layers[0].fused


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_state_dict_loads_strictly(name):
    cfg = CONFIGS[name][1]()
    a = init_state_dict(cfg, torch.Generator().manual_seed(0))
    b = init_state_dict(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.isfinite(v).all() for v in a.values())
    WavLMModel(cfg, device="meta").load_state_dict(a, strict=True,
                                                   assign=True)


@pytest.mark.parametrize("t,num_buckets,max_distance",
                         [(249, 320, 800), (384, 320, 800), (383, 40, 100),
                          (49, 40, 100)])
def test_bucket_matrix_matches_jax(t, num_buckets, max_distance):
    ours = relative_position_buckets(t, t, num_buckets, max_distance)
    ref = jax_buckets(t, t, num_buckets, max_distance)
    np.testing.assert_array_equal(ours, ref)
    table = np.random.default_rng(t).standard_normal(
        (num_buckets, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        compute_position_bias(torch.from_numpy(table), t, t, num_buckets,
                              max_distance).numpy(),
        np.asarray(jax_position_bias(jnp.asarray(table), t, t, num_buckets,
                                     max_distance)))
