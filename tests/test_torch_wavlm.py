"""The whole slice: the port's WavLM forward against the JAX ``WavLMModel``.

The JAX model is initialised from ``PRNGKey(0)``, its params are converted
with the port's numpy ``jax_params_to_state_dict`` and loaded strictly.
Both sides get the same audio, unmasked and with row 1 masked at half
length, and run in float32.  The JAX side runs in its kernel configuration
(block attention and the fused FFN as Pallas kernels in interpret mode),
in its default XLA configuration, and with its frontend's Pallas routes
(``frontend_norm="fused"``: K6 on the conv layers of stride 2, as the port
runs them; ``"pallas"``: K7 after every conv); the port runs its plain CPU
paths.

Audio is 7680 samples: the tiny config's three convs give 383 frames, the
most that stays within the block kernel's T ≤ 384 (16000 samples would
give 799 frames and route the JAX side to the flash kernel instead).

Tolerance 1e-4 absolute on ``sequence`` and ``pooled``: the port and JAX
differ only in float32 summation order and in the FFN kernel's A&S erf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.wavlm import ConvFeatureEncoder as JaxConvFeatureEncoder
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.models.wavlm import WavLMModel as JaxModel
from nrse_tpu_torch.models.convert import jax_params_to_state_dict
from nrse_tpu_torch.models.wavlm import (
    ConvFeatureEncoder,
    WavLMConfig,
    WavLMModel,
)

torch.set_num_threads(1)

TOL = 1e-4
SAMPLES = 7680
ARCHS = {
    "stable_ln": {},
    "post_ln_group": dict(feat_extract_norm="group",
                          do_stable_layer_norm=False, conv_bias=False),
}
JAX_IMPLS = {
    "kernels": dict(use_flash_attention=True, ffn_impl="fused"),
    "xla": {},
    # the port's frontend route: K6 on layers 1-2 of tiny (K7 on layer 0)
    "fused": dict(frontend_norm="fused"),
    # K7 on every frontend layer
    "pallas": dict(frontend_norm="pallas"),
}


@pytest.fixture(scope="module")
def jax_params():
    """Per architecture: the JAX params (the param tree is the same for
    both JAX implementations)."""
    x = jnp.zeros((2, SAMPLES), jnp.float32)
    out = {}
    for arch, kw in ARCHS.items():
        init = jax.jit(JaxModel(JaxConfig.tiny(layerdrop=0.0, **kw)).init)
        out[arch] = init(jax.random.PRNGKey(0), x)
    return out


def _audio():
    x = np.random.default_rng(0).standard_normal((2, SAMPLES))
    mask = np.ones((2, SAMPLES), np.int32)
    mask[1, SAMPLES // 2:] = 0
    return x.astype(np.float32), mask


def _port_model(arch, params):
    cfg = WavLMConfig.tiny(**ARCHS[arch])
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params), cfg)
    model = WavLMModel(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", list(JAX_IMPLS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(jax_params, arch, impl, masked):
    params = jax_params[arch]
    jcfg = JaxConfig.tiny(layerdrop=0.0, **ARCHS[arch], **JAX_IMPLS[impl])
    x, mask = _audio()
    m = mask if masked else None
    ref_seq, ref_pooled = JaxModel(jcfg).apply(
        params, jnp.asarray(x), None if m is None else jnp.asarray(m))
    with torch.no_grad():
        seq, pooled = _port_model(arch, params)(
            torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    assert seq.shape == (2, 383, 64) and pooled.shape == (2, 64)
    e_seq = np.abs(seq.numpy() - np.asarray(ref_seq)).max()
    e_pooled = np.abs(pooled.numpy() - np.asarray(ref_pooled)).max()
    assert e_seq < TOL and e_pooled < TOL, (e_seq, e_pooled)


@pytest.mark.parametrize("samples", [7680, 7689])
def test_frontend_gradients_match_jax(samples):
    """The port's conv frontend (K6 on layers 1-2, K7 on layer 0; the
    plain versions on the CPU), forward and backward, against ``jax.grad``
    of JAX's ``ConvFeatureEncoder`` with ``frontend_norm="fused"`` (its
    Pallas kernels in interpret mode), at an even and an odd waveform
    length; the JAX golden test's atol and rtol of 2e-4."""
    jcfg = JaxConfig.tiny(layerdrop=0.0, frontend_norm="fused")
    x = np.random.default_rng(5).standard_normal((2, samples)).astype(
        np.float32)
    params = jax.jit(JaxConvFeatureEncoder(jcfg).init)(
        jax.random.PRNGKey(1), jnp.asarray(x))

    def loss(p, xx):
        out = JaxConvFeatureEncoder(jcfg).apply(p, xx)
        return jnp.sum(out * jnp.cos(0.01 * jnp.arange(out.size).reshape(
            out.shape)))

    ref_out = np.asarray(JaxConvFeatureEncoder(jcfg).apply(params,
                                                           jnp.asarray(x)))
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    cfg = WavLMConfig.tiny()
    port = ConvFeatureEncoder(cfg)
    p = jax.tree.map(np.asarray, params["params"])
    sd = {}
    for i in range(len(cfg.conv_dim)):
        sd[f"conv_layers.{i}.conv.weight"] = np.transpose(
            p[f"conv_{i}"]["kernel"], (2, 1, 0))
        sd[f"conv_layers.{i}.conv.bias"] = p[f"conv_{i}"]["bias"]
        sd[f"conv_layers.{i}.layer_norm.weight"] = p[f"layer_norm_{i}"][
            "scale"]
        sd[f"conv_layers.{i}.layer_norm.bias"] = p[f"layer_norm_{i}"]["bias"]
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt, torch.float32)
    assert out.is_contiguous() and out.shape == ref_out.shape
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-4,
                               rtol=2e-4)
    w = torch.cos(0.01 * torch.arange(out.numel()).reshape(out.shape))
    (out * w).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=2e-4,
                               rtol=2e-4)
    gp = jax.tree.map(np.asarray, g_params["params"])
    for i in range(len(cfg.conv_dim)):
        layer = port.conv_layers[i]
        pairs = [(layer.conv.weight.grad.numpy(),
                  np.transpose(gp[f"conv_{i}"]["kernel"], (2, 1, 0))),
                 (layer.conv.bias.grad.numpy(), gp[f"conv_{i}"]["bias"]),
                 (layer.layer_norm.weight.grad.numpy(),
                  gp[f"layer_norm_{i}"]["scale"]),
                 (layer.layer_norm.bias.grad.numpy(),
                  gp[f"layer_norm_{i}"]["bias"])]
        for got, want in pairs:
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_training_mode_raises(jax_params):
    """Training mode draws dropout, LayerDrop and SpecAugment from the
    step's TrainRNG: without one it raises rather than run
    deterministically."""
    model = _port_model("stable_ln", jax_params["stable_ln"]).train()
    with pytest.raises(ValueError, match="needs rng"):
        model(torch.zeros(1, SAMPLES))
