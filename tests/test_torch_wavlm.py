"""The whole slice: the port's WavLM forward against the JAX ``WavLMModel``.

The JAX model is initialised from ``PRNGKey(0)``, its params are converted
with the port's numpy ``jax_params_to_state_dict`` and loaded strictly.
Both sides get the same audio, unmasked and with row 1 masked at half
length, and run in float32.  The JAX side runs in its kernel configuration
(block attention and the fused FFN as Pallas kernels in interpret mode)
and in its default XLA configuration; the port runs its plain CPU paths.

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

from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.models.wavlm import WavLMModel as JaxModel
from nrse_tpu_torch.models.convert import jax_params_to_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

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


def test_training_mode_raises(jax_params):
    """Training mode draws dropout, LayerDrop and SpecAugment from the
    step's TrainRNG: without one it raises rather than run
    deterministically."""
    model = _port_model("stable_ln", jax_params["stable_ln"]).train()
    with pytest.raises(ValueError, match="needs rng"):
        model(torch.zeros(1, SAMPLES))
