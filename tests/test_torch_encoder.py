"""The port's ``WavLMEncoder`` (``nrse_tpu_torch.models.encoder``, the
reference's encoder API) against the JAX package's
(``nrse_tpu/models/encoder.py``) on the same weights.

The tiny encoder; JAX's seeded weights moved through
``models.convert.jax_params_to_state_dict``; ``[B, T]`` and ``[B, 1, T]``
audio at 7680 samples (383 frames, the block path's plain versions) from a
numpy seed, with and without a ragged mask: the last hidden state and the
pooled embedding within 1e-4 of max|ref|.  Also ``output_dim``, the HF
directory route against JAX's ``from_hf_checkpoint``, and that asking for
the card where there is none raises.
"""

import jax
import numpy as np
import pytest
import torch

from nrse_tpu.models.encoder import WavLMEncoder as JaxWavLMEncoder
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu_torch.models import WavLMEncoder
from nrse_tpu_torch.models.convert import jax_params_to_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import block_attention, fused_ffn
from tests.test_wavlm_golden import make_hf_tiny

torch.set_num_threads(1)

TOL = 1e-4
T = 7680


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.fixture(scope="module")
def pair():
    ref = JaxWavLMEncoder("wavlm-tiny", config=JaxConfig.tiny(), seed=3,
                          sample_seconds=T / 16000)
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, ref.variables),
                                  WavLMConfig.tiny())
    return ref, WavLMEncoder("wavlm-tiny", state_dict=sd, device="cpu")


def _inputs(channel_dim: bool, masked: bool):
    rng = np.random.default_rng(7)
    x = (0.2 * rng.standard_normal((3, T))).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, T), np.int32)
        mask[1, T // 2:] = 0
        mask[2, T // 3:] = 0
    return (x[:, None, :] if channel_dim else x), mask


@pytest.mark.parametrize("channel_dim", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_matches_jax(pair, channel_dim, masked):
    ref, enc = pair
    x, mask = _inputs(channel_dim, masked)
    launches = (block_attention.LAUNCHES, fused_ffn.LAUNCHES)
    seq = enc(x, mask)
    pooled = enc.encode_pooled(torch.from_numpy(x),
                               None if mask is None
                               else torch.from_numpy(mask))
    assert (block_attention.LAUNCHES, fused_ffn.LAUNCHES) == launches
    assert seq.shape == (3, 383, 64) and seq.dtype == torch.float32
    assert _rel(seq.numpy(), ref(x, mask)) < TOL
    assert _rel(pooled.numpy(), ref.encode_pooled(x, mask)) < TOL


def test_output_dim(pair):
    ref, enc = pair
    assert enc.output_dim == ref.output_dim == 64


def test_from_hf_checkpoint_matches_jax(tmp_path):
    hf, jcfg = make_hf_tiny(stable_layer_norm=True)
    hf.save_pretrained(str(tmp_path))
    ref = JaxWavLMEncoder.from_hf_checkpoint(str(tmp_path), config=jcfg)
    enc = WavLMEncoder.from_hf_checkpoint(str(tmp_path), WavLMConfig.tiny(),
                                          device="cpu")
    x, mask = _inputs(False, True)
    assert _rel(enc(x, mask).numpy(), ref(x, mask)) < TOL


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WavLMEncoder("wavlm-tiny")
