"""The port's ``export_embedder`` + ``ServingModel`` on the CPU, held to a
direct forward of the JAX ``WavLMModel``.

Tiny config, buckets (2, 4), 0.48 s clips (7680 samples, 383 frames: the
longest the block kernel's T ≤ 384 admits for tiny).  Ragged requests of
N ∈ {1, 3, 7} rows with ragged lengths; N = 7 is chunked 4 + 3.  Every row
must equal the JAX forward of the same zero-padded audio and mask to 1e-4
absolute (float32, summation order only).  Requests of 7, 1 and 3 rows in
turn through one server equal each served alone by a fresh one, bit for
bit, and JAX's; after each, the bucket program's static inputs hold the
whole padded request (padding rows zero, their mask 1 at sample 0 only),
and the program's outputs sliced equal ``ServingModel.forward`` on the
padded request.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.models.wavlm import WavLMModel as JaxModel
from nrse_tpu_torch.models.convert import jax_params_to_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import block_attention, fused_ffn
from nrse_tpu_torch.serve.export import (
    ServingModel,
    export_embedder,
    load_serving_model,
)

torch.set_num_threads(1)

TOL = 1e-4
CLIP_SECONDS = 0.48
CLIP = 7680
BUCKETS = (2, 4)
SHORT = CLIP - 1000  # request length: the server pads it to the clip


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The exported artifact, and 7 ragged requests' rows with the JAX
    forward of each row's zero-padded audio and mask (rows are
    independent, so one JAX forward of all 7 serves every request)."""
    jax_model = JaxModel(JaxConfig.tiny(layerdrop=0.0))
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, CLIP), jnp.float32))
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params),
                                  WavLMConfig.tiny())
    out = str(tmp_path_factory.mktemp("embedder"))
    export_embedder(sd, WavLMConfig.tiny(), out, batch_sizes=BUCKETS,
                    clip_seconds=CLIP_SECONDS)

    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((7, SHORT))).astype(np.float32)
    lengths = rng.integers(CLIP // 4, SHORT + 1, 7)
    mask = (np.arange(SHORT)[None, :] < lengths[:, None]).astype(np.int32)
    pad = ((0, 0), (0, CLIP - SHORT))
    ref = jax_model.apply(params, jnp.asarray(np.pad(audio, pad)),
                          jnp.asarray(np.pad(mask, pad)))
    return out, audio, mask, tuple(np.asarray(r) for r in ref)


def test_manifest_layout(served):
    out = served[0]
    with open(f"{out}/manifest.json") as f:
        manifest = json.load(f)
    assert manifest["kind"] == "embed"
    assert manifest["buckets"] == list(BUCKETS)
    assert manifest["weights"] == "params.pt"
    assert manifest["outputs"] == ["sequence", "pooled"]
    assert WavLMConfig(**manifest["encoder_config"]) == WavLMConfig.tiny()
    server = load_serving_model(out, "cpu")
    assert server.clip_samples == CLIP
    assert server.plan(7) == [(4, 4), (3, 4)]
    assert server.plan(1) == [(1, 2)]


@pytest.mark.parametrize("n", [1, 3, 7, pytest.param((7, 1, 3),
                                                     id="7-then-1-then-3")])
def test_ragged_requests_match_jax(served, n):
    out, audio, mask, (ref_seq, ref_pooled) = served
    server = ServingModel(out, "cpu")
    launches = (block_attention.LAUNCHES, fused_ffn.LAUNCHES)

    for n in n if isinstance(n, tuple) else (n,):  # one server, in turn
        seq, pooled = server(audio[:n], mask[:n])
        assert (block_attention.LAUNCHES, fused_ffn.LAUNCHES) == launches
        assert seq.shape == (n, 383, 64) and pooled.shape == (n, 64)
        e_seq = np.abs(seq - ref_seq[:n]).max()
        e_pooled = np.abs(pooled - ref_pooled[:n]).max()
        assert e_seq < TOL and e_pooled < TOL, (e_seq, e_pooled)
        alone = ServingModel(out, "cpu")(audio[:n], mask[:n])
        for got, want in zip((seq, pooled), alone):
            np.testing.assert_array_equal(got, want)
        _check_static_inputs(server, audio[:n], mask[:n])


def _padded(server, audio, mask, rows, bucket):
    """The ``[bucket, clip]`` audio and mask the server writes for
    ``rows`` rows of a request: zero padding, the padding rows' mask 1 at
    sample 0 only."""
    a = np.zeros((bucket, CLIP), np.float32)
    m = np.zeros((bucket, CLIP), np.int32)
    a[:rows, :audio.shape[1]] = audio[:rows]
    m[:rows, :mask.shape[1]] = mask[:rows]
    m[rows:, 0] = 1
    return a, m


def _check_static_inputs(server, audio, mask):
    """The last chunk's bucket program holds that chunk whole."""
    rows, bucket = server.plan(len(audio))[-1]
    start = len(audio) - rows
    a, m = _padded(server, audio[start:], mask[start:], rows, bucket)
    program = server.programs[bucket]
    np.testing.assert_array_equal(program.audio.numpy(), a)
    np.testing.assert_array_equal(program.mask.numpy(), m)


@pytest.mark.parametrize("n", [1, 3])
def test_bucket_program_equals_the_forward(served, n):
    """On the CPU a bucket program runs the eager forward on its static
    inputs: its outputs, sliced to the request's rows, are
    ``ServingModel.forward``'s on the padded request bit for bit, and
    the program holds no graph."""
    out, audio, mask, _ = served
    server = ServingModel(out, "cpu")
    seq, pooled = server(audio[:n], mask[:n])
    bucket = server.plan(n)[0][1]
    program = server.programs[bucket]
    assert program.graph is None and program.replays == 0
    a, m = _padded(server, audio, mask, n, bucket)
    want = server.forward(torch.from_numpy(a), torch.from_numpy(m))
    for got, w in zip((seq, pooled), want):
        np.testing.assert_array_equal(got, w[:n].numpy())
    for got, w in zip(program.run(), want):
        np.testing.assert_array_equal(got.numpy(), w.numpy())


def test_rejects_audio_longer_than_the_clip(served):
    server = ServingModel(served[0], "cpu")
    with pytest.raises(ValueError, match="clip length"):
        server(np.zeros((1, CLIP + 1), np.float32))
