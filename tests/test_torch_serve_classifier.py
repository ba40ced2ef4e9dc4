"""The port's SER classifier artifact (``export_classifier`` +
``ServingModel``) and the export CLI on the CPU, held to the JAX package.

The counterpart of ``tests/test_serve_export.py:107-131``: the tiny
``EmotionClassifier`` (hidden 32) with JAX's seeded weights, moved through
``models.convert.emotion_params_to_state_dict``; buckets (2, 4), 0.48 s
clips (7680 samples, 383 frames: the block path's plain versions).  Ragged
requests of N ∈ {1, 3, 7} rows (7 chunked 4 + 3) with ragged lengths, for
``task`` ∈ {categorical, dimensional, both}: every row within 1e-4 of
max|ref| of JAX's ``EmotionClassifier.apply(..., deterministic=True)`` on
the same zero-padded audio and mask, with no kernel launch on the CPU;
requests of 7, 1 and 3 rows in turn through one server equal each served
alone by a fresh one, bit for bit, and JAX's, and the bucket program's
static inputs hold the whole padded request after each; a bucket
program's outputs sliced equal ``ServingModel.forward`` on the padded
request.  Then the manifest's keys, and ``python -m
nrse_tpu_torch.serve.export``'s ``main`` on a BYOL checkpoint of the
port's ``train/checkpoint.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nrse_tpu.models.emotion import EmotionClassifier as JaxClassifier
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu_torch.models.convert import (
    emotion_params_to_state_dict,
    init_byol_state_dict,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from nrse_tpu_torch.ops import (
    block_attention,
    flash_attention,
    fused_ffn,
    fused_frontend,
    pallas_norm,
)
from nrse_tpu_torch.serve import export
from nrse_tpu_torch.serve.export import ServingModel, export_classifier
from nrse_tpu_torch.train.byol_trainer import create_train_state
from nrse_tpu_torch.train.checkpoint import load_byol_encoder, save_checkpoint
from torch_init import with_random_biases

torch.set_num_threads(1)

TOL = 1e-4
HIDDEN = 32
CLIP_SECONDS = 0.48
CLIP = 7680
BUCKETS = (2, 4)
SHORT = CLIP - 1000  # request length: the server pads it to the clip


def _launches():
    return (block_attention.LAUNCHES, flash_attention.LAUNCHES,
            fused_ffn.LAUNCHES, fused_frontend.LAUNCHES, pallas_norm.LAUNCHES)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An artifact of each task, 7 ragged requests' rows and JAX's
    outputs for them (rows are independent, so one JAX forward of all 7
    serves every request)."""
    model = JaxClassifier(JaxConfig.tiny(), hidden_dim=HIDDEN, dropout=0.0)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, CLIP), jnp.float32),
        jnp.ones((1, CLIP), jnp.int32))
    sd = emotion_params_to_state_dict(jax.tree.map(np.asarray, params),
                                      WavLMConfig.tiny())
    root = tmp_path_factory.mktemp("classifier")
    dirs = {task: export_classifier(sd, WavLMConfig.tiny(),
                                    str(root / task), batch_sizes=BUCKETS,
                                    clip_seconds=CLIP_SECONDS, task=task,
                                    hidden_dim=HIDDEN)
            for task in ("categorical", "dimensional", "both")}
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((7, SHORT))).astype(np.float32)
    lengths = rng.integers(CLIP // 4, SHORT + 1, 7)
    mask = (np.arange(SHORT)[None, :] < lengths[:, None]).astype(np.int32)
    pad = ((0, 0), (0, CLIP - SHORT))
    logits, dims = model.apply(params, jnp.asarray(np.pad(audio, pad)),
                               jnp.asarray(np.pad(mask, pad)), "both",
                               deterministic=True)
    return dirs, audio, mask, np.asarray(logits), np.asarray(dims)


@pytest.mark.parametrize("task", ["categorical", "dimensional", "both"])
@pytest.mark.parametrize("n", [1, 3, 7, pytest.param((7, 1, 3),
                                                     id="7-then-1-then-3")])
def test_ragged_requests_match_jax(served, task, n):
    dirs, audio, mask, ref_logits, ref_dims = served
    server = ServingModel(dirs[task], "cpu")
    launches = _launches()
    want = {"categorical": (ref_logits,), "dimensional": (ref_dims,),
            "both": (ref_logits, ref_dims)}[task]
    for n in n if isinstance(n, tuple) else (n,):  # one server, in turn
        out = server(audio[:n], mask[:n])
        assert _launches() == launches
        got = out if task == "both" else (out,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == (n, w.shape[1]) and g.dtype == np.float32
            assert _rel(g, w[:n]) < TOL, _rel(g, w[:n])
        alone = ServingModel(dirs[task], "cpu")(audio[:n], mask[:n])
        for g, a in zip(got, alone if task == "both" else (alone,)):
            np.testing.assert_array_equal(g, a)
        rows, bucket = server.plan(n)[-1]
        a, m = _padded(audio[n - rows:n], mask[n - rows:n], bucket)
        np.testing.assert_array_equal(server.programs[bucket].audio.numpy(),
                                      a)
        np.testing.assert_array_equal(server.programs[bucket].mask.numpy(),
                                      m)


def _padded(audio, mask, bucket):
    """The ``[bucket, clip]`` audio and mask the server writes for a
    chunk: zero padding, the padding rows' mask 1 at sample 0 only."""
    rows = len(audio)
    a = np.zeros((bucket, CLIP), np.float32)
    m = np.zeros((bucket, CLIP), np.int32)
    a[:rows, :audio.shape[1]] = audio
    m[:rows, :mask.shape[1]] = mask
    m[rows:, 0] = 1
    return a, m


@pytest.mark.parametrize("task", ["categorical", "dimensional", "both"])
def test_bucket_program_equals_the_forward(served, task):
    """On the CPU a bucket program runs the eager forward on its static
    inputs (no graph): a request's outputs are ``ServingModel.forward``'s
    on the padded request, sliced, bit for bit."""
    dirs, audio, mask, _, _ = served
    server = ServingModel(dirs[task], "cpu")
    out = server(audio[:3], mask[:3])
    program = server.programs[4]
    assert program.graph is None and program.replays == 0
    a, m = _padded(audio[:3], mask[:3], 4)
    want = server.forward(torch.from_numpy(a), torch.from_numpy(m))
    got = out if task == "both" else (out,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[:3].numpy())


def test_manifest(served):
    out = served[0]["both"]
    with open(f"{out}/manifest.json") as f:
        manifest = json.load(f)
    assert set(manifest) == {"kind", "buckets", "with_mask", "clip_seconds",
                             "sample_rate", "task", "outputs",
                             "encoder_config", "hidden_dim", "num_emotions",
                             "weights"}
    assert manifest["kind"] == "classify" and manifest["task"] == "both"
    assert manifest["outputs"] == ["categorical_logits",
                                   "dimensional_values"]
    assert manifest["buckets"] == list(BUCKETS)
    assert (manifest["hidden_dim"], manifest["num_emotions"]) == (HIDDEN, 8)
    assert WavLMConfig(**manifest["encoder_config"]) == WavLMConfig.tiny()
    with open(f"{served[0]['dimensional']}/manifest.json") as f:
        assert json.load(f)["outputs"] == ["dimensional_values"]
    server = ServingModel(out, "cpu")
    assert server.plan(7) == [(4, 4), (3, 4)]


def test_rejects_a_bad_task_or_state_dict(served, tmp_path):
    sd = torch.load(f"{served[0]['both']}/params.pt", weights_only=True)
    with pytest.raises(ValueError, match="task"):
        export_classifier(sd, WavLMConfig.tiny(), str(tmp_path), task="avd",
                          hidden_dim=HIDDEN)
    with pytest.raises(RuntimeError):  # the strict load: hidden_dim differs
        export_classifier(sd, WavLMConfig.tiny(), str(tmp_path / "x"),
                          hidden_dim=HIDDEN * 2)
    assert not (tmp_path / "x").exists()


def _byol_checkpoint(root):
    cfg = WavLMConfig.tiny()
    sd = with_random_biases(init_byol_state_dict(
        cfg, 16, 32, torch.Generator().manual_seed(5)), 5)
    state = create_train_state(cfg, sd, 16, 32, "cpu")
    return save_checkpoint(str(root), "best_val_loss", state)


def test_export_cli_on_a_byol_checkpoint(tmp_path, capsys):
    ckpt = _byol_checkpoint(tmp_path / "ckpt")
    config = tmp_path / "byol.yaml"
    config.write_text(yaml.safe_dump({
        "model": {"name": "wavlm-tiny"},
        "data": {"max_audio_length": CLIP_SECONDS, "sample_rate": 16000}}))
    out = export.main(["--config", str(config), "--checkpoint", ckpt,
                       "--out", str(tmp_path / "art"), "--batch-sizes", "1,2",
                       "--device", "cpu"])
    assert "one request on cpu" in capsys.readouterr().out
    server = ServingModel(out, "cpu")
    assert server.kind == "embed" and server.buckets == [1, 2]
    assert server.clip_samples == CLIP
    audio = (0.1 * np.random.default_rng(3).standard_normal((3, CLIP))
             ).astype(np.float32)
    _, pooled = server(audio)
    direct = WavLMModel(WavLMConfig.tiny()).eval()
    direct.load_state_dict(load_byol_encoder(ckpt, WavLMConfig.tiny()))
    with torch.no_grad():
        _, want = direct(torch.from_numpy(audio),
                         torch.ones(3, CLIP, dtype=torch.int32))
    assert np.abs(pooled - want.numpy()).max() < 1e-5
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.main(["--config", str(config), "--checkpoint", ckpt,
                         "--out", str(tmp_path / "art2")])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingModel(out)
