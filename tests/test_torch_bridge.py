"""The port's bridges to the reference's PyTorch files
(``nrse_tpu_torch.models.convert``, ``models.export_torch``) against the
JAX package's (``nrse_tpu/models/convert.py``, ``export_torch.py``).

  1. A reference ``BYOLSpeechModel`` state dict (the ``reference_checkpoint``
     fixture of ``tests/test_checkpoint_bridge.py``: two tiny HF WavLMs and
     the heads' ``Sequential`` layouts, BatchNorm statistics moved off
     their defaults) through JAX's ``reference_byol_to_variables`` then
     ``byol_variables_to_state_dicts`` equals the port's
     ``reference_byol_to_state_dicts`` bit for bit, both towers.
  2. The bridged online tower's pooled output and projector output (eval
     mode, BatchNorm on running statistics) within 1e-4 of max|ref| of
     JAX's ``BYOLSpeechModel`` on the bridged variables.
  3. ``load_reference_byol_checkpoint`` on a ``.pt`` file holding the full
     checkpoint dict and a bare state dict.
  4. A tiny HF model ``save_pretrained`` as safetensors and as
     ``pytorch_model.bin``: JAX's ``load_hf_wavlm`` and the port's give
     equal tensors; the port's safetensors reader equals the
     ``safetensors`` package.
  5. ``save_reference_byol_checkpoint`` and ``save_baseline_final_pt``
     strict-load into the torch modules ``tests/test_export_torch.py``
     builds (an HF WavLM, the reference's heads, ASP and
     ``EmotionRegression``) and round-trip through the bridge.
  6. ``train_emotion.main`` with a reference ``.pt`` as
     ``emotion.encoder_checkpoint`` trains from the bridged encoder (tiny,
     CPU, one step).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.convert import load_hf_wavlm as jax_load_hf_wavlm
from nrse_tpu.models.convert import reference_byol_to_variables
from nrse_tpu.models.heads import ProjectionHead as JaxProjectionHead
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu_torch import train_emotion
from nrse_tpu_torch.baseline.pipeline import BaselineSER
from nrse_tpu_torch.models.byol import OnlineNetwork
from nrse_tpu_torch.models.convert import (
    byol_variables_to_state_dicts,
    init_baseline_state_dict,
    jax_params_to_state_dict,
    load_hf_wavlm,
    load_reference_byol_checkpoint,
    read_safetensors,
    reference_byol_to_state_dicts,
)
from nrse_tpu_torch.models.export_torch import (
    baseline_to_final_pt,
    byol_state_dicts_to_reference,
    save_baseline_final_pt,
    save_reference_byol_checkpoint,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train.categorical_emotions import build_classifier
from tests.test_checkpoint_bridge import (  # noqa: F401
    reference_checkpoint,
    torch_prediction_head,
    torch_projection_head,
)
from tests.test_export_torch import _TorchASP, _TorchEmotionRegression
from tests.test_torch_train_emotion import emo_config  # noqa: F401
from tests.test_wavlm_golden import make_hf_tiny
from torch_init import with_random_biases

torch.set_num_threads(1)

TOL = 1e-4
CFG = WavLMConfig.tiny()  # make_hf_tiny's geometry, stable layer norm


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.fixture(scope="module")
def bridged(reference_checkpoint):  # noqa: F811
    sd, cfg, pdim, hdim = reference_checkpoint
    return sd, reference_byol_to_variables(sd, cfg), \
        reference_byol_to_state_dicts(sd, CFG), (pdim, hdim)


def test_bridge_equals_jax_bit_for_bit(bridged):
    _, variables, port, _ = bridged
    want = byol_variables_to_state_dicts(jax.tree.map(np.asarray, variables),
                                         CFG)
    for got, ref in zip(port, want):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype == np.float32, k
            assert got[k].shape == ref[k].shape, k
            assert np.array_equal(got[k], ref[k]), k


def test_bridged_online_tower_matches_jax(bridged):
    _, variables, (online, _), (pdim, hdim) = bridged
    cfg = JaxWavLMConfig.tiny()  # make_hf_tiny's, stable layer norm
    x = np.random.default_rng(2).standard_normal((2, 7680)).astype(
        np.float32)
    model = BYOLSpeechModel({"model": {"projection_dim": pdim,
                                       "prediction_dim": hdim,
                                       "ema_decay": 0.99}},
                            encoder_config=cfg)
    _, ref_pooled = model.encode(variables, jnp.asarray(x),
                                 deterministic=True)
    ref_proj = JaxProjectionHead(pdim, pdim).apply(
        {"params": variables.online["params"]["projector"],
         "batch_stats": variables.online["batch_stats"]["projector"]},
        ref_pooled, use_running_average=True)

    net = OnlineNetwork(CFG, pdim, hdim, device="meta")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in online.items()},
                        strict=True, assign=True)
    net.eval()
    with torch.no_grad():
        _, pooled = net.encoder(torch.from_numpy(x))
        proj = net.projector(pooled)
    assert _rel(pooled.numpy(), ref_pooled) < TOL
    assert _rel(proj.numpy(), ref_proj) < TOL


@pytest.mark.parametrize("layout", ["checkpoint", "bare"])
def test_pt_file_route(bridged, tmp_path, layout):
    sd, _, (online, target), _ = bridged
    obj = {"epoch": 3, "model_state_dict": sd, "optimizer_state_dict": None,
           "loss": 0.2, "similarity": 0.9} if layout == "checkpoint" else sd
    path = str(tmp_path / "byol.pt")
    torch.save(obj, path)
    got_online, got_target = load_reference_byol_checkpoint(path, CFG)
    for got, want in ((got_online, online), (got_target, target)):
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("safe", [True, False])
def test_hf_directory_matches_jax(tmp_path, safe):
    hf, jcfg = make_hf_tiny(stable_layer_norm=True)
    hf.save_pretrained(str(tmp_path), safe_serialization=safe)
    name = "model.safetensors" if safe else "pytorch_model.bin"
    assert (tmp_path / name).is_file()
    want = jax_params_to_state_dict(
        jax.tree.map(np.asarray, jax_load_hf_wavlm(str(tmp_path), jcfg)),
        CFG)
    got = load_hf_wavlm(str(tmp_path), CFG)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    if safe:
        from safetensors.torch import load_file

        ref = load_file(str(tmp_path / name))
        mine = read_safetensors(str(tmp_path / name))
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].dtype == ref[k].dtype and torch.equal(mine[k],
                                                                 ref[k]), k


def test_legacy_weight_norm_keys(bridged):
    """``weight_g``/``weight_v`` are read as the ``parametrizations``
    keys."""
    sd, _, (online, _), _ = bridged
    legacy = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        legacy[k.replace("parametrizations.weight.original1", "weight_v")] = v
    assert legacy.keys() != sd.keys()
    got, _ = reference_byol_to_state_dicts(legacy, CFG)
    assert all(np.array_equal(got[k], online[k]) for k in online)


def test_reference_checkpoint_out_and_back(bridged, tmp_path):
    sd, _, (online, target), (pdim, hdim) = bridged
    path = str(tmp_path / "best_val_loss.pt")
    save_reference_byol_checkpoint(path, online, target, epoch=2, loss=0.3,
                                   similarity=0.8)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["loss"] == pytest.approx(0.3)
    out = ckpt["model_state_dict"]
    assert out.keys() == sd.keys()
    for k, v in sd.items():  # the reference's own state dict, bit for bit
        if k.endswith("num_batches_tracked"):
            assert out[k].dtype == torch.int64
        else:
            assert torch.equal(out[k], v), k
    modules = {
        "online_encoder.model": make_hf_tiny(True)[0],
        "target_encoder.model": make_hf_tiny(True)[0],
        "online_projector.layers": torch_projection_head(64, pdim, pdim),
        "target_projector.layers": torch_projection_head(64, pdim, pdim),
        "online_predictor.layers": torch_prediction_head(pdim, hdim, pdim),
    }
    for prefix, module in modules.items():
        part = {k[len(prefix) + 1:]: v for k, v in out.items()
                if k.startswith(prefix + ".")}
        missing, unexpected = module.load_state_dict(part, strict=True)
        assert not missing and not unexpected
    back_online, back_target = load_reference_byol_checkpoint(path, CFG)
    for got, want in ((back_online, online), (back_target, target)):
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert byol_state_dicts_to_reference(online, target).keys() == sd.keys()


def test_baseline_final_pt(tmp_path):
    sd = with_random_biases(init_baseline_state_dict(
        CFG, torch.Generator().manual_seed(4), head_dim=48, head_layers=2), 4)
    save_baseline_final_pt(str(tmp_path), sd)
    load = (lambda name: torch.load(str(tmp_path / f"final_{name}.pt"),
                                    map_location="cpu", weights_only=True))
    hf, _ = make_hf_tiny(stable_layer_norm=True)
    assert hf.load_state_dict(load("ssl"), strict=True)
    pool = _TorchASP(CFG.hidden_size)
    assert pool.load_state_dict(load("pool"), strict=True)
    assert torch.equal(pool.sap_linear.weight, sd["pool.sap_linear_kernel"].T)
    ser = _TorchEmotionRegression(2 * CFG.hidden_size, 48, 2, 8).eval()
    assert ser.load_state_dict(load("ser"), strict=True)

    # the harness's head gives the port's head's logits; its WavLM the
    # port's encoder's sequence
    model = BaselineSER(CFG, head_dim=48, head_layers=2).eval()
    model.load_state_dict(sd)
    pooled = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 2 * CFG.hidden_size)).astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 7680)).astype(np.float32))
    with torch.no_grad():
        assert _rel(ser(pooled).numpy(), model.ser(pooled).numpy()) < TOL
        ref, _ = model.ssl(x)
        got = hf.eval()(x).last_hidden_state
    assert _rel(got.numpy(), ref.numpy()) < 2e-4
    ssl, pool_sd, ser_sd = baseline_to_final_pt(sd)
    assert len(ssl) + len(pool_sd) + len(ser_sd) == len(sd)


def test_train_emotion_starts_from_a_reference_pt(
        bridged, emo_config, tmp_path):  # noqa: F811
    sd, _, (online, _), _ = bridged
    path = str(tmp_path / "byol.pt")
    torch.save({"epoch": 0, "model_state_dict": sd}, path)
    config = copy.deepcopy(emo_config)
    em = config["emotion"]
    em.update(encoder_checkpoint=path, batch_size=4, classifier_epochs=1,
              unfreeze_encoder=False,
              checkpoint_dir=str(tmp_path / "ckpt"))
    model = build_classifier(copy.deepcopy(config), torch.device("cpu"), 0)
    for name, p in model.encoder.named_parameters():
        assert np.array_equal(p.detach().numpy(), online[f"encoder.{name}"])
    cfg_path = tmp_path / "emotion.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    results = train_emotion.main(["--config", str(cfg_path), "--task",
                                  "categorical", "--device", "cpu"])
    (epoch,) = results["categorical"]["epochs"]
    assert epoch["steps"] == 1 and np.isfinite(epoch["train_loss"])
    trained = results["categorical"]["state"].model
    for name, p in trained.encoder.named_parameters():  # frozen: unchanged
        assert np.array_equal(p.detach().numpy(), online[f"encoder.{name}"])
