"""Weights for the port's WavLM: from the JAX package's param tree, or
seeded random ones.

``jax_params_to_state_dict`` is a counterpart of
``nrse_tpu/models/export_torch.py:75-158`` in pure numpy, so it needs no
JAX: it takes the JAX ``WavLMModel`` param tree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, variables)``) and returns the HF
``WavLMModel`` state-dict layout the port's module loads strictly:

  * Dense kernels ``[in, out]`` become ``[out, in]`` Linear weights;
  * conv kernels ``[k, in, out]`` become ``[out, in, k]``;
  * the scan-stacked ``encoder/layers/layer/*`` ``[L, ...]`` leaves are
    split into per-layer keys;
  * the encoder-level ``rel_attn_embed`` goes on layer 0;
  * ``gru_rel_pos_const`` ``[H]`` becomes ``[1, H, 1, 1]``;
  * the positional conv's ``weight_g``/``weight_v`` become
    ``parametrizations.weight.original0``/``original1``.

``baseline_params_to_state_dict`` does the same for the JAX baseline
pipeline (``nrse_tpu/baseline/pipeline.py::BaselineSER``): the encoder as
above under ``ssl.``, the pooling's flax leaves as they are under
``pool.`` (the port keeps their ``[in, out]`` layout and names), and the
head's Dense and LayerNorm leaves under ``ser.``.

``emotion_params_to_state_dict`` does the same for the JAX
``EmotionClassifier`` (``nrse_tpu/models/emotion.py:68-112``): the
encoder as above under ``encoder.``, the pooling's leaves as they are
under ``pooling.``, the trunks' and outputs' Dense and LayerNorm leaves
under their flax names.

``byol_variables_to_state_dicts`` does the same for the JAX
``BYOLVariables`` (online params with batch_stats, and the target) after
the layout of ``nrse_tpu/models/byol.py:113-181``: the encoder as above
under ``encoder.``, the heads' Dense kernels ``[in, out]`` →
``dense_i.weight [out, in]``, and the BatchNorm ``scale/bias`` (params)
and ``mean/var`` (batch_stats) → ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from nrse_tpu_torch.baseline.pipeline import BaselineSER
from nrse_tpu_torch.models.byol import OnlineNetwork
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel


def _f32(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy


def _dense(sd, prefix: str, tree: Mapping[str, Any], layer=None) -> None:
    def leaf(name):
        x = _f32(tree[name])
        return x if layer is None else x[layer]

    sd[f"{prefix}.weight"] = leaf("kernel").T.copy()
    if "bias" in tree:
        sd[f"{prefix}.bias"] = leaf("bias")


def _norm(sd, prefix: str, tree: Mapping[str, Any], layer=None) -> None:
    scale, bias = _f32(tree["scale"]), _f32(tree["bias"])
    if layer is not None:
        scale, bias = scale[layer], bias[layer]
    sd[f"{prefix}.weight"] = scale
    sd[f"{prefix}.bias"] = bias


def jax_params_to_state_dict(params_np: Mapping[str, Any],
                             config: WavLMConfig) -> Dict[str, np.ndarray]:
    """JAX WavLM params (numpy leaves; a ``{'params': ...}`` wrapper is
    accepted) → the port's state dict as float32 numpy arrays."""
    p = params_np.get("params", params_np)
    sd: Dict[str, np.ndarray] = {}

    fe = p["feature_extractor"]
    for i in range(len(config.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        conv = fe[f"conv_{i}"]
        sd[f"{base}.conv.weight"] = np.ascontiguousarray(
            _f32(conv["kernel"]).transpose(2, 1, 0))
        if "bias" in conv:
            sd[f"{base}.conv.bias"] = _f32(conv["bias"])
        if config.feat_extract_norm == "layer":
            _norm(sd, f"{base}.layer_norm", fe[f"layer_norm_{i}"])
        elif config.feat_extract_norm == "group" and i == 0:
            _norm(sd, f"{base}.layer_norm", fe["group_norm"])

    fp = p["feature_projection"]
    _norm(sd, "feature_projection.layer_norm", fp["layer_norm"])
    _dense(sd, "feature_projection.projection", fp["projection"])
    if "masked_spec_embed" in p:
        sd["masked_spec_embed"] = _f32(p["masked_spec_embed"])

    enc = p["encoder"]
    pc = enc["pos_conv_embed"]
    wn = "encoder.pos_conv_embed.conv.parametrizations.weight"
    sd[f"{wn}.original0"] = _f32(pc["weight_g"]).reshape(1, 1, -1)
    sd[f"{wn}.original1"] = _f32(pc["weight_v"])
    sd["encoder.pos_conv_embed.conv.bias"] = _f32(pc["bias"])
    _norm(sd, "encoder.layer_norm", enc["layer_norm"])

    layers = enc["layers"]["layer"]
    attn, ff = layers["attention"], layers["feed_forward"]
    for i in range(config.num_hidden_layers):
        base = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj",
                     "gru_rel_pos_linear"):
            _dense(sd, f"{base}.attention.{name}", attn[name], i)
        sd[f"{base}.attention.gru_rel_pos_const"] = _f32(
            attn["gru_rel_pos_const"][i]).reshape(1, -1, 1, 1)
        if i == 0:
            sd[f"{base}.attention.rel_attn_embed.weight"] = _f32(
                enc["rel_attn_embed"])
        _norm(sd, f"{base}.layer_norm", layers["layer_norm"], i)
        _norm(sd, f"{base}.final_layer_norm", layers["final_layer_norm"], i)
        for name in ("intermediate_dense", "output_dense"):
            _dense(sd, f"{base}.feed_forward.{name}", ff[name], i)
    return sd


def init_state_dict(config: WavLMConfig,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights on the CPU, at the config's full
    width, in the port's state-dict layout.

    Distributions after the JAX module's initialisers: LeCun-normal
    weights (std 1/√fan_in), normal(0, 0.02) biases (zeros in JAX; random
    here so that every bias path carries signal), unit norm scales,
    ``weight_g`` of ones and ``weight_v`` normal with std √(4 / (k·C)),
    a normal(0, 0.02) bucket table, unit ``gru_rel_pos_const`` and a
    uniform [0, 1) ``masked_spec_embed``.
    """
    shapes = {k: v.shape for k, v in
              WavLMModel(config, device="meta").state_dict().items()}
    k, c = config.num_conv_pos_embeddings, config.hidden_size
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("parametrizations.weight.original0") \
                or name.endswith("gru_rel_pos_const") \
                or ("norm" in name and name.endswith(".weight")):
            t = torch.ones(shape)
        elif name.endswith("parametrizations.weight.original1"):
            t = torch.randn(shape, generator=generator) * (4.0 / (k * c)) ** .5
        elif name.endswith("rel_attn_embed.weight") or name.endswith(".bias"):
            t = 0.02 * torch.randn(shape, generator=generator)
        elif name == "masked_spec_embed":
            t = torch.rand(shape, generator=generator)
        elif name.endswith(".weight") and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            t = torch.randn(shape, generator=generator) * fan_in ** -0.5
        else:
            raise KeyError(f"no initialiser for {name} {tuple(shape)}")
        sd[name] = t
    return sd


def _heads(sd, prefix: str, params, stats) -> None:
    for name, tree in params.items():
        if name.startswith("dense_"):
            _dense(sd, f"{prefix}.{name}", tree)
        else:  # bn_i
            _norm(sd, f"{prefix}.{name}", tree)
            sd[f"{prefix}.{name}.running_mean"] = _f32(stats[name]["mean"])
            sd[f"{prefix}.{name}.running_var"] = _f32(stats[name]["var"])


def _tower_state_dict(tower: Mapping[str, Any], config: WavLMConfig):
    params, stats = tower["params"], tower.get("batch_stats", {})
    sd = {f"encoder.{k}": v for k, v in
          jax_params_to_state_dict(params["encoder"], config).items()}
    for head in ("projector", "predictor"):
        if head in params:
            _heads(sd, head, params[head], stats[head])
    return sd


def byol_variables_to_state_dicts(variables, config: WavLMConfig):
    """JAX ``BYOLVariables`` (numpy leaves; an object with ``online`` and
    ``target`` or a mapping of them) → ``(online, target)`` state dicts of
    float32 numpy arrays for :class:`~nrse_tpu_torch.models.byol.
    OnlineNetwork` and ``TargetNetwork``."""
    def get(name):
        return variables[name] if isinstance(variables, Mapping) \
            else getattr(variables, name)
    return (_tower_state_dict(get("online"), config),
            _tower_state_dict(get("target"), config))


def init_byol_state_dict(config: WavLMConfig, projection_dim: int,
                         prediction_dim: int, generator: torch.Generator
                         ) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights of the online tower on the CPU at the
    config's full width: the encoder as :func:`init_state_dict`, the heads'
    Dense weights LeCun-normal with normal(0, 0.02) biases, BatchNorm
    scales 1 and biases 0, running mean 0 and variance 1.  The target is
    made from it by ``models.byol.make_target``."""
    sd = {f"encoder.{k}": v
          for k, v in init_state_dict(config, generator).items()}
    shapes = OnlineNetwork(config, projection_dim, prediction_dim,
                           device="meta").state_dict()
    for name, t in shapes.items():
        if name.startswith("encoder."):
            continue
        if ".dense_" in name and name.endswith(".weight"):
            sd[name] = torch.randn(t.shape, generator=generator) \
                * t.shape[1] ** -0.5
        elif ".dense_" in name:
            sd[name] = 0.02 * torch.randn(t.shape, generator=generator)
        elif name.endswith((".weight", ".running_var")):
            sd[name] = torch.ones(t.shape)
        else:  # BatchNorm bias, running_mean
            sd[name] = torch.zeros(t.shape)
    return sd


def baseline_params_to_state_dict(params_np: Mapping[str, Any],
                                  config: WavLMConfig
                                  ) -> Dict[str, np.ndarray]:
    """JAX ``BaselineSER`` params (numpy leaves; a ``{'params': ...}``
    wrapper is accepted) → :class:`~nrse_tpu_torch.baseline.pipeline.
    BaselineSER`'s state dict as float32 numpy arrays."""
    p = params_np.get("params", params_np)
    sd = {f"ssl.{k}": v for k, v in
          jax_params_to_state_dict(p["ssl"], config).items()}
    for name, leaf in p["pool"].items():
        sd[f"pool.{name}"] = _f32(leaf)
    for name, tree in p["ser"].items():
        if name.startswith("norm_"):
            _norm(sd, f"ser.{name}", tree)
        else:  # fc_i, out
            _dense(sd, f"ser.{name}", tree)
    return sd


def init_baseline_state_dict(config: WavLMConfig,
                             generator: torch.Generator,
                             head_dim: int = 1024, num_classes: int = 8,
                             head_layers: int = 1
                             ) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights of :class:`BaselineSER` on the CPU:
    the encoder as :func:`init_state_dict`; after the JAX initialisers,
    the pooling's projection LeCun-normal and its attention vector
    normal(0, 1), the head's Dense weights LeCun-normal and LayerNorm
    scales 1; every bias normal(0, 0.02)."""
    sd = {f"ssl.{k}": v for k, v in init_state_dict(config, generator).items()}
    shapes = BaselineSER(config, head_dim, num_classes, head_layers,
                         device="meta").state_dict()
    for name, t in shapes.items():
        if name.startswith("ssl."):
            continue
        if name == "pool.attention":
            sd[name] = torch.randn(t.shape, generator=generator)
        elif name == "pool.sap_linear_kernel":  # [in, out]
            sd[name] = torch.randn(t.shape, generator=generator) \
                * t.shape[0] ** -0.5
        elif "bias" in name:
            sd[name] = 0.02 * torch.randn(t.shape, generator=generator)
        elif ".norm_" in name:
            sd[name] = torch.ones(t.shape)
        else:  # Linear [out, in]
            sd[name] = torch.randn(t.shape, generator=generator) \
                * t.shape[1] ** -0.5
    return sd


def emotion_params_to_state_dict(params_np: Mapping[str, Any],
                                 config: WavLMConfig
                                 ) -> Dict[str, np.ndarray]:
    """JAX ``EmotionClassifier`` params (numpy leaves; a ``{'params':
    ...}`` wrapper is accepted) → :class:`~nrse_tpu_torch.models.emotion.
    EmotionClassifier`'s state dict as float32 numpy arrays."""
    p = params_np.get("params", params_np)
    sd = {f"encoder.{k}": v for k, v in
          jax_params_to_state_dict(p["encoder"], config).items()}
    for name, leaf in p["pooling"].items():
        sd[f"pooling.{name}"] = _f32(leaf)
    for name, tree in p.items():
        if name.endswith("_norm"):
            _norm(sd, name, tree)
        elif name.endswith(("_dense", "_out")):
            _dense(sd, name, tree)
    return sd


def init_emotion_state_dict(config: WavLMConfig, generator: torch.Generator,
                            hidden_dim: int = 1024, num_emotions: int = 8
                            ) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights of :class:`EmotionClassifier` on the
    CPU: the encoder as :func:`init_state_dict`; after the JAX
    initialisers, the pooling's projection LeCun-normal and its attention
    vector normal(0, 1), the Dense weights LeCun-normal and the LayerNorm
    scales 1; every bias normal(0, 0.02)."""
    sd = {f"encoder.{k}": v
          for k, v in init_state_dict(config, generator).items()}
    shapes = EmotionClassifier(config, hidden_dim, num_emotions=num_emotions,
                               device="meta").state_dict()
    for name, t in shapes.items():
        if name.startswith("encoder."):
            continue
        if name == "pooling.attention":
            sd[name] = torch.randn(t.shape, generator=generator)
        elif name == "pooling.sap_linear_kernel":  # [in, out]
            sd[name] = torch.randn(t.shape, generator=generator) \
                * t.shape[0] ** -0.5
        elif "bias" in name:
            sd[name] = 0.02 * torch.randn(t.shape, generator=generator)
        elif "_norm." in name:
            sd[name] = torch.ones(t.shape)
        else:  # Linear [out, in]
            sd[name] = torch.randn(t.shape, generator=generator) \
                * t.shape[1] ** -0.5
    return sd
