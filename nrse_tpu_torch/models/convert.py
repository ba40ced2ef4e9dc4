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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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
