"""Seeded weights at the configuration's widths, made on the device.

One normal draw of the whole size from a generator on the card, cut into
the leaves by name: linear and conv weights N(0, 1/fan_in),
biases N(0, 0.02²) (not zero, so that every bias path carries a gradient),
norm scales one, the positional conv's weight-norm direction N(0, 4/(k·C))
and its gain one, the relative-position table N(0, 0.02²), the gate
constants one, ``masked_spec_embed`` U[0, 1).  Names are the HF WavLM
ones, under the prefix the program's module uses.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]


def wavlm_shapes(enc: Dict, prefix: str) -> Shapes:
    c, f, h = enc["hidden_size"], enc["intermediate_size"], \
        enc["num_attention_heads"]
    out: Shapes = []
    c_in = 1
    for i, (dim, k) in enumerate(zip(enc["conv_dim"], enc["conv_kernel"])):
        n = f"feature_extractor.conv_layers.{i}."
        out += [(n + "conv.weight", (dim, c_in, k)), (n + "conv.bias", (dim,)),
                (n + "layer_norm.weight", (dim,)),
                (n + "layer_norm.bias", (dim,))]
        c_in = dim
    k, g = enc["num_conv_pos_embeddings"], enc["num_conv_pos_embedding_groups"]
    out += [("feature_projection.layer_norm.weight", (c_in,)),
            ("feature_projection.layer_norm.bias", (c_in,)),
            ("feature_projection.projection.weight", (c, c_in)),
            ("feature_projection.projection.bias", (c,)),
            ("masked_spec_embed", (c,)),
            ("encoder.pos_conv_embed.conv.bias", (c,)),
            ("encoder.pos_conv_embed.conv.parametrizations.weight.original0",
             (1, 1, k)),
            ("encoder.pos_conv_embed.conv.parametrizations.weight.original1",
             (c, c // g, k)),
            ("encoder.layer_norm.weight", (c,)),
            ("encoder.layer_norm.bias", (c,))]
    for i in range(enc["num_hidden_layers"]):
        n = f"encoder.layers.{i}."
        a = n + "attention."
        out += [(a + "gru_rel_pos_const", (1, h, 1, 1))]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(a + proj + ".weight", (c, c)), (a + proj + ".bias", (c,))]
        out += [(a + "gru_rel_pos_linear.weight", (8, c // h)),
                (a + "gru_rel_pos_linear.bias", (8,))]
        if i == 0:
            out += [(a + "rel_attn_embed.weight", (enc["num_buckets"], h))]
        out += [(n + "layer_norm.weight", (c,)), (n + "layer_norm.bias", (c,)),
                (n + "feed_forward.intermediate_dense.weight", (f, c)),
                (n + "feed_forward.intermediate_dense.bias", (f,)),
                (n + "feed_forward.output_dense.weight", (c, f)),
                (n + "feed_forward.output_dense.bias", (c,)),
                (n + "final_layer_norm.weight", (c,)),
                (n + "final_layer_norm.bias", (c,))]
    return [(prefix + n, s) for n, s in out]


def byol_shapes(enc: Dict, model: Dict) -> Shapes:
    c, p, q = enc["hidden_size"], model["projection_dim"], \
        model["prediction_dim"]
    out = wavlm_shapes(enc, "encoder.")
    for pre, dims in (("projector.", [(c, p), (p, p)]),
                      ("predictor.", [(p, q), (q, q), (q, p)])):
        for i, (i_n, o_n) in enumerate(dims):
            out += [(f"{pre}dense_{i}.weight", (o_n, i_n)),
                    (f"{pre}dense_{i}.bias", (o_n,))]
        for i, (_, o_n) in enumerate(dims[:2]):
            out += [(f"{pre}bn_{i}.weight", (o_n,)),
                    (f"{pre}bn_{i}.bias", (o_n,))]
    return out


def ser_shapes(enc: Dict, head: Dict) -> Shapes:
    c, d, k = enc["hidden_size"], head["head_dim"], head["num_classes"]
    return wavlm_shapes(enc, "ssl.") + [
        ("pool.sap_linear_kernel", (c, c)), ("pool.sap_linear_bias", (c,)),
        ("pool.attention", (c, 1)), ("ser.fc_0.weight", (d, 2 * c)),
        ("ser.fc_0.bias", (d,)), ("ser.norm_0.weight", (d,)),
        ("ser.norm_0.bias", (d,)), ("ser.out.weight", (k, d)),
        ("ser.out.bias", (k,))]


def _fan_in(name: str, shape) -> int:
    if name.endswith("sap_linear_kernel") or name.endswith("attention"):
        return shape[0]  # stored [in, out]
    return int(np.prod(shape[1:]))


@torch.no_grad()
def make(shapes: Shapes, seed: int, device,
         enc: Dict) -> Dict[str, torch.Tensor]:
    """Float32 leaves by name, from ``seed`` on ``device``."""
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    normal = torch.randn(total, generator=gen, device=device)
    k, c = enc["num_conv_pos_embeddings"], enc["hidden_size"]
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        z = normal[off:off + n].view(shape)
        last = name.rsplit(".", 1)[-1]
        if name.endswith("original0") or name.endswith("gru_rel_pos_const") \
                or (last == "weight" and len(shape) == 1):
            t = torch.ones(shape, device=device)
        elif name.endswith("original1"):
            t = z * (4.0 / (k * c)) ** 0.5
        elif name.endswith("rel_attn_embed.weight") or last == "bias" \
                or name.endswith("sap_linear_bias"):
            t = 0.02 * z
        elif name == "masked_spec_embed" or name.endswith(".masked_spec_embed"):
            t = torch.rand(shape, generator=gen, device=device)
        else:
            t = z * _fan_in(name, shape) ** -0.5
        out[name] = t.contiguous()
        off += n
    return out
