"""A plain WavLM encoder (the large, pre-LN variant) as functions of a
parameter dict, in float32, for the benchmark's correctness check.

The equations are the published WavLM's (Chen et al., 2022; HF
``WavLMModel`` names): a 7-layer strided conv frontend with a LayerNorm
over channels and exact GELU, a LayerNorm + Linear feature projection,
SpecAugment time spans replaced by the learned ``masked_spec_embed``, a
weight-normed grouped positional conv, the bucketed relative position
bias with the gated (GRU-style) scaling, pre-LN layers with LayerDrop, a
final LayerNorm.  The dropout sites and draws are the ones the port's
training mode states (``draws.py``): the attention output (over the merged
``[B, T, C]`` heads), the attention block's output, the FFN activation and
output, and once after the positional embedding.

``q`` is applied to both operands of every product (convs and linears) and
is the identity for the float32 reference; the control puts a lower
precision there.  Every layer runs under ``torch.utils.checkpoint``, so a
full-width batch fits beside the card's other contents; the masks are pure
functions of the seed, so the recomputation draws the same ones.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import draws as D

NEG = -1e9


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448), then back to float32; the gradient passes
    straight through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (r - x).detach()


PRECISIONS = {"float32": identity, "fp8": fp8_round}


def conv_lengths(cfg: Dict, n):
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return n


def bucket_index(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """``[T, T]`` bucket of the offset ``key - query`` (T5's bidirectional
    buckets, as WavLM uses them)."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    half = num_buckets // 2
    exact = half // 2
    a = np.abs(rel)
    with np.errstate(divide="ignore"):
        large = (exact + np.log(np.maximum(a / exact, 1e-20))
                 / math.log(max_distance / exact) * (half - exact)
                 ).astype(np.int64)
    large = np.minimum(large, half - 1)
    return (rel > 0) * half + np.where(a < exact, a, large)


class WavLM:
    """``forward(x [B, T], mask [B, T] | None, draws | None)`` →
    ``(sequence [B, T', C], pooled [B, C], frame mask | None)``; training
    mode when ``draws`` (a :class:`draws.StepDraws`) is given."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 prefix: str = "", q: Callable = identity):
        self.cfg, self.p, self.pre, self.q = cfg, params, prefix, q

    def w(self, name: str) -> torch.Tensor:
        return self.p[self.pre + name]

    def lin(self, x, name):
        return F.linear(self.q(x), self.q(self.w(name + ".weight")),
                        self.w(name + ".bias"))

    def ln(self, x, name, eps=None):
        eps = self.cfg["layer_norm_eps"] if eps is None else eps
        return F.layer_norm(x, x.shape[-1:], self.w(name + ".weight"),
                            self.w(name + ".bias"), eps)

    def frontend(self, x):
        cfg, h = self.cfg, x[:, None, :]
        for i, (k, s) in enumerate(zip(cfg["conv_kernel"],
                                       cfg["conv_stride"])):
            name = f"feature_extractor.conv_layers.{i}"
            h = F.conv1d(self.q(h), self.q(self.w(name + ".conv.weight")),
                         self.w(name + ".conv.bias"), stride=s)
            h = self.ln(h.transpose(1, 2), name + ".layer_norm")
            h = F.gelu(h).transpose(1, 2)
        return h.transpose(1, 2)  # [B, T', C]

    def pos_conv(self, h):
        k = self.cfg["num_conv_pos_embeddings"]
        g = self.w("encoder.pos_conv_embed.conv.parametrizations.weight."
                   "original0")
        v = self.w("encoder.pos_conv_embed.conv.parametrizations.weight."
                   "original1")
        weight = g * v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True)
                                    + 1e-12)
        out = F.conv1d(self.q(h.transpose(1, 2)), self.q(weight),
                       self.w("encoder.pos_conv_embed.conv.bias"),
                       padding=k // 2,
                       groups=self.cfg["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)

    def position_bias(self, t: int, device) -> torch.Tensor:
        cfg = self.cfg
        idx = torch.from_numpy(bucket_index(
            t, cfg["num_buckets"], cfg["max_bucket_distance"])).to(device)
        table = self.w("encoder.layers.0.attention.rel_attn_embed.weight")
        return table[idx].permute(2, 0, 1)  # [H, T, T]

    def attention(self, x, i, bias, madd, dr):
        cfg = self.cfg
        b, t, c = x.shape
        h = cfg["num_attention_heads"]
        d = c // h
        name = f"encoder.layers.{i}.attention"

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)

        q = heads(self.lin(x, name + ".q_proj"))
        k = heads(self.lin(x, name + ".k_proj"))
        v = heads(self.lin(x, name + ".v_proj"))
        g = F.linear(heads(x), self.w(name + ".gru_rel_pos_linear.weight"),
                     self.w(name + ".gru_rel_pos_linear.bias"))
        g = torch.sigmoid(g.view(b, h, t, 2, 4).sum(-1))
        const = self.w(name + ".gru_rel_pos_const").reshape(1, h, 1)
        gate = g[..., 0] * (g[..., 1] * const - 1.0) + 2.0
        scores = torch.matmul(self.q(q), self.q(k).transpose(-1, -2)) \
            / math.sqrt(d)
        scores = scores + gate[..., None] * bias[None] + madd[:, None, None]
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(self.q(probs), self.q(v))
        out = out.transpose(1, 2).reshape(b, t, c)
        if dr is not None:
            out = out * dr.mask(i, D.SITE_ATTN, 0, out.shape,
                                cfg["attention_dropout"], out.device)
        return self.lin(out, name + ".out_proj")

    def ffn(self, y, i, dr):
        cfg = self.cfg
        name = f"encoder.layers.{i}.feed_forward"
        a = F.gelu(self.lin(y, name + ".intermediate_dense"))
        if dr is not None:
            a = a * dr.mask(i, D.SITE_FFN, D.FFN_ACT, a.shape,
                            cfg["activation_dropout"], a.device)
        o = self.lin(a, name + ".output_dense")
        if dr is not None:
            o = o * dr.mask(i, D.SITE_FFN, D.FFN_OUT, o.shape,
                            cfg["hidden_dropout"], o.device)
        return o

    def layer(self, hidden, i, bias, madd, dr):
        name = f"encoder.layers.{i}"
        a = self.attention(self.ln(hidden, name + ".layer_norm"), i, bias,
                           madd, dr)
        if dr is not None:
            a = a * dr.mask(i, D.SITE_HIDDEN, 0, a.shape,
                            self.cfg["hidden_dropout"], a.device)
        hidden = hidden + a
        return hidden + self.ffn(self.ln(hidden, name + ".final_layer_norm"),
                                 i, dr)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                dr: Optional[D.StepDraws] = None):
        cfg = self.cfg
        feats = self.frontend(x)
        b, t, _ = feats.shape
        frame_mask = None
        if mask is not None:
            lengths = conv_lengths(cfg, mask.to(torch.int64).sum(-1))
            frame_mask = (torch.arange(t, device=x.device)[None]
                          < lengths[:, None]).to(torch.float32)
        hidden = self.lin(self.ln(feats, "feature_projection.layer_norm"),
                          "feature_projection.projection")
        keep = [True] * cfg["num_hidden_layers"]
        if dr is not None:
            spans = dr.time_mask(b, t, cfg["mask_time_prob"],
                                 cfg["mask_time_length"],
                                 cfg["mask_time_min_masks"]).to(x.device)
            hidden = torch.where(spans[..., None],
                                 self.w("masked_spec_embed"), hidden)
            keep = dr.layer_keep(cfg["num_hidden_layers"], cfg["layerdrop"])
        if frame_mask is not None:
            hidden = hidden * frame_mask[..., None]
        hidden = hidden + self.pos_conv(hidden)
        if dr is not None:
            hidden = hidden * dr.mask(D.ENCODER, D.SITE_HIDDEN, 0,
                                      hidden.shape, cfg["hidden_dropout"],
                                      hidden.device)
        bias = self.position_bias(t, x.device)
        madd = torch.zeros(b, t, device=x.device) if frame_mask is None \
            else (1.0 - frame_mask) * NEG
        for i, run in enumerate(keep):
            if run:
                hidden = checkpoint(self.layer, hidden, i, bias, madd, dr,
                                    use_reentrant=False)
        hidden = self.ln(hidden, "encoder.layer_norm")
        if frame_mask is None:
            pooled = hidden.mean(dim=1)
        else:
            pooled = (hidden * frame_mask[..., None]).sum(1) \
                / frame_mask.sum(1, keepdim=True).clamp_min(1.0)
        return hidden, pooled, keep
