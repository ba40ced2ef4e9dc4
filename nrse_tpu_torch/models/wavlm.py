"""The WavLM encoder's deterministic forward in PyTorch.

Port of ``nrse_tpu/models/wavlm.py`` for serving:

  raw 16 kHz waveform ``[B, T]``
    → strided conv feature encoder (per-layer channel LayerNorm for the
      "layer" variant of wavlm-large, GroupNorm on layer 0 for "group")
    → feature projection (LayerNorm + Linear)
    → transformer encoder: key-mask multiply, weight-normed grouped conv
      positional embedding, the bucketed relative position bias
      ``[H, T, T]`` (once per forward, from layer 0's table), gated
      attention through kernel A (``ops.block_attention``), the FFN through
      kernel B (``ops.fused_ffn``), pre-LN ("stable", large) or post-LN
      (base_plus) layers
    → ``(sequence [B, T', C], pooled [B, C])``, the masked mean over frames.

Parameter names are HF ``WavLMModel``'s state-dict keys, so the layout
``nrse_tpu/models/export_torch.py`` writes loads strictly.  Numerics follow
the JAX module: work in the parameters' dtype (bf16 on the card), with
float32 LayerNorm and GroupNorm statistics, attention softmax and gates.

Forward only.  SpecAugment, dropout and LayerDrop are training features
and come with training: a module holding one raises in training mode
instead of skipping it silently.  Left out as TPU workarounds
(``ROADMAP.md``): ``seq_pad_multiple``, ``qkv_impl``, ``frontend_conv``,
``frontend_norm`` and ``score_dtype``, none of which changes the valid
frames' values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nrse_tpu_torch.ops.block_attention import block_gated_attention
from nrse_tpu_torch.ops.fused_ffn import fused_ffn
from nrse_tpu_torch.ops.rel_pos_bias import compute_position_bias

# flax GroupNorm's default epsilon, which the JAX frontend keeps
GROUP_NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """Architecture hyper-parameters (field names follow the HF config)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (large) | "group" (base)
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    # together these decide whether the checkpoint holds masked_spec_embed
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05

    def __post_init__(self):
        for name in ("conv_dim", "conv_kernel", "conv_stride"):
            object.__setattr__(self, name, tuple(getattr(self, name)))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def large(cls, **kw) -> "WavLMConfig":
        """microsoft/wavlm-large."""
        return cls(**kw)

    @classmethod
    def base_plus(cls, **kw) -> "WavLMConfig":
        """microsoft/wavlm-base-plus."""
        return cls(hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072,
                   conv_bias=False, feat_extract_norm="group",
                   do_stable_layer_norm=False, **kw)

    @classmethod
    def tiny(cls, **kw) -> "WavLMConfig":
        """The JAX package's small test configuration."""
        return cls(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, conv_dim=(32,) * 3,
                   conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                   num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, num_buckets=40,
                   max_bucket_distance=100, **kw)

    @property
    def has_masked_spec_embed(self) -> bool:
        return self.apply_spec_augment and self.mask_time_prob > 0.0

    def feature_lengths(self, input_lengths):
        """Conv-stack output length for waveform lengths (ints or int
        tensors): ``L → (L − kernel) // stride + 1`` per conv layer."""
        lengths = input_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            lengths = (lengths - k) // s + 1
        return lengths


def _forward_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} is forward-only: call .eval(). "
            "Dropout, LayerDrop and SpecAugment are not ported yet.")


class _LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics and a float32 result."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


class _ConvLayer(nn.Module):
    def __init__(self, config: WavLMConfig, i: int, device=None):
        super().__init__()
        c_in = config.conv_dim[i - 1] if i else 1
        dim = config.conv_dim[i]
        self.conv = nn.Conv1d(c_in, dim, config.conv_kernel[i],
                              stride=config.conv_stride[i],
                              bias=config.conv_bias, device=device)
        self.norm = None
        if config.feat_extract_norm == "layer":
            self.layer_norm = _LayerNorm(dim, eps=config.layer_norm_eps,
                                         device=device)
            self.norm = "layer"
        elif config.feat_extract_norm == "group" and i == 0:
            self.layer_norm = nn.GroupNorm(dim, dim, eps=GROUP_NORM_EPS,
                                           device=device)
            self.norm = "group"

    def forward(self, x):  # [B, C, T] in the working dtype
        x = self.conv(x)
        if self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).to(x.dtype).transpose(1, 2)
        elif self.norm == "group":
            ln = self.layer_norm
            x = F.group_norm(x.float(), ln.num_groups, ln.weight.float(),
                             ln.bias.float(), ln.eps).to(x.dtype)
        return F.gelu(x, approximate="none")


class ConvFeatureEncoder(nn.Module):
    """Strided 1-D conv stack: 16 kHz samples → ~50 Hz frame features."""

    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            _ConvLayer(config, i, device) for i in range(len(config.conv_dim)))

    def forward(self, input_values):
        dtype = self.conv_layers[0].conv.weight.dtype
        h = input_values.to(dtype)[:, None, :]           # [B, 1, T]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)                          # [B, T', C]


class FeatureProjection(nn.Module):
    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.layer_norm = _LayerNorm(config.conv_dim[-1],
                                     eps=config.layer_norm_eps, device=device)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size,
                                    device=device)

    def forward(self, x):
        _forward_only(self)
        return self.projection(self.layer_norm(x).to(x.dtype))


class _WeightNormParams(nn.Module):
    """The two tensors of torch's ``weight_norm`` parametrization, under
    its state-dict names: ``original0`` = g ``[1, 1, k]``, ``original1`` =
    v ``[C, C/groups, k]``."""

    def __init__(self, c: int, c_in: int, k: int, device=None):
        super().__init__()
        self.original0 = nn.Parameter(torch.ones(1, 1, k, device=device))
        self.original1 = nn.Parameter(torch.empty(c, c_in, k, device=device))


class _WeightNormConv(nn.Module):
    def __init__(self, c: int, groups: int, k: int, device=None):
        super().__init__()
        self.parametrizations = nn.ModuleDict(
            {"weight": _WeightNormParams(c, c // groups, k, device)})
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.groups = groups

    def weight(self, dtype) -> torch.Tensor:
        """Weight norm per kernel position over dims (0, 1), in float32,
        with 1e-12 inside the square root as in the JAX module."""
        wn = self.parametrizations["weight"]
        v = wn.original1.float()
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
        return (wn.original0.float() * v / norm).to(dtype)


class PositionalConvEmbedding(nn.Module):
    """Grouped, weight-normed conv positional embedding (same padding,
    the trailing frame dropped for an even kernel, then GELU)."""

    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.kernel = config.num_conv_pos_embeddings
        self.conv = _WeightNormConv(config.hidden_size,
                                    config.num_conv_pos_embedding_groups,
                                    self.kernel, device)

    def forward(self, x):  # [B, T, C]
        k = self.kernel
        out = F.conv1d(x.transpose(1, 2), self.conv.weight(x.dtype),
                       padding=k // 2, groups=self.conv.groups)
        if k % 2 == 0:
            out = out[:, :, :-1]
        out = out + self.conv.bias.to(x.dtype)[None, :, None]
        return F.gelu(out, approximate="none").transpose(1, 2)


class GatedAttention(nn.Module):
    """Self-attention with WavLM's gated relative position bias."""

    def __init__(self, config: WavLMConfig, has_rel_attn_embed: bool,
                 device=None):
        super().__init__()
        c, h = config.hidden_size, config.num_attention_heads
        self.num_heads = h
        self.q_proj = nn.Linear(c, c, device=device)
        self.k_proj = nn.Linear(c, c, device=device)
        self.v_proj = nn.Linear(c, c, device=device)
        self.out_proj = nn.Linear(c, c, device=device)
        self.gru_rel_pos_linear = nn.Linear(config.head_dim, 8, device=device)
        self.gru_rel_pos_const = nn.Parameter(
            torch.ones(1, h, 1, 1, device=device))
        if has_rel_attn_embed:  # HF keeps the shared table in layer 0
            self.rel_attn_embed = nn.Embedding(config.num_buckets, h,
                                               device=device)

    def forward(self, hidden, pos_bias, key_padding_mask=None):
        _forward_only(self)
        b, t, c = hidden.shape
        h = self.num_heads

        def split_heads(x):
            return x.view(b, t, h, c // h).transpose(1, 2)  # [B, H, T, D]

        q = split_heads(self.q_proj(hidden))
        k = split_heads(self.k_proj(hidden))
        v = split_heads(self.v_proj(hidden))
        # per-(batch, head, query) gate from the attention input
        proj = self.gru_rel_pos_linear(split_heads(hidden))     # [B,H,T,8]
        gates = torch.sigmoid(proj.view(b, h, t, 2, 4).sum(-1).float())
        const = self.gru_rel_pos_const.float().view(1, h, 1)
        gate = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0
        out = block_gated_attention(q, k, v, gate, pos_bias,
                                    key_padding_mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, c))


class FeedForward(nn.Module):
    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.intermediate_dense = nn.Linear(
            config.hidden_size, config.intermediate_size, device=device)
        self.output_dense = nn.Linear(
            config.intermediate_size, config.hidden_size, device=device)

    def forward(self, x):
        _forward_only(self)
        return fused_ffn(x, self.intermediate_dense.weight,
                         self.intermediate_dense.bias,
                         self.output_dense.weight, self.output_dense.bias)


class EncoderLayer(nn.Module):
    """One transformer layer, pre-LN ("stable") or post-LN."""

    def __init__(self, config: WavLMConfig, index: int, device=None):
        super().__init__()
        self.stable = config.do_stable_layer_norm
        self.attention = GatedAttention(config, index == 0, device)
        self.layer_norm = _LayerNorm(config.hidden_size,
                                     eps=config.layer_norm_eps, device=device)
        self.feed_forward = FeedForward(config, device)
        self.final_layer_norm = _LayerNorm(
            config.hidden_size, eps=config.layer_norm_eps, device=device)

    def forward(self, hidden, pos_bias, key_padding_mask=None):
        _forward_only(self)
        dt = hidden.dtype
        if self.stable:
            x = self.attention(self.layer_norm(hidden).to(dt), pos_bias,
                               key_padding_mask)
            hidden = hidden + x
            y = self.final_layer_norm(hidden).to(dt)
            return hidden + self.feed_forward(y)
        hidden = hidden + self.attention(hidden, pos_bias, key_padding_mask)
        hidden = self.layer_norm(hidden).to(dt)
        hidden = hidden + self.feed_forward(hidden)
        return self.final_layer_norm(hidden).to(dt)


class WavLMTransformerEncoder(nn.Module):
    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.config = config
        self.pos_conv_embed = PositionalConvEmbedding(config, device)
        self.layer_norm = _LayerNorm(config.hidden_size,
                                     eps=config.layer_norm_eps, device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(config, i, device)
            for i in range(config.num_hidden_layers))

    def forward(self, hidden, attention_mask=None):
        _forward_only(self)
        cfg = self.config
        dt = hidden.dtype
        if attention_mask is not None:
            hidden = hidden * attention_mask[..., None].to(dt)
        hidden = hidden + self.pos_conv_embed(hidden)
        if not cfg.do_stable_layer_norm:
            hidden = self.layer_norm(hidden).to(dt)
        t = hidden.shape[1]
        table = self.layers[0].attention.rel_attn_embed.weight
        pos_bias = compute_position_bias(table.float(), t, t,
                                         cfg.num_buckets,
                                         cfg.max_bucket_distance)
        for layer in self.layers:
            hidden = layer(hidden, pos_bias, attention_mask)
        if cfg.do_stable_layer_norm:
            hidden = self.layer_norm(hidden).to(dt)
        return hidden


class WavLMModel(nn.Module):
    """Conv frontend + projection + transformer; returns ``(sequence
    [B, T', C], pooled [B, C])`` with pooled the masked mean over frames."""

    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.config = config
        self.feature_extractor = ConvFeatureEncoder(config, device)
        self.feature_projection = FeatureProjection(config, device)
        if config.has_masked_spec_embed:  # SpecAugment's learned mask value
            self.masked_spec_embed = nn.Parameter(
                torch.empty(config.hidden_size, device=device))
        self.encoder = WavLMTransformerEncoder(config, device)

    def frame_mask(self, attention_mask: torch.Tensor,
                   t_frames: int) -> torch.Tensor:
        """``[B, T']`` int32 frame mask from a ``[B, T]`` sample mask."""
        lengths = self.config.feature_lengths(
            attention_mask.to(torch.int64).sum(-1))
        frames = torch.arange(t_frames, device=attention_mask.device)
        return (frames[None, :] < lengths[:, None]).to(torch.int32)

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        _forward_only(self)
        if input_values.dim() == 3:  # [B, 1, T]
            input_values = input_values[:, 0, :]
        feats = self.feature_extractor(input_values)
        frame_mask = None
        if attention_mask is not None:
            frame_mask = self.frame_mask(attention_mask, feats.shape[1])
        hidden = self.encoder(self.feature_projection(feats), frame_mask)
        if frame_mask is None:
            pooled = hidden.float().mean(dim=1)
        else:
            m = frame_mask[..., None].float()
            pooled = (hidden.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        return hidden, pooled.to(hidden.dtype)
