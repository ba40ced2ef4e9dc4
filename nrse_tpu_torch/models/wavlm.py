"""The WavLM encoder in PyTorch: the serving forward and the training mode.

Port of ``nrse_tpu/models/wavlm.py``:

  raw 16 kHz waveform ``[B, T]``
    → strided conv feature encoder: for the "layer" variant of
      wavlm-large channels-last ``[B, T, C]`` from layer 0 to the
      projection, as the JAX module's ``frontend_norm="fused"`` route
      (``nrse_tpu/models/wavlm.py:365-450``): layers of stride 2, k ∈ {2,
      3} and C_in == C_out (1–6) through K6 (``ops.fused_frontend``: conv,
      channel LayerNorm and GELU in one kernel, its backward a kernel too);
      any other layer (layer 0: k = 10, s = 5, 1 → 512) as one
      ``F.linear`` over the input's window view (the conv JAX also leaves
      to its compiler), K7 (``ops.pallas_norm``, the channel LayerNorm, as
      ``frontend_norm="pallas"`` runs it) and exact GELU; for "group"
      (base_plus) channels-first cuDNN convs, GroupNorm on layer 0
    → feature projection (LayerNorm + Linear)
    → SpecAugment time masking with the learned ``masked_spec_embed``
      (training only)
    → transformer encoder: key-mask multiply, weight-normed grouped conv
      positional embedding, dropout, the bucketed relative position bias
      (once per forward, from layer 0's table: dense ``[H, T, T]`` in
      float32 at T ≤ 384, its Toeplitz generator ``[H, 2T]`` in the
      compute dtype above), LayerDrop, gated attention, the FFN through
      kernel B (``ops.fused_ffn``), pre-LN ("stable", large) or post-LN
      (base_plus) layers
    → ``(sequence [B, T', C], pooled [B, C])``, the masked mean over frames.

Attention dispatches on the frame count as the JAX module with
``use_flash_attention=True`` does (``nrse_tpu/models/wavlm.py:284-291,
898-906``): T ≤ 384 (clips up to 7.7 s) runs ``ops.block_attention`` in
both modes (kernel A forward, K3 backward, the attention-output dropout
inside them in training, as ``attn_dropout_impl="kernel"``); longer
sequences run ``ops.flash_attention`` (K5 forward, its dq and dk/dv
kernels backward), and in training the attention-output dropout after the
head merge through K1, as JAX's ``_hw_drop`` does there
(``nrse_tpu/models/wavlm.py:657-675``); K1's mask at that seed is the one
kernel A draws inside, so both paths drop alike.  The generator ``[H,
2T]`` is gathered from the table in the compute dtype, and its gradient
reaches the table through that gather.  The JAX default (off,
``bench.py:490``) runs XLA's attention
instead, a speed choice for the TPU with the same arithmetic, so the port
has no switch for it.  The
attention-output dropout draws K1's mask over the merged ``[B, T, C]``
output, so its random stream is the one a separate K1 pass there would
draw.  Training mode drops out at the post-attention hidden site and once
after the positional embedding through K1 (``ops.fused_dropout``), and at
the FFN's two sites inside kernel B and K2; LayerDrop as one host draw per
layer per step (the whole batch skips together, never layer 0);
SpecAugment spans drawn on the host.  Every random choice comes from a
:class:`TrainRNG` (seed, step, tower), which training mode requires.

Parameter names are HF ``WavLMModel``'s state-dict keys, so the layout
``nrse_tpu/models/export_torch.py`` writes loads strictly.  Numerics follow
the JAX module (``dtype=bfloat16, param_dtype=float32`` on the card): the
forward works in ``compute_dtype`` (the parameters' dtype unless set), with
each weight cast to it at its use, and float32 LayerNorm and GroupNorm
statistics, attention softmax and gates.  The frontend always runs the
``frontend_norm="fused"`` route above (K6's and K7's LayerNorm take the
fast variance ``E[x²] − E[x]²``, flax's), so the port has no switch for
it.  Left out as TPU workarounds (``ROADMAP.md``): ``seq_pad_multiple``,
``qkv_impl``, ``frontend_conv`` and ``score_dtype``, none of which changes
the valid frames' values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nrse_tpu_torch.ops import philox
from nrse_tpu_torch.ops.block_attention import MAX_T as BLOCK_MAX_T
from nrse_tpu_torch.ops.block_attention import block_gated_attention
from nrse_tpu_torch.ops.flash_attention import flash_gated_attention
from nrse_tpu_torch.ops.fused_dropout import hw_dropout
from nrse_tpu_torch.ops.fused_ffn import fused_ffn
from nrse_tpu_torch.ops.fused_frontend import KERNEL_SIZES as FUSED_KERNEL_SIZES
from nrse_tpu_torch.ops.fused_frontend import STRIDE as FUSED_STRIDE
from nrse_tpu_torch.ops.fused_frontend import fused_conv_ln_gelu
from nrse_tpu_torch.ops.pallas_norm import channel_layernorm
from nrse_tpu_torch.ops.rel_pos_bias import (
    compute_position_bias,
    rel_bias_vector,
)

# flax GroupNorm's default epsilon, which the JAX frontend keeps
GROUP_NORM_EPS = 1e-6

# dropout sites of a layer (the attention output's inside kernel A and K3;
# the FFN's two sites are sites 0 and 1 of the FFN seed inside kernel B);
# the encoder-level site takes layer ENCODER
SITE_ATTN, SITE_HIDDEN, SITE_FFN = 0, 1, 2
ENCODER = 0xFFFF
# host streams of a tower's step (the SER head's dropout takes the third)
STREAM_LAYERDROP, STREAM_SPEC_AUGMENT, STREAM_HEAD_DROPOUT = 0, 1, 2
# the data index's mixing constant of the JAX kernels' seeds under
# shard_map (``nrse_tpu/ops/kernel_rng.py:25``)
MIX_A = 0x85EBCA6B


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
    # training: dropout probabilities, LayerDrop and SpecAugment (the JAX
    # config's defaults; feat_proj_dropout is 0 there and not a field here)
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    layerdrop: float = 0.1
    # together these decide whether the checkpoint holds masked_spec_embed
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2

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

    @classmethod
    def from_model_name(cls, name: str, **kw) -> "WavLMConfig":
        """The encoder a model name names, as the JAX package's
        ``WavLMConfig.from_model_name`` picks it."""
        if "tiny" in name:
            return cls.tiny(**kw)
        if "large" in name:
            return cls.large(**kw)
        if "base" in name:
            return cls.base_plus(**kw)
        raise ValueError(f"unknown WavLM variant: {name}")

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


@dataclasses.dataclass(frozen=True)
class TrainRNG:
    """The random streams of one tower's training forward at one step.

    Counterpart of ``nrse_tpu/train/byol_trainer.py::_step_rngs`` and the
    target's ``fold_in(·, 1)`` (``nrse_tpu/models/byol.py:206-208``): every
    stream is a Philox seed pair derived on the host from (seed, step,
    tower, layer, site), so no draw ever waits for the device and the same
    seed gives the same masks on the CPU and on the card.

    Data parallelism (``rank`` of ``world`` ranks, each holding the rows
    ``[rank·b, (rank+1)·b)`` of the global batch) follows the JAX
    package's contract on an N-wide ``data`` mesh: the host draws without
    a batch axis (LayerDrop) are the same on every rank; the draws over
    the batch (SpecAugment's spans, the SER trunks' dropout) are made at
    the global batch and each rank keeps its rows (:meth:`rows`), as
    ``jax.random`` draws a global array; the kernels' dropout streams mix
    the rank into the seed (:meth:`dropout_seed`).  At world size 1 every
    stream is the one-process stream."""

    seed: int
    step: int
    tower: int = 0  # 0 online, 1 target
    rank: int = 0
    world: int = 1

    def dropout_seed(self, layer: int, site: int):
        """The seed pair of a kernel's dropout (K1, kernel A, kernel B).
        With ``world > 1`` each word is XORed with ``MIX_A·(rank + 1) mod
        2³²``, as the JAX kernels mix the data index into their seed under
        ``shard_map`` (``nrse_tpu/ops/fused_dropout.py:138-141``,
        ``fused_ffn.py:428-431``, ``block_attention.py:561-564``)."""
        k0, k1 = philox.stream_seed(self.seed, self.step, self.tower, layer,
                                    site)
        if self.world > 1:
            mix = (MIX_A * (self.rank + 1)) & philox.MASK32
            k0, k1 = k0 ^ mix, k1 ^ mix
        return k0, k1

    def generator(self, stream: int) -> torch.Generator:
        """A CPU generator for a host-side draw (LayerDrop, SpecAugment);
        the same on every rank."""
        k0, k1 = philox.stream_seed(self.seed, self.step, self.tower,
                                    0x10000 + stream)
        return torch.Generator().manual_seed((k1 << 32) | k0)

    def rows(self, draw: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a draw made at the global batch."""
        b = draw.shape[0] // self.world
        return draw[self.rank * b:(self.rank + 1) * b]


def _linear(x: torch.Tensor, module: nn.Linear) -> torch.Tensor:
    """``module`` applied in x's dtype (the weight cast at its use)."""
    bias = module.bias
    return F.linear(x, module.weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def _dropout(x, p: float, rng: Optional[TrainRNG], layer: int, site: int):
    if rng is None or p == 0.0:
        return x
    return hw_dropout(x, rng.dropout_seed(layer, site), p)


def sample_time_mask(generator: torch.Generator, batch: int, length: int,
                     prob: float, span: int, min_masks: int) -> torch.Tensor:
    """SpecAugment spans as a ``[B, T]`` bool mask on the CPU, as
    ``nrse_tpu/models/wavlm.py::_sample_time_mask`` draws them:
    ``max(min_masks, round(prob·T/span))`` spans per row, uniform starts,
    overlaps allowed."""
    n_spans = max(min_masks, int(prob * length / span + 0.5))
    starts = torch.randint(0, max(1, length - span), (batch, n_spans),
                           generator=generator)
    idx = torch.arange(length)[None, None, :]
    in_span = (idx >= starts[..., None]) & (idx < starts[..., None] + span)
    return in_span.any(dim=1)


class _LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics and a float32 result."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


def strided_conv(h, weight, bias, stride: int):
    """VALID Conv1d of channels-last ``h [B, T, C_in]`` with ``weight
    [C_out, C_in, k]``, landing channels-last ``[B, T_out, C_out]``: the
    ``[B, T_out, C_in, k]`` window view of h (a free view for C_in = 1, the
    raw-audio layer 0) times the weight as one ``F.linear``."""
    c_out, c_in, k = weight.shape
    cols = h.unfold(1, k, stride)                    # [B, T_out, C_in, k]
    cols = cols.reshape(*cols.shape[:2], c_in * k)
    return F.linear(cols, weight.reshape(c_out, c_in * k), bias)


class _ConvLayer(nn.Module):
    """One conv layer of the frontend.  With the "layer" norm it works
    channels-last, ``[B, T, C_in] → [B, T', C]``: K6 when the layer is
    K6's shape (stride 2, k ∈ {2, 3}, C_in == C_out), else the conv as
    :func:`strided_conv`, K7 and exact GELU.  Otherwise (wavlm-base-plus's
    "group") channels-first ``[B, C_in, T] → [B, C, T']``: Conv1d, a
    float32 GroupNorm on layer 0, GELU."""

    def __init__(self, config: WavLMConfig, i: int, device=None):
        super().__init__()
        c_in = config.conv_dim[i - 1] if i else 1
        dim = config.conv_dim[i]
        self.conv = nn.Conv1d(c_in, dim, config.conv_kernel[i],
                              stride=config.conv_stride[i],
                              bias=config.conv_bias, device=device)
        self.norm = None
        self.eps = config.layer_norm_eps
        if config.feat_extract_norm == "layer":
            # its parameters only: K6 or K7 normalises
            self.layer_norm = nn.LayerNorm(dim, eps=self.eps, device=device)
            self.norm = "layer"
        elif config.feat_extract_norm == "group" and i == 0:
            self.layer_norm = nn.GroupNorm(dim, dim, eps=GROUP_NORM_EPS,
                                           device=device)
            self.norm = "group"
        self.fused = (self.norm == "layer" and c_in == dim
                      and config.conv_stride[i] == FUSED_STRIDE
                      and config.conv_kernel[i] in FUSED_KERNEL_SIZES)

    def forward(self, x):  # in the working dtype
        conv = self.conv
        if self.norm == "layer":
            ln = self.layer_norm
            if self.fused:
                bias = conv.bias if conv.bias is not None else torch.zeros(
                    conv.out_channels, device=x.device)
                return fused_conv_ln_gelu(x, conv.weight.permute(2, 1, 0),
                                          bias, ln.weight, ln.bias, self.eps)
            x = strided_conv(x, conv.weight.to(x.dtype),
                             None if conv.bias is None
                             else conv.bias.to(x.dtype), conv.stride[0])
            x = channel_layernorm(x, ln.weight, ln.bias, self.eps)
            return F.gelu(x, approximate="none")
        x = F.conv1d(x, conv.weight.to(x.dtype),
                     None if conv.bias is None else conv.bias.to(x.dtype),
                     stride=conv.stride)
        if self.norm == "group":
            ln = self.layer_norm
            x = F.group_norm(x.float(), ln.num_groups, ln.weight.float(),
                             ln.bias.float(), ln.eps).to(x.dtype)
        return F.gelu(x, approximate="none")


class ConvFeatureEncoder(nn.Module):
    """Strided 1-D conv stack: 16 kHz samples → ~50 Hz frame features,
    a contiguous ``[B, T', C]``."""

    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.channels_last = config.feat_extract_norm == "layer"
        self.conv_layers = nn.ModuleList(
            _ConvLayer(config, i, device) for i in range(len(config.conv_dim)))

    def forward(self, input_values, dtype: torch.dtype):
        h = input_values.to(dtype)
        h = h[:, :, None] if self.channels_last else h[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h if self.channels_last else h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.layer_norm = _LayerNorm(config.conv_dim[-1],
                                     eps=config.layer_norm_eps, device=device)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size,
                                    device=device)

    def forward(self, x):
        return _linear(self.layer_norm(x).to(x.dtype), self.projection)


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

    def forward(self, hidden, pos_bias, key_padding_mask=None,
                dropout: float = 0.0, rng: Optional[TrainRNG] = None,
                layer: int = 0):
        """T ≤ ``BLOCK_MAX_T`` frames: kernel A (and K3 for its gradient)
        on the dense ``pos_bias [H, T, T]``, with ``rng`` (training)
        dropout ``dropout`` of the attention output inside them.  Longer:
        K5 (and its dq and dk/dv kernels for the gradient) on the generator
        ``pos_bias [H, 2T]``, then the same dropout through K1 over the
        merged ``[B, T, C]`` output: the same seed, site and flat index, so
        the same mask kernel A draws inside."""
        b, t, c = hidden.shape
        h = self.num_heads

        def split_heads(x):
            return x.view(b, t, h, c // h).transpose(1, 2)  # [B, H, T, D]

        q = split_heads(_linear(hidden, self.q_proj))
        k = split_heads(_linear(hidden, self.k_proj))
        v = split_heads(_linear(hidden, self.v_proj))
        # per-(batch, head, query) gate from the attention input
        proj = _linear(split_heads(hidden), self.gru_rel_pos_linear)
        gates = torch.sigmoid(proj.view(b, h, t, 2, 4).sum(-1).float())
        const = self.gru_rel_pos_const.float().view(1, h, 1)
        gate = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0
        p, seed = 0.0, None
        if rng is not None and dropout > 0.0:
            p, seed = dropout, rng.dropout_seed(layer, SITE_ATTN)
        if t > BLOCK_MAX_T:
            out = flash_gated_attention(q, k, v, gate, pos_bias,
                                        key_padding_mask)
            out = out.transpose(1, 2).reshape(b, t, c)
            if p > 0.0:  # JAX's _hw_drop after the head merge
                out = hw_dropout(out, seed, p)
        else:
            out = block_gated_attention(q, k, v, gate, pos_bias,
                                        key_padding_mask, p_drop=p,
                                        dropout_seed=seed)
            out = out.transpose(1, 2).reshape(b, t, c)
        return _linear(out, self.out_proj)


class FeedForward(nn.Module):
    def __init__(self, config: WavLMConfig, device=None):
        super().__init__()
        self.config = config
        self.intermediate_dense = nn.Linear(
            config.hidden_size, config.intermediate_size, device=device)
        self.output_dense = nn.Linear(
            config.intermediate_size, config.hidden_size, device=device)

    def forward(self, x, rng: Optional[TrainRNG] = None, layer: int = 0):
        """Kernel B; with ``rng`` (training), both dropout sites inside it
        and K2 as its backward."""
        cfg = self.config
        seed, p_act, p_hid = None, 0.0, 0.0
        if rng is not None:
            seed = rng.dropout_seed(layer, SITE_FFN)
            p_act, p_hid = cfg.activation_dropout, cfg.hidden_dropout
        return fused_ffn(x, self.intermediate_dense.weight,
                         self.intermediate_dense.bias,
                         self.output_dense.weight, self.output_dense.bias,
                         seed, p_act, p_hid)


class EncoderLayer(nn.Module):
    """One transformer layer, pre-LN ("stable") or post-LN."""

    def __init__(self, config: WavLMConfig, index: int, device=None):
        super().__init__()
        self.config = config
        self.index = index
        self.stable = config.do_stable_layer_norm
        self.attention = GatedAttention(config, index == 0, device)
        self.layer_norm = _LayerNorm(config.hidden_size,
                                     eps=config.layer_norm_eps, device=device)
        self.feed_forward = FeedForward(config, device)
        self.final_layer_norm = _LayerNorm(
            config.hidden_size, eps=config.layer_norm_eps, device=device)

    def forward(self, hidden, pos_bias, key_padding_mask=None,
                rng: Optional[TrainRNG] = None):
        cfg, i = self.config, self.index
        dt = hidden.dtype
        p_attn = cfg.attention_dropout if rng is not None else 0.0

        def attention(x):
            x = self.attention(x, pos_bias, key_padding_mask, p_attn, rng, i)
            return _dropout(x, cfg.hidden_dropout, rng, i, SITE_HIDDEN)

        if self.stable:
            hidden = hidden + attention(self.layer_norm(hidden).to(dt))
            y = self.final_layer_norm(hidden).to(dt)
            return hidden + self.feed_forward(y, rng, i)
        hidden = hidden + attention(hidden)
        hidden = self.layer_norm(hidden).to(dt)
        hidden = hidden + self.feed_forward(hidden, rng, i)
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
        # layers the last forward ran (fewer than all under LayerDrop)
        self.layers_run = 0

    def layer_keep(self, rng: Optional[TrainRNG]):
        """LayerDrop: one host draw per layer per step for the whole
        batch; layer 0 always runs (``nrse_tpu/models/wavlm.py:826-851``)."""
        n, p = self.config.num_hidden_layers, self.config.layerdrop
        if rng is None or p <= 0.0:
            return [True] * n
        u = torch.rand(n, generator=rng.generator(STREAM_LAYERDROP))
        keep = (u >= p).tolist()
        keep[0] = True
        return keep

    def forward(self, hidden, attention_mask=None,
                rng: Optional[TrainRNG] = None):
        cfg = self.config
        dt = hidden.dtype
        if attention_mask is not None:
            hidden = hidden * attention_mask[..., None].to(dt)
        hidden = hidden + self.pos_conv_embed(hidden)
        if not cfg.do_stable_layer_norm:
            hidden = self.layer_norm(hidden).to(dt)
        hidden = _dropout(hidden, cfg.hidden_dropout, rng, ENCODER,
                          SITE_HIDDEN)
        t = hidden.shape[1]
        table = self.layers[0].attention.rel_attn_embed.weight
        if t <= BLOCK_MAX_T:
            pos_bias = compute_position_bias(table.float(), t, t,
                                             cfg.num_buckets,
                                             cfg.max_bucket_distance)
        else:  # the flash kernel's generator, in the compute dtype
            pos_bias = rel_bias_vector(table.to(dt), t, cfg.num_buckets,
                                       cfg.max_bucket_distance)
        keep = self.layer_keep(rng)
        self.layers_run = sum(keep)
        for layer, run in zip(self.layers, keep):
            if run:
                hidden = layer(hidden, pos_bias, attention_mask, rng)
        if cfg.do_stable_layer_norm:
            hidden = self.layer_norm(hidden).to(dt)
        return hidden


class WavLMModel(nn.Module):
    """Conv frontend + projection + transformer; returns ``(sequence
    [B, T', C], pooled [B, C])`` with pooled the masked mean over frames.

    ``compute_dtype`` (default: the parameters' dtype) is the dtype the
    forward works in; training on the card keeps float32 parameters and
    computes in bf16."""

    def __init__(self, config: WavLMConfig, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
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

    def time_mask(self, rng: TrainRNG, batch: int,
                  frames: int) -> torch.Tensor:
        """SpecAugment's ``[batch, frames]`` spans of this rank's rows:
        drawn at the global batch (``batch · rng.world``), the rank's rows
        kept."""
        cfg = self.config
        return rng.rows(sample_time_mask(
            rng.generator(STREAM_SPEC_AUGMENT), batch * rng.world, frames,
            cfg.mask_time_prob, cfg.mask_time_length,
            cfg.mask_time_min_masks))

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                rng: Optional[TrainRNG] = None):
        """Eval mode ignores ``rng``; training mode needs it."""
        if self.training and rng is None:
            raise ValueError("WavLMModel in training mode needs rng (a "
                             "TrainRNG): dropout, LayerDrop and SpecAugment "
                             "draw from it")
        if not self.training:
            rng = None
        if input_values.dim() == 3:  # [B, 1, T]
            input_values = input_values[:, 0, :]
        dtype = self.compute_dtype or \
            self.feature_extractor.conv_layers[0].conv.weight.dtype
        feats = self.feature_extractor(input_values, dtype)
        frame_mask = None
        if attention_mask is not None:
            frame_mask = self.frame_mask(attention_mask, feats.shape[1])
        hidden = self.feature_projection(feats)
        if rng is not None and self.config.has_masked_spec_embed:
            spans = self.time_mask(rng, hidden.shape[0],
                                   hidden.shape[1]).to(hidden.device)
            hidden = torch.where(spans[..., None],
                                 self.masked_spec_embed.to(hidden.dtype),
                                 hidden)
        hidden = self.encoder(hidden, frame_mask, rng)
        if frame_mask is None:
            pooled = hidden.float().mean(dim=1)
        else:
            m = frame_mask[..., None].float()
            pooled = (hidden.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        return hidden, pooled.to(hidden.dtype)
