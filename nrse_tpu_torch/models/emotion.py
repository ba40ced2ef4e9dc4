"""The emotion classifier: categorical SER and dimensional A/V/D
regression.

Port of ``nrse_tpu/models/emotion.py:33-140`` (capability parity with the
reference's ``src/models/emotion.py:8-133`` and ``src/models/pool.py:
24-58``):

  * :class:`AttentiveStatisticsPooling` — ASP with the flax parameter
    names and layouts (``sap_linear_kernel`` ``[in, out]``,
    ``sap_linear_bias``, ``attention`` ``[in, 1]``), so the converter
    copies the JAX leaves as they are, and the math of ``ops.asp_pooling``;
  * :class:`EmotionClassifier` — encoder → ASP (2 × hidden) → the shared
    trunk (Dense → LayerNorm → ReLU → Dropout) → a categorical trunk and
    Dense to ``num_emotions``, and a dimensional trunk and Dense to 3;
    ``task ∈ {categorical, dimensional, both}`` computes only the branches
    it names.  Submodule names follow flax's (``encoder``, ``pooling``,
    ``{shared,categorical,dimensional}_{dense,norm}``, ``categorical_out``,
    ``dimensional_out``); the trunks' LayerNorm takes flax's eps 1e-6 and
    their dropout draws from ``TrainRNG``'s head stream, as
    ``baseline.net`` does;
  * :func:`gradually_unfrozen_layers` — the top-down unfreeze schedule.

Freezing is the trainer's (``train.emotion_trainer``): the JAX package
gates gradients and updates by a per-layer 0/1 scale; the port lays its
flat parameter buffer out so that what trains is a suffix of it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nrse_tpu_torch.baseline.net import LAYER_NORM_EPS
from nrse_tpu_torch.models.wavlm import (
    STREAM_HEAD_DROPOUT,
    TrainRNG,
    WavLMConfig,
    WavLMModel,
)
from nrse_tpu_torch.ops.asp_pooling import (
    attentive_stats_pool,
    frame_mask_from_wav_mask,
)

TASKS = ("categorical", "dimensional", "both")


class AttentiveStatisticsPooling(nn.Module):
    """ASP over ``[B, T, D]`` frames → ``[B, 2·D]`` float32; float32
    parameters, cast to the frames' dtype at their use."""

    def __init__(self, input_size: int, device=None):
        super().__init__()
        d = input_size
        self.sap_linear_kernel = nn.Parameter(torch.empty(d, d,
                                                          device=device))
        self.sap_linear_bias = nn.Parameter(torch.zeros(d, device=device))
        self.attention = nn.Parameter(torch.empty(d, 1, device=device))

    def forward(self, x: torch.Tensor,
                wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``wav_mask``: ``[B, T_wav]`` waveform mask (frames from the
        reference's 20 ms formula), or already ``[B, T]`` frames, or None
        (every frame valid)."""
        b, t, _ = x.shape
        if wav_mask is None:
            frame_mask = torch.ones(b, t, dtype=torch.bool, device=x.device)
        elif wav_mask.shape[1] == t:
            frame_mask = wav_mask.to(torch.bool)
        else:
            frame_mask = frame_mask_from_wav_mask(wav_mask, t)
        dt = x.dtype
        return attentive_stats_pool(x, frame_mask,
                                    self.sap_linear_kernel.to(dt),
                                    self.sap_linear_bias.to(dt),
                                    self.attention.to(dt))


class EmotionClassifier(nn.Module):
    """Encoder + ASP + shared trunk + two task branches.  Parameters are
    float32; ``compute_dtype`` (bf16 on the card) is the encoder's and the
    pooling's working type, the trunks work in float32, as the JAX module
    with ``dtype=bfloat16, param_dtype=float32``."""

    def __init__(self, encoder_config: WavLMConfig, hidden_dim: int = 1024,
                 dropout: float = 0.5, num_emotions: int = 8, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder_config = encoder_config
        self.dropout = dropout
        c = encoder_config.hidden_size
        self.encoder = WavLMModel(encoder_config, device, compute_dtype)
        self.pooling = AttentiveStatisticsPooling(c, device)
        for name, width in (("shared", 2 * c), ("categorical", hidden_dim),
                            ("dimensional", hidden_dim)):
            self.add_module(f"{name}_dense",
                            nn.Linear(width, hidden_dim, device=device))
            self.add_module(f"{name}_norm", nn.LayerNorm(
                hidden_dim, eps=LAYER_NORM_EPS, device=device))
        self.categorical_out = nn.Linear(hidden_dim, num_emotions,
                                         device=device)
        self.dimensional_out = nn.Linear(hidden_dim, 3, device=device)

    def head_keep(self, rng: TrainRNG, batch: int, task: str
                  ) -> torch.Tensor:
        """The trunks' dropout keep masks of a step, ``[3, batch, H]`` bool
        on the CPU (shared, categorical, dimensional; a trunk ``task`` does
        not run stays False), drawn as :meth:`forward` draws them: one
        generator, the trunks in that order, each at the global batch
        with this rank's rows kept."""
        gen = rng.generator(STREAM_HEAD_DROPOUT)
        keep = torch.zeros(3, batch, self.shared_dense.out_features,
                           dtype=torch.bool)
        for i, name in enumerate(("shared", "categorical", "dimensional")):
            if name == "shared" or task in (name, "both"):
                u = torch.rand((batch * rng.world, keep.shape[2]),
                               generator=gen)
                keep[i] = rng.rows(u) >= self.dropout
        return keep

    def _trunk(self, name: str, x: torch.Tensor,
               gen: Optional[torch.Generator], rng: Optional[TrainRNG],
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = getattr(self, f"{name}_norm")(getattr(self, f"{name}_dense")(x))
        h = F.relu(h)
        if rng is not None and self.dropout > 0.0:
            # flax's Dropout: keep with 1 − p, scale 1/(1 − p)
            if keep is not None:
                keep = keep[("shared", "categorical",
                             "dimensional").index(name)]
            else:  # drawn at the global batch, this rank's rows kept
                u = torch.rand((h.shape[0] * rng.world, h.shape[1]),
                               generator=gen)
                keep = (rng.rows(u) >= self.dropout).to(h.device)
            h = torch.where(keep, h / (1.0 - self.dropout),
                            torch.zeros_like(h))
        return h

    def head(self, seq: torch.Tensor, attention_mask: Optional[torch.Tensor],
             task: str = "both", rng: Optional[TrainRNG] = None,
             keep: Optional[torch.Tensor] = None
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Pooling and the trunks on the encoder's sequence: what
        :meth:`forward` returns (``rng`` None in eval mode).  ``keep``:
        the step's trunk masks as :meth:`head_keep` draws them, already on
        the device (a trainer's staged buffer), or None to draw them
        here."""
        features = self.pooling(seq, attention_mask).float()
        gen = None
        if rng is not None and self.dropout > 0.0 and keep is None:
            gen = rng.generator(STREAM_HEAD_DROPOUT)
        shared = self._trunk("shared", features, gen, rng, keep)
        logits = dims = None
        if task in ("categorical", "both"):
            logits = self.categorical_out(
                self._trunk("categorical", shared, gen, rng, keep))
        if task in ("dimensional", "both"):
            dims = self.dimensional_out(
                self._trunk("dimensional", shared, gen, rng, keep))
        return logits, dims

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                task: str = "both", rng: Optional[TrainRNG] = None,
                keep: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``(logits [B, num_emotions] | None, A/V/D [B, 3] | None)``,
        float32.  Training mode needs ``rng`` (the encoder's dropout,
        LayerDrop and SpecAugment, the trunks' dropout; ``keep`` as
        :meth:`head` takes it); eval mode ignores both."""
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        if not self.training:
            rng = None
        seq, _ = self.encoder(input_values, attention_mask, rng)
        return self.head(seq, attention_mask, task, rng, keep)


def gradually_unfrozen_layers(epoch: int, total_epochs: int,
                              total_layers: int = 24) -> list:
    """Top-down unfreeze schedule: at epoch ``e`` of ``E``, the layers from
    ``total_layers·(1 − (e + 1)/E)`` upward train (reference
    ``categorical_emotions.py:206-226``)."""
    start = int(total_layers * (1 - (epoch + 1) / total_epochs))
    return list(range(max(0, start), total_layers))
