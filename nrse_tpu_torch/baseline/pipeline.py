"""The composed baseline SER pipeline: WavLM → ASP pooling →
EmotionRegression.

Port of ``nrse_tpu/baseline/pipeline.py``: the model the challenge
scripts assemble from three torch modules (``ssl_model``/``pool_model``/
``ser_model``, ``baseline/eval_cat_ser_weighted_with_list.py:153-206``),
as one module with submodules ``ssl``, ``pool`` and ``ser``.  Parameters
are float32; ``compute_dtype`` (bf16 on the card) is the encoder's and the
pooling's working type, the head works in float32, as the JAX module with
``dtype=bfloat16, param_dtype=float32``.  Training mode (the fine-tune,
``baseline.train_ft_cat_ser``) takes a ``TrainRNG``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from nrse_tpu_torch.baseline.net import EmotionRegression
from nrse_tpu_torch.models.emotion import AttentiveStatisticsPooling
from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMConfig, WavLMModel
from nrse_tpu_torch.runtime.graphs import ProgramCache, audio_inputs


class BaselineSER(nn.Module):
    """ssl → pool → ser: ``(waveforms [B, T], mask [B, T]) → logits
    [B, num_classes]`` float32."""

    def __init__(self, encoder_config: WavLMConfig, head_dim: int = 1024,
                 num_classes: int = 8, head_layers: int = 1,
                 dropout: float = 0.5, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder_config = encoder_config
        self.ssl = WavLMModel(encoder_config, device, compute_dtype)
        self.pool = AttentiveStatisticsPooling(encoder_config.hidden_size,
                                               device)
        self.ser = EmotionRegression(2 * encoder_config.hidden_size,
                                     head_dim, head_layers, num_classes,
                                     dropout, device)

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                rng: Optional[TrainRNG] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """In training mode ``rng`` drives the encoder's dropout, LayerDrop
        and SpecAugment and the head's dropout (``deterministic=False`` in
        the JAX module; ``keep``: the head's masks as ``EmotionRegression.
        head_keep`` draws them, already on the device); eval mode ignores
        both."""
        if not self.training:
            rng = None
        seq, _ = self.ssl(input_values, attention_mask, rng)
        return self.ser(self.pool(seq, attention_mask), rng, keep)


def make_baseline_forward(model: BaselineSER,
                          graphs: bool = False) -> Callable:
    """``(waveforms [B, T], mask [B, T]) → logits [B, K]`` float32 on the
    model's device, in eval mode with no gradient.  With ``graphs`` a
    ``runtime.graphs.ProgramCache`` of it (the counterpart of the JAX
    package's forward jitted per shape): one program per ``(B, T)``, on
    the card a CUDA graph reading the weights in place, so they must keep
    their addresses."""
    model.eval()

    def forward(input_values: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(input_values, attention_mask)

    if not graphs:
        return forward
    return ProgramCache(forward, next(model.parameters()).device,
                        audio_inputs(mask_dtype=torch.float32))


def bucket_length(n: int, bucket_s: float = 5.0, sample_rate: int = 16000,
                  max_s: float = 30.0) -> int:
    """Pad a length to the next 5 s bucket, capped at 30 s, so batches of
    ragged clips come in a handful of shapes (``nrse_tpu/baseline/
    pipeline.py:58-66``)."""
    bucket = int(bucket_s * sample_rate)
    cap = int(max_s * sample_rate)
    n = min(n, cap)
    return min(((n + bucket - 1) // bucket) * bucket, cap)
