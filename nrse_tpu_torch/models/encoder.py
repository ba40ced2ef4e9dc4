"""The reference's encoder API over the port's WavLM.

Counterpart of ``nrse_tpu/models/encoder.py:21-70``: the reference exposes
``WavLMEncoder(model_name)`` with an ``output_dim`` and a forward that
takes ``[B, T]`` or ``[B, 1, T]`` waveforms (and a mask) and returns the
last hidden state (``src/models/encoder.py:5-32``).  This gives call sites
written against it that surface on one card (bf16, the kernels' type) or
on the CPU (float32, the plain paths), under ``torch.inference_mode()``;
new code uses :class:`~nrse_tpu_torch.models.wavlm.WavLMModel` directly.
Unlike the reference, which takes and ignores the mask in the BYOL path
(``encoder.py:23-25``), the mask is honoured.  The forward runs from a
``runtime.graphs.ProgramCache`` (the counterpart of the JAX module's
jitted ``_forward``): one program a ``(B, T)`` shape and mask dtype, or
without a mask, on the card a CUDA graph reading the weights in place;
the outputs are copies.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from nrse_tpu_torch.models.convert import init_state_dict, load_hf_wavlm
from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from nrse_tpu_torch.runtime.device import resolve_device
from nrse_tpu_torch.runtime.graphs import ProgramCache, audio_inputs


class WavLMEncoder:
    """Holds the weights on ``device`` and runs the deterministic
    forward."""

    def __init__(self, model_name: str = "microsoft/wavlm-large",
                 state_dict: Optional[Mapping[str, Any]] = None,
                 seed: int = 0, config: Optional[WavLMConfig] = None,
                 device="cuda"):
        """``state_dict``: the port's WavLM state dict (tensors or numpy
        arrays, e.g. ``models.convert.load_hf_wavlm``'s or a bridged
        BYOL online encoder's), or seeded random weights
        (``models.convert.init_state_dict``) from ``seed``."""
        self.config = config or WavLMConfig.from_model_name(model_name)
        self.device = resolve_device(device)
        self.output_dim = self.config.hidden_size
        if state_dict is None:
            state_dict = init_state_dict(
                self.config, torch.Generator().manual_seed(seed))
        sd = {k: torch.as_tensor(np.asarray(v, np.float32))
              if not torch.is_tensor(v) else v.detach().cpu().float()
              for k, v in state_dict.items()}
        model = WavLMModel(self.config, device="meta")
        model.load_state_dict(sd, strict=True, assign=True)
        dtype = (torch.bfloat16 if self.device.type == "cuda"
                 else torch.float32)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        # the program caches by the mask's dtype (None: no mask)
        self.programs: Dict[Optional[torch.dtype], ProgramCache] = {}

    @classmethod
    def from_hf_checkpoint(cls, path: str,
                           config: Optional[WavLMConfig] = None,
                           device="cuda") -> "WavLMEncoder":
        """From a local HF WavLM directory, through
        ``models.convert.load_hf_wavlm``."""
        cfg = config or WavLMConfig.from_model_name(path)
        return cls(path, state_dict=load_hf_wavlm(path, cfg), config=cfg,
                   device=device)

    def _eager(self, x: torch.Tensor, m: Optional[torch.Tensor]):
        with torch.inference_mode():
            return self.model(x, m)

    def _forward(self, input_values, attention_mask):
        x = torch.as_tensor(input_values, dtype=torch.float32).to(self.device)
        if x.dim() == 3:  # [B, 1, T]
            x = x[:, 0, :]
        m = None if attention_mask is None else \
            torch.as_tensor(attention_mask).to(self.device)
        dtype = None if m is None else m.dtype
        if dtype not in self.programs:
            self.programs[dtype] = ProgramCache(
                self._eager, self.device, audio_inputs(m is not None,
                                                       dtype or torch.int32))
        return self.programs[dtype](x, m)

    def __call__(self, input_values, attention_mask=None) -> torch.Tensor:
        """``[B, T]`` or ``[B, 1, T]`` waveforms (and a ``[B, T]`` mask) →
        the last hidden state ``[B, T', C]`` on the device, in its working
        dtype."""
        return self._forward(input_values, attention_mask)[0]

    def encode_pooled(self, input_values, attention_mask=None
                      ) -> torch.Tensor:
        """The masked mean over frames, ``[B, C]``."""
        return self._forward(input_values, attention_mask)[1]
