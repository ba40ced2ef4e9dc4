"""SNR-controlled noise mixing and the BYOL views, on device tensors.

Port of ``nrse_tpu/audio/augment.py:37-72,115-148``: mixing at a target
SNR with a per-item ``valid`` flag in place of the reference's
``None``-on-failure, peak normalisation, and the two views of the BYOL
step (mix → peak-normalise both → z-normalise both).
"""

from __future__ import annotations

from typing import Tuple

import torch

from nrse_tpu_torch.audio.features import zero_mean_unit_var


def mix_at_snr(speech: torch.Tensor, noise: torch.Tensor, snr_db,
               eps_power: float = 1e-10
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``speech + noise · √(Ps / (Pn·10^(snr/10) + eps))`` for ``[B, T]``
    (or ``[T]``) waveforms and a scalar or ``[B]`` SNR in dB.  Returns
    ``(noisy, valid)``; where speech or noise power is below 1e-10 or the
    scale is not finite or above 1e6, ``valid`` is False and no noise is
    added."""
    speech_power = (speech ** 2).mean(-1)
    noise_power = (noise ** 2).mean(-1)
    snr = torch.as_tensor(snr_db, dtype=speech.dtype, device=speech.device)
    snr_linear = 10.0 ** (snr / 10.0)
    scaling = torch.sqrt(speech_power / (noise_power * snr_linear
                                         + eps_power))
    valid = ((speech_power >= 1e-10) & (noise_power >= 1e-10)
             & torch.isfinite(scaling) & (scaling <= 1e6))
    scaling = torch.where(valid, scaling, torch.zeros_like(scaling))
    if speech.dim() == 2:
        scaling = scaling[:, None]
    return speech + noise * scaling, valid


def peak_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``x / (max|x| + eps)`` along the last axis."""
    return x / (x.abs().amax(-1, keepdim=True) + eps)


def make_byol_views(clean: torch.Tensor, noise: torch.Tensor, snr_db
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(clean_views, noisy_views, valid)`` for ``clean, noise [B, T]``
    and ``snr_db [B]``."""
    noisy, valid = mix_at_snr(clean, noise, snr_db)
    return (zero_mean_unit_var(peak_normalize(clean)),
            zero_mean_unit_var(peak_normalize(noisy)), valid)
