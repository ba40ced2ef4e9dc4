"""NaN/Inf/degenerate-value guards for tensors and arrays.

Counterpart of ``nrse_tpu/utils/debugging_utils.py:21-56`` (parity with
the reference's ``src/utils/debugging_utils.py:4-30``,
``check_audio_tensor``): warns on NaN, Inf, near-silent or exploding
values and logs the statistics at DEBUG level.  Takes torch tensors (on
any device) and numpy arrays.  Reading a tensor on the card makes the host
wait for it, so with a ``config`` the check runs only when
``logging.level`` is DEBUG.  :func:`enable_nan_debugging` turns on
autograd's anomaly detection, the counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import numpy as np
import torch

from nrse_tpu_torch.utils.logging_utils import logger


def check_audio_tensor(x, name: str = "tensor", config=None) -> bool:
    """Validate an audio or activation tensor; returns True when healthy."""
    if config is not None:
        level = str(config.get("logging", {}).get("level", "INFO")).upper()
        if level != "DEBUG":
            return True

    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    arr = np.asarray(x)
    ok = True
    if np.isnan(arr).any():
        logger.warning(f"{name} contains NaN values!")
        ok = False
    if np.isinf(arr).any():
        logger.warning(f"{name} contains Inf values!")
        ok = False
    amax = float(np.max(np.abs(arr))) if arr.size else 0.0
    if amax < 1e-8:
        logger.warning(f"{name} values too small (near zero): max abs {amax}")
        ok = False
    if amax > 1e6:
        logger.warning(f"{name} values too large: max abs {amax}")
        ok = False
    logger.debug(
        f"{name}: shape={arr.shape} dtype={arr.dtype} "
        f"min={float(arr.min()) if arr.size else 0.0:.6g} "
        f"max={float(arr.max()) if arr.size else 0.0:.6g} "
        f"mean={float(arr.mean()) if arr.size else 0.0:.6g}"
    )
    return ok


def enable_nan_debugging() -> None:
    """Turn on autograd's anomaly detection: a backward that makes NaN
    raises with the forward op's traceback (slow; for debugging only)."""
    torch.autograd.set_detect_anomaly(True)
