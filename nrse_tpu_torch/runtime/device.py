"""The device an entry point runs on, resolved one way for all of them."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``cuda`` (or ``gpu``, ``cuda:N``) or ``cpu`` as a ``torch.device``.
    Asking for the card where there is none raises: no entry point falls
    back to the CPU on its own."""
    text = str(name).lower()
    device = torch.device("cuda" if text == "gpu" else text)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but no CUDA device is "
                           "available")
    return device


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
