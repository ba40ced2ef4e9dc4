"""The rule every CUDA kernel entry keeps under autograd.

A kernel's output is written through ``ctypes`` into a tensor made by
``torch.empty``: autograd knows nothing of it, so it has no ``grad_fn``.
Called on inputs that require grad with grad mode on, such an entry would
silently cut every gradient that should flow through it.  Entries that
sit inside a ``torch.autograd.Function`` run with grad mode off and pass;
any other entry raises instead of detaching.
"""

from __future__ import annotations

import torch


def require_no_grad(*tensors, what: str) -> None:
    """Raise ``RuntimeError`` if grad mode is on and any of ``tensors``
    (``None`` entries are skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward here and its output "
            "would be detached from autograd; call it under torch.no_grad() "
            "or use the differentiable path")
