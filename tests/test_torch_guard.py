"""The autograd guard of the port's CUDA kernel entries
(``nrse_tpu_torch/ops/_guard.py``).

A kernel writes its output through ``ctypes`` into a tensor autograd knows
nothing of; called under autograd on inputs that require grad, it would
return an output detached from them, and every gradient through it would
be lost without an error.  The guard raises instead; it passes under
``torch.no_grad()`` (where the autograd Functions call the kernels) and
for inputs that need no grad.  Each raw CUDA entry runs it before
touching the device, so the CPU can show it.
"""

import pytest
import torch

from nrse_tpu_torch.ops import (
    block_attention,
    fused_dropout,
    fused_ffn,
    fused_optimizer,
)
from nrse_tpu_torch.ops._guard import require_no_grad

torch.set_num_threads(1)


def test_raises_for_a_tensor_that_requires_grad():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="detached"):
        require_no_grad(torch.ones(3), None, x, what="k")


def test_passes_under_no_grad_and_without_grad():
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        require_no_grad(x, what="k")
    require_no_grad(torch.ones(3), None, what="k")


def _entries():
    q = torch.ones(1, 1, 4, 64, requires_grad=True)
    gate, bias = torch.ones(1, 1, 4), torch.ones(1, 4, 4)
    w = torch.ones(128, 128, requires_grad=True)
    b = torch.ones(128)
    drop = fused_ffn._Drop()
    buf = torch.ones(8, requires_grad=True)
    madd, lse = torch.zeros(1, 4), torch.zeros(1, 1, 4)
    return {
        "kernel A": lambda: block_attention._kernel_fwd(q, q, q, gate, bias,
                                                        None),
        "K3": lambda: block_attention._kernel_bwd(
            q, q, q, gate, bias, madd, q, lse, q, block_attention._Drop()),
        "kernel B": lambda: fused_ffn._kernel_fwd(torch.ones(4, 128), w, b,
                                                  w, b, drop, False),
        "K1": lambda: fused_dropout._launch(0, buf, None, buf, 8),
        "K4": lambda: fused_optimizer._kernel(torch.ones(9), buf, buf, buf,
                                              buf, None),
    }


@pytest.mark.parametrize("entry", ["kernel A", "kernel B", "K1", "K4",
                                   "K3"])
def test_cuda_entries_refuse_autograd(entry):
    with pytest.raises(RuntimeError, match="detached"):
        _entries()[entry]()


def test_kernel_a_names_its_missing_backward():
    with pytest.raises(RuntimeError, match="K3"):
        _entries()["kernel A"]()
