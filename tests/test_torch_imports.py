"""Guard: the port imports neither JAX nor the JAX package, and its
wrappers launch no kernel for CPU tensors."""

import subprocess
import sys
from pathlib import Path

import torch

from nrse_tpu_torch.ops import block_attention, fused_ffn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "nrse_tpu_torch",
    "nrse_tpu_torch.runtime.cuda_build",
    "nrse_tpu_torch.ops.rel_pos_bias",
    "nrse_tpu_torch.ops.attention",
    "nrse_tpu_torch.ops.block_attention",
    "nrse_tpu_torch.ops.fused_ffn",
    "nrse_tpu_torch.models.wavlm",
    "nrse_tpu_torch.models.convert",
    "nrse_tpu_torch.serve.export",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'nrse_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cpu_tensors_launch_no_kernel():
    before = (block_attention.LAUNCHES, fused_ffn.LAUNCHES)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 64, generator=g) for _ in range(3))
    gate = torch.rand(1, 2, 8, generator=g)
    bias = torch.randn(2, 8, 8, generator=g)
    block_attention.block_gated_attention(q, k, v, gate, bias)
    x = torch.randn(5, 128, generator=g)
    fused_ffn.fused_ffn(x, torch.randn(256, 128, generator=g),
                        torch.randn(256, generator=g),
                        torch.randn(128, 256, generator=g),
                        torch.randn(128, generator=g))
    assert (block_attention.LAUNCHES, fused_ffn.LAUNCHES) == before
