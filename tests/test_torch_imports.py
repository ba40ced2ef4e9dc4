"""Guard: the port's import rule, and its wrappers launch no kernel for CPU
tensors (every LAUNCHES counter stays 0 through a tiny BYOL train step on
the CPU).

The import rule: no jax, jaxlib, flax, optax or orbax anywhere in the
port's import closure; of the JAX package only the JAX-free host modules
of ``ALLOWED`` (the data loaders, audio decoding, the native decoder's
bindings and the logger) and what they import themselves."""

import json
import subprocess
import sys
from pathlib import Path

import torch

from nrse_tpu_torch.models.convert import init_byol_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import (
    block_attention,
    fused_dropout,
    fused_ffn,
    fused_optimizer,
)
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_eval_step,
    make_byol_train_step,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "nrse_tpu_torch",
    "nrse_tpu_torch.runtime.cuda_build",
    "nrse_tpu_torch.ops.rel_pos_bias",
    "nrse_tpu_torch.ops.attention",
    "nrse_tpu_torch.ops.block_attention",
    "nrse_tpu_torch.ops.fused_ffn",
    "nrse_tpu_torch.ops.philox",
    "nrse_tpu_torch.ops.fused_dropout",
    "nrse_tpu_torch.ops.fused_optimizer",
    "nrse_tpu_torch.ops._guard",
    "nrse_tpu_torch.models.wavlm",
    "nrse_tpu_torch.models.heads",
    "nrse_tpu_torch.models.byol",
    "nrse_tpu_torch.models.convert",
    "nrse_tpu_torch.audio.augment",
    "nrse_tpu_torch.audio.features",
    "nrse_tpu_torch.train.schedules",
    "nrse_tpu_torch.train.byol_trainer",
    "nrse_tpu_torch.train.checkpoint",
    "nrse_tpu_torch.train.early_stopping",
    "nrse_tpu_torch.data.loader",
    "nrse_tpu_torch.eval.evaluate_byol",
    "nrse_tpu_torch.train_byol",
    "nrse_tpu_torch.serve.export",
]
ALLOWED = [
    "nrse_tpu.data.noisy_speech_dataset",
    "nrse_tpu.data.loader",
    "nrse_tpu.audio.io",
    "nrse_tpu.runtime.native",
    "nrse_tpu.utils.logging_utils",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _imported_modules(modules):
    """The modules a fresh interpreter holds after importing ``modules``."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def _counts():
    return (block_attention.LAUNCHES, block_attention.BWD_LAUNCHES,
            fused_ffn.LAUNCHES,
            fused_ffn.DX_LAUNCHES, fused_ffn.DW_LAUNCHES,
            fused_dropout.LAUNCHES, fused_dropout.DUMP_LAUNCHES,
            fused_optimizer.LAUNCHES)


def _top(name):
    return name.split(".")[0]


def test_port_imports_no_jax():
    port = _imported_modules(MODULES)
    assert not sorted(m for m in port if _top(m) in FORBIDDEN)
    allowed = {m for m in _imported_modules(ALLOWED)
               if _top(m) == "nrse_tpu"}
    assert set(ALLOWED) <= allowed
    assert not sorted(m for m in port if _top(m) == "nrse_tpu"
                      and m not in allowed)


def test_allowed_host_modules_import_no_jax():
    assert not sorted(m for m in _imported_modules(ALLOWED)
                      if _top(m) in FORBIDDEN)


def test_every_port_module_is_listed():
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             for p in (ROOT / "nrse_tpu_torch").rglob("*.py")}
    found = {m[:-len(".__init__")] if m.endswith(".__init__") else m
             for m in found}
    packages = {m for m in found
                if (ROOT / m.replace(".", "/") / "__init__.py").is_file()}
    assert found - packages <= set(MODULES), sorted(
        found - packages - set(MODULES))


def test_cpu_tensors_launch_no_kernel():
    before = _counts()
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
    assert _counts() == before


def test_cpu_train_step_launches_no_kernel():
    before = _counts()
    cfg = WavLMConfig.tiny()  # dropout, LayerDrop and SpecAugment on
    sd = init_byol_state_dict(cfg, 16, 32, torch.Generator().manual_seed(0))
    state = create_train_state(cfg, sd, 16, 32)
    g = torch.Generator().manual_seed(1)
    batch = {"clean": torch.randn(2, 2400, generator=g),
             "noise": torch.randn(2, 2400, generator=g),
             "snr": torch.tensor([5.0, 10.0])}
    metrics = make_byol_train_step(FusedAdamWSpec(schedule=1e-4))(state,
                                                                 batch)
    assert bool(metrics["finite"])
    loss, sim = make_byol_eval_step()(state, batch)
    assert loss.shape == sim.shape == (2,)
    assert _counts() == before
