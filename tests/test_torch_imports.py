"""Guard: the port's import rule, and its wrappers launch no kernel for CPU
tensors (every LAUNCHES counter stays 0 through a tiny BYOL train step and
a tiny SER forward on the CPU).

The import rule: the port imports nothing of the JAX package — not even
its JAX-free modules; it keeps its own copies of what it needs — and no
jax, jaxlib, flax, optax, orbax or pandas (the card's machine has no
pandas).  A fresh interpreter with a ``sys.meta_path`` finder that raises
on ``nrse_tpu``, ``pandas`` and their submodules imports every module of
the port (the data-parallel ``parallel`` package and its dry run
included) and ``chip_smoke``, resolves a BYOL preset through
``train_byol`` and an emotion preset through ``config.config_utils``, and
finds ``WavLMEncoder`` in ``nrse_tpu_torch.models``.  The optional
imports (matplotlib and scikit-learn for the t-SNE plot, demucs, wandb)
sit inside the functions that need them."""

import json
import subprocess
import sys
from pathlib import Path

import torch

from nrse_tpu_torch.baseline.pipeline import BaselineSER, make_baseline_forward
from nrse_tpu_torch.models.convert import (
    init_baseline_state_dict,
    init_byol_state_dict,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops import (
    block_attention,
    flash_attention,
    fused_dropout,
    fused_ffn,
    fused_frontend,
    fused_optimizer,
    pallas_norm,
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
    "nrse_tpu_torch.runtime.device",
    "nrse_tpu_torch.runtime.native",
    "nrse_tpu_torch.ops.rel_pos_bias",
    "nrse_tpu_torch.ops.attention",
    "nrse_tpu_torch.ops.block_attention",
    "nrse_tpu_torch.ops.flash_attention",
    "nrse_tpu_torch.ops.asp_pooling",
    "nrse_tpu_torch.ops.fused_ffn",
    "nrse_tpu_torch.ops.philox",
    "nrse_tpu_torch.ops.fused_dropout",
    "nrse_tpu_torch.ops.fused_optimizer",
    "nrse_tpu_torch.ops.fused_frontend",
    "nrse_tpu_torch.ops.pallas_norm",
    "nrse_tpu_torch.ops._guard",
    "nrse_tpu_torch.models.wavlm",
    "nrse_tpu_torch.models.heads",
    "nrse_tpu_torch.models.byol",
    "nrse_tpu_torch.models.emotion",
    "nrse_tpu_torch.models.convert",
    "nrse_tpu_torch.audio.augment",
    "nrse_tpu_torch.audio.features",
    "nrse_tpu_torch.audio.io",
    "nrse_tpu_torch.audio.resample",
    "nrse_tpu_torch.utils.logging_utils",
    "nrse_tpu_torch.labels.parsing",
    "nrse_tpu_torch.train.schedules",
    "nrse_tpu_torch.train.byol_trainer",
    "nrse_tpu_torch.train.checkpoint",
    "nrse_tpu_torch.train.early_stopping",
    "nrse_tpu_torch.train.losses",
    "nrse_tpu_torch.data.loader",
    "nrse_tpu_torch.data.noisy_speech_dataset",
    "nrse_tpu_torch.eval.evaluate_byol",
    "nrse_tpu_torch.eval.metrics",
    "nrse_tpu_torch.baseline.net",
    "nrse_tpu_torch.baseline.pipeline",
    "nrse_tpu_torch.baseline.wavset",
    "nrse_tpu_torch.baseline.eval_cat_ser",
    "nrse_tpu_torch.baseline.train_ft_cat_ser",
    "nrse_tpu_torch.train_byol",
    "nrse_tpu_torch.serve.export",
    "nrse_tpu_torch.config",
    "nrse_tpu_torch.config.config_utils",
    "nrse_tpu_torch.utils.setup_utils",
    "nrse_tpu_torch.utils.wandb_utils",
    "nrse_tpu_torch.data.emotion_dataset",
    "nrse_tpu_torch.metrics.categorical_metrics",
    "nrse_tpu_torch.train.emotion_trainer",
    "nrse_tpu_torch.train.categorical_emotions",
    "nrse_tpu_torch.train.dimentional_emotions",
    "nrse_tpu_torch.train_emotion",
    "nrse_tpu_torch.evaluate_emotion",
    "nrse_tpu_torch.models.encoder",
    "nrse_tpu_torch.models.export_torch",
    "nrse_tpu_torch.serve",
    "nrse_tpu_torch.utils.profiling",
    "nrse_tpu_torch.utils.debugging_utils",
    "nrse_tpu_torch.utils.preprocess_audio_files",
    "nrse_tpu_torch.evaluate_byol",
    "nrse_tpu_torch.data.synthetic",
    "nrse_tpu_torch.data.mock",
    "nrse_tpu_torch.data.preprocess",
    "nrse_tpu_torch.data.preprocess.demucs_speech_separation",
    "nrse_tpu_torch.labels.tools",
    "nrse_tpu_torch.parallel",
    "nrse_tpu_torch.parallel.distributed",
    "nrse_tpu_torch.parallel.mesh",
    "nrse_tpu_torch.parallel.launch",
    "nrse_tpu_torch.parallel.dryrun",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas")

# a finder that refuses the JAX package and pandas (the card's machine has
# none), installed before anything else
BLOCK = (
    "import importlib, json, sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('nrse_tpu', 'pandas'):\n"
    "            raise ImportError(f'the port imported {name}')\n"
    "        return None\n"
    "sys.meta_path.insert(0, Block())\n")


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", BLOCK + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)


def _imported_modules(modules, extra: str = ""):
    """The modules a fresh interpreter with the JAX package blocked holds
    after importing ``modules`` and running ``extra``."""
    res = _run(f"for m in {modules!r}:\n"
               "    importlib.import_module(m)\n"
               + extra +
               "print(json.dumps(sorted(sys.modules)))\n")
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def _counts():
    return (block_attention.LAUNCHES, block_attention.BWD_LAUNCHES,
            flash_attention.LAUNCHES, flash_attention.DQ_LAUNCHES,
            flash_attention.DKV_LAUNCHES, fused_ffn.LAUNCHES,
            fused_ffn.DX_LAUNCHES, fused_ffn.DW_LAUNCHES,
            fused_dropout.LAUNCHES, fused_dropout.DUMP_LAUNCHES,
            fused_optimizer.LAUNCHES, fused_frontend.LAUNCHES,
            fused_frontend.BWD_LAUNCHES, pallas_norm.LAUNCHES,
            pallas_norm.BWD_LAUNCHES)


def _top(name):
    return name.split(".")[0]


def test_port_imports_no_jax():
    loaded = _imported_modules(
        MODULES + ["chip_smoke"],
        "from nrse_tpu_torch import train_byol\n"
        "cfg = train_byol.load_config('dev_wavlm-large_byol')\n"
        "assert cfg['model']['name'] == 'microsoft/wavlm-large', cfg\n"
        "from nrse_tpu_torch.config import config_utils\n"
        "cfg = config_utils.get_config(['--config',\n"
        "    'default_wavlm-large_emotion_dim_ft', '--task', 'both'])\n"
        "assert cfg['emotion']['unfreeze_encoder'] is True, cfg\n"
        "assert (cfg['device'], cfg['task']) == ('cuda', 'both'), cfg\n"
        "from nrse_tpu_torch.models import WavLMEncoder\n"
        "assert WavLMEncoder.__module__ == 'nrse_tpu_torch.models.encoder'\n")
    assert not sorted(m for m in loaded if _top(m) == "nrse_tpu")
    assert not sorted(m for m in loaded if _top(m) in FORBIDDEN)
    assert set(MODULES) | {"chip_smoke"} <= loaded


def test_blocker_refuses_the_jax_package():
    """The finder the import test relies on does refuse the JAX package,
    its JAX-free modules included, and pandas."""
    for name in ("nrse_tpu", "nrse_tpu.labels.parsing",
                 "nrse_tpu.utils.logging_utils", "pandas"):
        res = _run(f"importlib.import_module({name!r})\n")
        assert res.returncode != 0
        assert f"the port imported {_top(name)}" in res.stderr


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
    qr = q.clone().requires_grad_()  # K5's forward and backward
    flash_attention.flash_gated_attention(
        qr, k, v, gate, torch.randn(2, 16, generator=g)).sum().backward()
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
    state = create_train_state(cfg, sd, 16, 32, "cpu")
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


def test_cpu_ser_forward_launches_no_kernel():
    """Both attention paths of the SER forward (799 tiny frames: flash;
    383: block) on the CPU."""
    before = _counts()
    cfg = WavLMConfig.tiny()
    model = BaselineSER(cfg, head_dim=16)
    model.load_state_dict(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(0), head_dim=16))
    forward = make_baseline_forward(model)
    for n in (16000, 7680):
        logits = forward(torch.zeros(1, n), torch.ones(1, n))
        assert logits.shape == (1, 8) and torch.isfinite(logits).all()
    assert _counts() == before
