"""What the entry-trajectory tests share (``tests/test_torch_entry_*.py``,
``tools/entry_spread.py``): the quiet encoder, Adam's eps and the
checkpoints a run wrote."""

import dataclasses
import glob
import json
import os

from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu_torch.models.wavlm import WavLMConfig

QUIET = dict(hidden_dropout=0.0, activation_dropout=0.0,
             attention_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0)
# Adam's eps on both sides, as in tests/test_torch_train_step.py: at 1e-8
# Adam turns a gradient that is zero in exact arithmetic and float32 noise
# on each side (a Dense bias feeding a BatchNorm) into ±lr
EPS = 1e-3


def quiet_names(mp, variant=None) -> None:
    """Both packages' ``WavLMConfig.from_model_name`` give the named
    encoder with every dropout, LayerDrop and SpecAugment off (the two
    sides draw their masks from different generators); JAX's with
    ``variant``'s fields too (its other float32 paths,
    ``tools/entry_spread.py``)."""
    for cls, extra in ((JaxWavLMConfig, variant or {}), (WavLMConfig, {})):
        real = cls.from_model_name

        def quiet(_cls, name, _real=real, _extra=extra, **kw):
            return dataclasses.replace(_real(name, **kw), **QUIET, **_extra)
        mp.setattr(cls, "from_model_name", classmethod(quiet))


def checkpoints(ckpt_dir) -> dict:
    """``{name: meta.json}`` of the checkpoints under ``ckpt_dir``."""
    out = {}
    for meta in sorted(glob.glob(os.path.join(ckpt_dir, "*", "meta.json"))):
        with open(meta) as f:
            out[os.path.basename(os.path.dirname(meta))] = json.load(f)
    return out
