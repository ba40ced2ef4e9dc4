"""What the entry-trajectory tests share (``tests/test_torch_entry_*.py``,
``tools/entry_spread.py``): the quiet encoder, Adam's eps, the checkpoints
a run wrote, and JAX's datasets listing their audio as the port's do."""

import dataclasses
import glob
import json
import os

from nrse_tpu.audio import io as jax_io
from nrse_tpu.data import emotion_dataset as jax_emotion_dataset
from nrse_tpu.data import noisy_speech_dataset as jax_noisy_dataset
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


def sorted_jax_get_audio_files(directory: str) -> list:
    """JAX's ``get_audio_files``, its paths sorted."""
    return sorted(jax_io.get_audio_files(directory))


def sorted_listing(mp) -> None:
    """JAX's datasets list their audio sorted, as the port's do: the
    port's ``audio.io.get_audio_files`` sorts its paths (one order on every
    machine) where JAX's returns ``os.walk``'s, the filesystem's.  The
    datasets index that list (BYOL's validation split and noise pick, the
    SER datasets' noise pick), so a test that holds the port's batches or
    runs to JAX's gives JAX's datasets the sorted listing, through the
    name each dataset module imported."""
    for module in (jax_noisy_dataset, jax_emotion_dataset):
        mp.setattr(module, "get_audio_files", sorted_jax_get_audio_files)
