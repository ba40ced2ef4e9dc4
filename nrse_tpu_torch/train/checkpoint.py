"""Checkpoints of the BYOL and SER train states, with resume.

Counterpart of ``nrse_tpu/train/checkpoint.py:27-183`` with ``torch.save``
in place of orbax: the same names (``best_val_loss``,
``best_val_similarity``, ``last_model``) and the same layout,
``<ckpt_dir>/<name>/state.pt`` beside ``<name>/meta.json`` (``epoch``,
``loss``, ``similarity``, ``best``).  ``state.pt`` holds
:func:`state_tensors` (the flat float32 ``params``, ``mu``, ``nu`` and
``target_params`` of ``train.byol_trainer.BYOLTrainState`` and the
BatchNorm running statistics of both towers), ``step`` and ``seed``.  It
is read back with ``torch.load(weights_only=True)`` and written into the
existing buffers in place, so the modules' parameters and gradients, which
are views of the flat buffers, stay valid.  A BYOL state under tensor
parallelism saves the ``model: 1`` layout, its model group's shards
gathered (``BYOLTrainState.checkpoint_tensors``: params, mu, nu and the
target), and restores by sharding what it reads, so every ``tpu.mesh``
writes and reads the same files, as the JAX package's orbax arrays are
global.  The SER trainers' state
(``train.emotion_trainer.EmotionTrainState``, the counterpart of the JAX
``EmotionTrainState`` these names hold there: ``best_classifier_model``,
``best_fine_tuned_model``) is kept the same way: ``params``, ``mu``,
``nu``, the Adam count as ``step``, and ``seed``.

:func:`save_model` and :func:`restore_model` keep a module's state dict
(``tensors`` only) in the same layout: the baseline fine-tune saves its
``final_model`` with them and the evaluator restores it.
:func:`load_byol_encoder` reads a BYOL checkpoint's online encoder, which
the fine-tune's ``--byol_checkpoint`` starts from.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from nrse_tpu_torch.models.byol import OnlineNetwork
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train.byol_trainer import BYOLTrainState
from nrse_tpu_torch.train.emotion_trainer import EmotionTrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"


TrainState = Union[BYOLTrainState, EmotionTrainState]


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The tensors a checkpoint holds, by name: ``params``, ``mu``, ``nu``
    and, of a BYOL state, ``target_params`` and each tower's buffers
    (``online.<name>``, ``target.<name>``: the BatchNorm running
    statistics); the state's ``tensors()`` in the ``model: 1`` layout (a
    BYOL state under a model axis gathers its shards: a collective over
    its model group)."""
    if isinstance(state, BYOLTrainState):
        return state.checkpoint_tensors()
    return state.tensors()


def save_checkpoint(ckpt_dir: str, name: str, state: TrainState,
                    metadata: Optional[Dict[str, Any]] = None,
                    tensors: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Save ``state`` under ``ckpt_dir/name`` (overwriting it); returns the
    checkpoint's directory.  ``tensors``: the state's
    :func:`state_tensors`, where the caller gathered them already (on
    every rank of a model group, to save on one).  The file is written
    whole and then renamed, so a run cut during a save leaves the previous
    checkpoint readable."""
    tensors = state_tensors(state) if tensors is None else tensors
    payload = {"tensors": {k: v.detach().cpu() for k, v in tensors.items()},
               "step": int(state.step), "seed": int(state.seed)}
    return _write(ckpt_dir, name, payload, metadata)


def _write(ckpt_dir: str, name: str, payload: Dict[str, Any],
           metadata: Optional[Dict[str, Any]]) -> str:
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(metadata or {}, f)
    return path


def _read(ckpt_dir: str, name: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(payload, metadata)`` of ``ckpt_dir/name``."""
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    metadata: Dict[str, Any] = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return saved, metadata


def restore_checkpoint(ckpt_dir: str, name: str, state: TrainState
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Load ``ckpt_dir/name`` into ``state`` in place and return ``(state,
    metadata)``.  Raises ``ValueError`` if a tensor's name or shape differs
    from the state's (another model configuration)."""
    saved, metadata = _read(ckpt_dir, name)
    sources = saved["tensors"]
    byol = isinstance(state, BYOLTrainState)
    shapes = state.checkpoint_shapes() if byol else {
        k: v.shape for k, v in state.tensors().items()}
    if sources.keys() != shapes.keys():
        raise ValueError(f"checkpoint {name!r} holds other tensors than the "
                         f"state: {sorted(sources.keys() ^ shapes.keys())}")
    for k, shape in shapes.items():
        if sources[k].shape != shape:
            raise ValueError(f"checkpoint {name!r}: {k} has shape "
                             f"{tuple(sources[k].shape)}, the state "
                             f"{tuple(shape)}")
    if byol:
        state.load_checkpoint_tensors(sources)
    else:
        with torch.no_grad():
            for k, dst in state.tensors().items():
                dst.copy_(sources[k])
    state.step = int(saved["step"])
    state.seed = int(saved["seed"])
    return state, metadata


def save_model(ckpt_dir: str, name: str, module: nn.Module,
               metadata: Optional[Dict[str, Any]] = None) -> str:
    """Save ``module``'s state dict under ``ckpt_dir/name`` (overwriting
    it); returns the checkpoint's directory."""
    payload = {"tensors": {k: v.detach().cpu()
                           for k, v in module.state_dict().items()}}
    return _write(ckpt_dir, name, payload, metadata)


def restore_model(ckpt_dir: str, name: str, module: nn.Module
                  ) -> Dict[str, Any]:
    """Load ``ckpt_dir/name`` into ``module`` and return its metadata.  A
    strict load (a missing, extra or reshaped tensor raises) that assigns
    the loaded CPU tensors as the module's parameters, so a module built
    on the meta device is filled without allocating twice."""
    saved, metadata = _read(ckpt_dir, name)
    module.load_state_dict(saved["tensors"], strict=True, assign=True)
    return metadata


def load_byol_encoder(path: str, config: WavLMConfig
                      ) -> Dict[str, torch.Tensor]:
    """The online encoder of a BYOL checkpoint (the directory
    :func:`save_checkpoint` wrote, ``<ckpt_dir>/<name>``) as a state dict
    of :class:`~nrse_tpu_torch.models.wavlm.WavLMModel` for ``config``:
    the leading part of the flat ``params``, the online tower being laid
    out encoder first.  Raises ``ValueError`` if the flat buffer is not
    that of an online tower with this encoder (its heads' widths are read
    from their BatchNorm statistics)."""
    saved, _ = _read(*os.path.split(os.path.abspath(path)))
    tensors = saved["tensors"]
    flat = tensors["params"]
    online = OnlineNetwork(
        config, tensors["online.projector.bn_1.running_mean"].numel(),
        tensors["online.predictor.bn_0.running_mean"].numel(), device="meta")
    if flat.numel() != sum(p.numel() for p in online.parameters()):
        raise ValueError(f"checkpoint {path!r} holds {flat.numel()} online "
                         f"parameters, not those of this encoder's tower")
    sd, off = {}, 0
    for name, p in online.encoder.named_parameters():
        sd[name] = flat[off:off + p.numel()].view(p.shape).clone()
        off += p.numel()
    return sd


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Name of the most recently written checkpoint in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_t = None, -1
    for name in sorted(os.listdir(ckpt_dir)):
        meta = os.path.join(ckpt_dir, name, META_FILE)
        if os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE)) and \
                os.path.exists(meta):
            t = os.stat(meta).st_mtime_ns
            if t > best_t:
                best, best_t = name, t
    return best
