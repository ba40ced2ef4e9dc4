"""Convert a checkpoint of the JAX package (orbax) into the port's layout.

    JAX_PLATFORMS=cpu python tools/orbax_to_torch.py \\
        --checkpoint <jax ckpt_dir>/<name> --out <port ckpt_dir>/<name> \\
        --model_name microsoft/wavlm-large [--seed 0]

Reads ``<name>/state`` through ``nrse_tpu/train/checkpoint.py::
restore_checkpoint_raw`` and writes ``<name>/state.pt`` and
``<name>/meta.json`` as ``nrse_tpu_torch/train/checkpoint.py`` does, with
the weights moved by ``nrse_tpu_torch/models/convert.py``.  The kind is
read from the state's structure:

  * a ``train_byol`` state (``variables``: online and target): the port's
    ``BYOLTrainState`` (``save_checkpoint``), which ``train_byol --resume``
    and ``load_byol_encoder`` read;
  * a SER trainer's ``EmotionTrainState`` (``params`` and ``opt_state``):
    the port's ``EmotionTrainState``;
  * a baseline fine-tune's ``final_model`` (``params`` holding ``ssl``):
    the port's ``save_model`` of a ``BaselineSER``, which
    ``baseline.eval_cat_ser`` reads.

AdamW's ``mu`` and ``nu`` and its count are carried over where the state
holds them (optax's ``ScaleByAdamState``); the port's random streams have
no JAX key, so their root is ``--seed``.  The encoder's depth is read from
the stacked layers, its widths from ``--model_name``.  This tool imports
JAX, orbax and both packages, as the tests do; the port itself never
imports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nrse_tpu.train.checkpoint import restore_checkpoint_raw  # noqa: E402
from nrse_tpu_torch.baseline.pipeline import BaselineSER  # noqa: E402
from nrse_tpu_torch.models.byol import OnlineNetwork  # noqa: E402
from nrse_tpu_torch.models.convert import (  # noqa: E402
    baseline_params_to_state_dict,
    byol_variables_to_state_dicts,
    emotion_params_to_state_dict,
)
from nrse_tpu_torch.models.emotion import EmotionClassifier  # noqa: E402
from nrse_tpu_torch.models.wavlm import WavLMConfig  # noqa: E402
from nrse_tpu_torch.train import checkpoint  # noqa: E402
from nrse_tpu_torch.train.byol_trainer import create_train_state  # noqa
from nrse_tpu_torch.train.emotion_trainer import (  # noqa: E402
    create_emotion_state,
)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree) if hasattr(tree, "shape") else tree


def _adam_state(opt_state) -> Optional[Dict[str, Any]]:
    """The first node of ``opt_state`` holding ``count``, ``mu`` and
    ``nu`` (optax's ``ScaleByAdamState``, wherever the chain nests it)."""
    if isinstance(opt_state, dict):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        children = list(opt_state.values())
    elif isinstance(opt_state, (list, tuple)):
        children = list(opt_state)
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def encoder_config(encoder_params, model_name: str) -> WavLMConfig:
    """``model_name``'s encoder at the depth of the stacked layers."""
    q = encoder_params["encoder"]["layers"]["layer"]["attention"]["q_proj"]
    return dataclasses.replace(WavLMConfig.from_model_name(model_name),
                               num_hidden_layers=int(q["kernel"].shape[0]))


def _tensors(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _flat(module: torch.nn.Module, sd) -> torch.Tensor:
    """``sd`` laid out as the port's flat buffer of ``module``'s
    parameters (their registration order)."""
    module.load_state_dict(_tensors(sd), strict=True, assign=True)
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def convert_byol(raw, model_name: str, seed: int):
    variables = _np_tree(raw["variables"])
    cfg = encoder_config(variables["online"]["params"]["encoder"],
                         model_name)
    online, target = byol_variables_to_state_dicts(variables, cfg)
    proj = online["projector.bn_1.running_mean"].shape[0]
    pred = online["predictor.bn_0.running_mean"].shape[0]
    state = create_train_state(cfg, online, proj, pred, "cpu", seed=seed,
                               target_state_dict=target)
    state.step = int(np.asarray(raw["step"]))
    adam = _adam_state(_np_tree(raw["opt_state"]))
    if adam is not None:
        stats = variables["online"]["batch_stats"]
        for name in ("mu", "nu"):
            moment, _ = byol_variables_to_state_dicts(
                {"online": {"params": adam[name], "batch_stats": stats},
                 "target": variables["target"]}, cfg)
            getattr(state, name).copy_(_flat(OnlineNetwork(
                cfg, proj, pred, device="meta"), moment))
        state.step = int(np.asarray(adam["count"]))
    return state


def convert_emotion(raw, model_name: str, seed: int):
    params = _np_tree(raw["params"])
    cfg = encoder_config(params["encoder"], model_name)

    def model(tree):
        sd = emotion_params_to_state_dict(tree, cfg)
        m = EmotionClassifier(
            cfg, sd["shared_dense.weight"].shape[0],
            num_emotions=sd["categorical_out.weight"].shape[0],
            device="meta")
        m.load_state_dict(_tensors(sd), strict=True, assign=True)
        return m

    state = create_emotion_state(model(params), seed)
    state.step = int(np.asarray(raw["step"]))
    adam = _adam_state(_np_tree(raw["opt_state"]))
    if adam is not None:
        for name in ("mu", "nu"):
            getattr(state, name).copy_(
                create_emotion_state(model(adam[name])).params)
        state.step = int(np.asarray(adam["count"]))
    return state


def convert_baseline(raw, model_name: str) -> BaselineSER:
    params = _np_tree(raw["params"])
    cfg = encoder_config(params["ssl"], model_name)
    sd = baseline_params_to_state_dict(params, cfg)
    layers = sum(1 for k in sd if k.startswith("ser.fc_")
                 and k.endswith(".weight"))
    module = BaselineSER(cfg, sd["ser.out.weight"].shape[1],
                         sd["ser.out.weight"].shape[0], layers,
                         device="meta")
    module.load_state_dict(_tensors(sd), strict=True, assign=True)
    return module


def convert(jax_path: str, out_path: str, model_name: str,
            seed: int = 0) -> str:
    """Convert ``jax_path`` (``<ckpt_dir>/<name>``) into ``out_path``;
    returns the kind (``byol``, ``emotion`` or ``baseline``)."""
    ckpt_dir, name = os.path.split(os.path.abspath(jax_path))
    raw = restore_checkpoint_raw(ckpt_dir, name)
    meta_path = os.path.join(jax_path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    out_dir, out_name = os.path.split(os.path.abspath(out_path))
    if "variables" in raw:
        kind = "byol"
        checkpoint.save_checkpoint(out_dir, out_name,
                                   convert_byol(raw, model_name, seed), meta)
    elif "opt_state" in raw:
        kind = "emotion"
        checkpoint.save_checkpoint(out_dir, out_name,
                                   convert_emotion(raw, model_name, seed),
                                   meta)
    else:
        kind = "baseline"
        checkpoint.save_model(out_dir, out_name,
                              convert_baseline(raw, model_name), meta)
    return kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="a JAX checkpoint, <ckpt_dir>/<name>")
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint to write, <ckpt_dir>/<name>")
    ap.add_argument("--model_name", default="microsoft/wavlm-large")
    ap.add_argument("--seed", type=int, default=0,
                    help="root of the port's random streams")
    args = ap.parse_args(argv)
    kind = convert(args.checkpoint, args.out, args.model_name, args.seed)
    print(f"converted the {kind} checkpoint {args.checkpoint} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
