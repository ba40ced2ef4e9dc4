"""Port → reference layout: the port's models written in the formats the
reference's own PyTorch tooling loads.

Counterpart of ``nrse_tpu/models/export_torch.py:161-287`` (the name is
kept so that a reader finds it), and the inverse of the bridge in
``models/convert.py`` (:func:`~nrse_tpu_torch.models.convert.
reference_byol_to_state_dicts`).  The port's WavLM state dict is already
HF ``WavLMModel``'s layout (the positional conv's weight norm in the
modern ``parametrizations`` spelling), so this is renames and head
layouts, no arithmetic:

  * :func:`byol_state_dicts_to_reference` and
    :func:`save_reference_byol_checkpoint` — the reference's
    ``BYOLSpeechModel`` state dict (``{online,target}_encoder.model.*``,
    the heads as ``layers.N`` of a ``Sequential``
    (``multi_layer_heads.py:4-48``), BatchNorm ``num_batches_tracked``)
    and its ``.pt`` checkpoint (``{epoch, model_state_dict,
    optimizer_state_dict, loss, similarity}``, ``train_byol.py:207-240``);
  * :func:`baseline_to_final_pt` and :func:`save_baseline_final_pt` — the
    port's ``BaselineSER`` as the challenge harness's
    ``final_{ssl,pool,ser}.pt`` (``eval_cat_ser_weighted_with_list.py:
    158-206``): HF WavLM, ``AttentiveStatisticsPooling``
    (``sap_linear.{weight,bias}`` + ``attention``, reference
    ``src/models/pool.py:30-35``) and ``net.EmotionRegression``
    (``fc.{i}.{0,1}.*`` + ``out.0.*``).

Values are float32 CPU tensors.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach().cpu().float().clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _heads_out(sd: Mapping[str, Any], src: str, dst: str, dense: tuple,
               bn: tuple) -> Dict[str, torch.Tensor]:
    """The port's ``dense_i`` / ``bn_i`` → the reference's ``layers.N``,
    with the ``num_batches_tracked`` a strict torch load requires."""
    out = {}
    for i, n in enumerate(dense):
        for leaf in ("weight", "bias"):
            out[f"{dst}.layers.{n}.{leaf}"] = _tensor(
                sd[f"{src}.dense_{i}.{leaf}"])
    for i, n in enumerate(bn):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.layers.{n}.{leaf}"] = _tensor(
                sd[f"{src}.bn_{i}.{leaf}"])
        out[f"{dst}.layers.{n}.num_batches_tracked"] = torch.tensor(
            0, dtype=torch.int64)
    return out


def byol_state_dicts_to_reference(online: Mapping[str, Any],
                                  target: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The port's ``(online, target)`` state dicts (``OnlineNetwork``,
    ``TargetNetwork``) → the reference ``BYOLSpeechModel`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tower in (("online", online), ("target", target)):
        sd.update({f"{name}_encoder.model.{k[len('encoder.'):]}": _tensor(v)
                   for k, v in tower.items() if k.startswith("encoder.")})
        sd.update(_heads_out(tower, "projector", f"{name}_projector",
                             (0, 3), (1, 4)))
    sd.update(_heads_out(online, "predictor", "online_predictor",
                         (0, 3, 6), (1, 4)))
    return sd


def save_reference_byol_checkpoint(path: str, online: Mapping[str, Any],
                                   target: Mapping[str, Any], *,
                                   epoch: int = 0, loss: float = 0.0,
                                   similarity: float = 0.0,
                                   optimizer_state: Any = None) -> None:
    """Write a reference-format BYOL ``.pt`` checkpoint that the
    reference's own bridge (``train_ft_cat_ser_weighted_checkpoint.py:
    138-160``) and :func:`~nrse_tpu_torch.models.convert.
    load_reference_byol_checkpoint` read."""
    torch.save({"epoch": epoch,
                "model_state_dict": byol_state_dicts_to_reference(online,
                                                                  target),
                "optimizer_state_dict": optimizer_state, "loss": loss,
                "similarity": similarity}, path)


def baseline_to_final_pt(state_dict: Mapping[str, Any]
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """The port's ``BaselineSER`` state dict (``ssl.*``, ``pool.*``,
    ``ser.*``) → the harness's ``(final_ssl, final_pool, final_ser)``
    state dicts."""
    ssl = {k[len("ssl."):]: _tensor(v) for k, v in state_dict.items()
           if k.startswith("ssl.")}
    pool = {"sap_linear.weight":
                _tensor(state_dict["pool.sap_linear_kernel"]).T.contiguous(),
            "sap_linear.bias": _tensor(state_dict["pool.sap_linear_bias"]),
            "attention": _tensor(state_dict["pool.attention"])}
    ser: Dict[str, torch.Tensor] = {}
    i = 0
    # net.EmotionRegression: fc = ModuleList of Sequential[Linear,
    # LayerNorm, ReLU, Dropout], out = Sequential[Linear]
    while f"ser.fc_{i}.weight" in state_dict:
        for leaf in ("weight", "bias"):
            ser[f"fc.{i}.0.{leaf}"] = _tensor(state_dict[f"ser.fc_{i}.{leaf}"])
            ser[f"fc.{i}.1.{leaf}"] = _tensor(
                state_dict[f"ser.norm_{i}.{leaf}"])
        i += 1
    for leaf in ("weight", "bias"):
        ser[f"out.0.{leaf}"] = _tensor(state_dict[f"ser.out.{leaf}"])
    return ssl, pool, ser


def save_baseline_final_pt(out_dir: str, state_dict: Mapping[str, Any],
                           prefix: str = "final") -> None:
    """Write ``{prefix}_{ssl,pool,ser}.pt`` under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    for name, sd in zip(("ssl", "pool", "ser"),
                        baseline_to_final_pt(state_dict)):
        torch.save(sd, os.path.join(out_dir, f"{prefix}_{name}.pt"))
