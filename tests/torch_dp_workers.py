"""Rank functions of the port's data-parallel tests, run by
``nrse_tpu_torch.parallel.launch.run_ranks`` in gloo groups on the CPU.

A spawned rank imports this module by name, so it imports nothing of the
JAX package (the JAX side of each comparison runs in the pytest
process), and every result it returns is numpy or Python.
"""

import copy
import os
from typing import Dict

import numpy as np
import torch

from nrse_tpu_torch import train_byol, train_emotion
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.parallel.distributed import barrier, is_primary
from nrse_tpu_torch.parallel.mesh import make_mesh, shard_batch
from nrse_tpu_torch.train import categorical_emotions, dimentional_emotions
from nrse_tpu_torch.train import checkpoint as checkpoint_mod
from nrse_tpu_torch.train import emotion_trainer as trainer
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_train_step,
    replicas_agree,
)
from nrse_tpu_torch.train.losses import ccc_loss, ce_weight_category
from nrse_tpu_torch.train.schedules import cosine_annealing


def _tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _numpy(module) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def whole_state_dicts(state):
    """The towers' state dicts and the flat buffers in the ``model: 1``
    layout (a tensor-parallel state's shards gathered), as numpy."""
    full = state.checkpoint_tensors()
    out = {}
    for tower, key in (("online", "params"), ("target", "target_params")):
        sd, off = {}, 0
        for name, shape in state.whole_shapes(tower).items():
            sd[name] = full[key][off:off + shape.numel()].view(shape)
            off += shape.numel()
        for name, _ in getattr(state, tower).named_buffers():
            sd[name] = full[f"{tower}.{name}"]
        out[tower] = {k: v.detach().numpy().copy() for k, v in sd.items()}
    out["flat"] = {k: v.detach().numpy().copy() for k, v in full.items()}
    return out


def byol_steps(rank, world, cfg_kwargs, online_sd, target_sd, batch,
               proj, pred, opt, steps, model=1):
    """``steps`` BYOL train steps of this rank's rows of ``batch`` on a
    ``{data: world / model, model: model}`` mesh; per step the metrics and
    whether the replicas agree, the first step's gradients, then the
    towers' state dicts and the flat buffers (all in the ``model: 1``
    layout)."""
    cfg = WavLMConfig.tiny(**cfg_kwargs)
    mesh = make_mesh(model=model, device="cpu",
                     heads=cfg.num_attention_heads)
    state = create_train_state(cfg, online_sd, proj, pred, "cpu", seed=7,
                               target_state_dict=target_sd, mesh=mesh)
    lr, total, wd, eps, ema = opt
    step = make_byol_train_step(FusedAdamWSpec(
        schedule=cosine_annealing(lr, total), weight_decay=wd, eps=eps,
        ema_decay=ema))
    local = _tensors(shard_batch(mesh, batch))
    metrics, grads = [], None
    for _ in range(steps):
        m = step(state, local)
        if grads is None:
            grads = {k: v.numpy().copy() for k, v in
                     state.gathered(state.grads, "online").items()}
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "valid_fraction": float(m["valid_fraction"]),
                        "finite": bool(m["finite"]),
                        "layers": (m["layers_online"], m["layers_target"]),
                        "agree": replicas_agree(state)})
    return {"metrics": metrics, "grads": grads, "split": state.split,
            **whole_state_dicts(state)}


def emotion_steps(rank, world, state_dict, hidden, task, batches, weights,
                  layers, rest, lrs, wd, model=1, ckpt_dir=None):
    """The SER train step on this rank's rows of each global batch (every
    random feature off) over the ``{data: world / model, model: model}``
    mesh; per step the loss, grad_norm, the summed flat gradients,
    parameters and moments.  With ``ckpt_dir``, the trainers' checkpoint
    after the last step: written by rank 0 alone, every rank waiting."""
    cfg = WavLMConfig.tiny(hidden_dropout=0.0, activation_dropout=0.0,
                           attention_dropout=0.0, layerdrop=0.0,
                           mask_time_prob=0.0)
    classifier = EmotionClassifier(cfg, hidden_dim=hidden, dropout=0.0)
    classifier.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state_dict.items()}, strict=True)
    state = trainer.create_emotion_state(classifier, seed=5)
    mesh = make_mesh(model=model, device="cpu", heads=cfg.num_attention_heads)
    place_batch, place_state = trainer.make_batch_placer(
        mesh, len(batches[0]["C"]))
    state = place_state(state)
    step = trainer.make_emotion_train_step(task, weight_decay=wd)
    out = []
    for batch, lr in zip(batches, lrs):
        m = step(state, _tensors(place_batch(batch)),
                 torch.from_numpy(weights), layers, lr, rest)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    **{k: getattr(state, k).numpy().copy()
                       for k in ("grads", "params", "mu", "nu")}})
    if ckpt_dir is not None:
        if is_primary():
            checkpoint_mod.save_checkpoint(ckpt_dir, "best_classifier_model",
                                           state, {"epoch": 0})
        barrier()
    return out


def loss_gradients(rank, world, logits, labels, weights, preds, targets):
    """This rank's part of the global CE and CCC losses and their
    gradients at its rows."""
    mesh = make_mesh(device="cpu")
    b = len(labels) // world
    rows = slice(rank * b, (rank + 1) * b)
    lg = torch.from_numpy(logits[rows]).requires_grad_()
    ce = ce_weight_category(lg, torch.from_numpy(labels[rows]),
                            torch.from_numpy(weights), mesh)
    ce.backward()
    pr = torch.from_numpy(preds[rows]).requires_grad_()
    ccc = ccc_loss(pr, torch.from_numpy(targets[rows]), mesh=mesh)
    ccc.backward()
    return {"ce": float(ce), "ce_grad": lg.grad.numpy(),
            "ccc": float(ccc), "ccc_grad": pr.grad.numpy()}


class ListLoader:
    """Global validation batches, the last one padded with its count."""

    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(copy.deepcopy(self.batches))


def _outputs(model, batch):
    """An eval step whose model is the batch: its logits and A/V/D."""
    return {"logits": batch["logits"], "dims": batch["dims"]}


def pooled_validation(rank, world, batches, batch_size, weights, model=1):
    """The categorical and dimensional validations of the SER trainers
    over this rank's rows of ``batches`` (pooled over the data axis of the
    ``{data: world / model, model: model}`` mesh when ``world > 1``; a
    process of one group of one runs them without a mesh)."""
    mesh = make_mesh(model=model, device="cpu") if world > 1 else None
    loader = ListLoader(batches, batch_size)
    w = torch.from_numpy(weights)
    loss, f1, cm, report = categorical_emotions._validate(
        None, loader, _outputs, w, torch.device("cpu"), mesh)
    c_loss, ccc, _, _ = dimentional_emotions._validate(
        None, loader, _outputs, torch.device("cpu"), mesh)
    return {"ce": loss, "f1": f1, "cm": cm, "report": report,
            "ccc_loss": c_loss, "ccc": ccc}


def _record_saves(module, saves):
    real = module.save_checkpoint

    def save(ckpt_dir, name, state, *args, **kwargs):
        saves.append(name)
        return real(ckpt_dir, name, state, *args, **kwargs)

    module.save_checkpoint = save


def entry_points(rank, world, byol_config, emotion_config):
    """``train_byol.main`` and ``train_emotion.run`` in this rank's group,
    with every checkpoint this rank writes recorded."""
    byol_saves, emotion_saves = [], []
    _record_saves(train_byol, byol_saves)
    _record_saves(categorical_emotions, emotion_saves)
    byol = train_byol.main(copy.deepcopy(byol_config))
    emotion = train_emotion.run(copy.deepcopy(emotion_config))
    return {
        "byol": [{k: e[k] for k in ("train_loss", "val_loss",
                                    "val_avg_similarity", "steps")}
                 for e in byol["epochs"]],
        "byol_stopped": byol["stopped_early"],
        "byol_flat": {k: v.numpy().copy() for k, v in
                      checkpoint_mod.state_tensors(byol["state"]).items()},
        "emotion": {task: [{k: e[k] for k in ("phase", "train_loss",
                                               "val_loss", "steps")}
                           | {"metric": e.get("f1", e.get("ccc"))}
                           for e in r["epochs"]]
                    for task, r in emotion.items()},
        "byol_saves": byol_saves, "emotion_saves": emotion_saves,
        "pid": os.getpid()}


def mesh_checks(rank, world, batch_size):
    """What ``make_mesh`` and ``shard_batch`` do in a group: the errors
    raised, the rank's rows and counts, and the ``1 × world`` mesh's
    coordinates."""
    out = {}
    for name, call in (("subset", lambda: make_mesh(data=1, device="cpu")),
                       ("heads", lambda: make_mesh(model=3, device="cpu")),
                       ("batch", lambda: make_mesh(device="cpu")
                        .local_batch(batch_size))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    mesh = make_mesh(device="cpu")
    x = np.arange(8 * 3).reshape(8, 3)
    out["rows"] = shard_batch(mesh, {"x": x})["x"]
    out["counts"] = [int(shard_batch(mesh, {"x": x, "__count__": c})
                         ["__count__"]) for c in range(9)]
    out["mesh"] = (mesh.world, mesh.rank, str(mesh.device), mesh.distributed)
    tp = make_mesh(model=world, device="cpu")
    out["model"] = (tp.data, tp.model, tp.data_index, tp.model_index)
    return out


def bn_loss_weights(shape) -> torch.Tensor:
    """Per-element weights of the BatchNorm test's loss over the global
    batch, ``Σ (y·w)²``."""
    n = shape[0] * shape[1]
    return torch.arange(1.0, n + 1).view(*shape) / n


def reduction_gradients(rank, world, x, bn_state):
    """The gradient of the global loss ``S·S`` (``S`` = the column sums of
    every rank's rows, each rank's part ``x_r·S``) at this rank's rows,
    the heads' BatchNorm over the global batch (output, input and weight
    gradients, running statistics), and ``replicas_agree`` on equal and
    on differing tensors."""
    from nrse_tpu_torch.models.heads import BatchNorm, use_mesh
    from nrse_tpu_torch.parallel.distributed import all_reduce_sum
    from nrse_tpu_torch.parallel.mesh import replicas_agree as agree

    mesh = make_mesh(device="cpu")
    b = x.shape[0] // world
    xr = torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_()
    (xr * all_reduce_sum(xr.sum(0), mesh)).sum().backward()
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in bn_state.items()})
    use_mesh(bn, mesh)
    xb = torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_()
    y = bn(xb)
    (y * bn_loss_weights(x.shape)[rank * b:(rank + 1) * b]).pow(2).sum() \
        .backward()
    same = [torch.arange(10.0), torch.ones(3, dtype=torch.float64)]
    other = [torch.arange(10.0) + (rank == 1) * 1e-6]
    return {"grad": xr.grad.numpy(), "bn_out": y.detach().numpy(),
            "bn_grad": xb.grad.numpy(),
            "bn_weight_grad": bn.weight.grad.numpy(),
            "bn_running": (bn.running_mean.numpy().copy(),
                           bn.running_var.numpy().copy()),
            "agree_same": agree(mesh, same),
            "agree_other": agree(mesh, other)}
