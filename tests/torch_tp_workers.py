"""Rank functions of the port's tensor-parallel tests, run by
``nrse_tpu_torch.parallel.launch.run_ranks`` in gloo groups on the CPU.

As ``torch_dp_workers``: a spawned rank imports this module by name, so
it imports nothing of the JAX package, and it returns numpy or Python.
"""

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from nrse_tpu_torch.models.convert import (
    init_byol_state_dict,
    init_emotion_state_dict,
)
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMConfig, WavLMModel
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.parallel.mesh import (
    gather_state_dict,
    make_mesh,
    shard_batch,
    shard_state_dict,
)
from nrse_tpu_torch.train import checkpoint
from nrse_tpu_torch.train import emotion_trainer
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_train_step,
    replicas_agree,
)
from torch_init import with_random_biases

PROJ, PRED = 32, 64


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits, so that -0.0 and 0.0 differ."""
    return t.detach().contiguous().view(torch.int32).numpy().copy()


def mesh_layout(rank, world, model) -> Dict:
    """The rank's coordinates; the sums of every rank's index over its
    data group and over its model group; its shards of the tiny BYOL state
    dict and whether gathering them gives the state dict back bit for
    bit."""
    mesh = make_mesh(model=model, device="cpu", heads=4)
    x = torch.tensor([float(rank)])
    over_data, over_model = x.clone(), x.clone()
    dist.all_reduce(over_data, group=mesh.data_group)
    dist.all_reduce(over_model, group=mesh.model_group)
    cfg = WavLMConfig.tiny()
    sd = with_random_biases(init_byol_state_dict(
        cfg, PROJ, PRED, torch.Generator().manual_seed(0)), 0)
    local = shard_state_dict(sd, mesh)
    whole = gather_state_dict(local, mesh)
    return {"coords": (mesh.data_index, mesh.model_index),
            "axes": (mesh.data, mesh.model),
            "sums": (float(over_data), float(over_model)),
            "shapes": {k: tuple(v.shape) for k, v in local.items()},
            "round_trip": list(whole) == list(sd) and all(
                np.array_equal(_bits(whole[k]), _bits(sd[k])) for k in sd)}


def encoder_k5(rank, world, model, state_dict, waves, seed):
    """The tiny encoder in training mode (dropout, LayerDrop, SpecAugment
    on) at more than 384 frames, its K5 branch, on a ``{data: world /
    model, model: model}`` mesh: this rank's sequence output and the
    gradients of ``Σ sequence · weights`` in the ``model: 1`` layout."""
    cfg = WavLMConfig.tiny()
    mesh = make_mesh(model=model, device="cpu",
                     heads=cfg.num_attention_heads)
    enc = WavLMModel(cfg, mesh=mesh)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in
                         shard_state_dict(state_dict, mesh).items()})
    enc.train()
    rows = shard_batch(mesh, {"x": waves})["x"]
    seq, _ = enc(torch.from_numpy(rows),
                 rng=TrainRNG(seed, 3, 0, mesh.data_index,
                              mesh.data).with_table(cfg.num_hidden_layers,
                                                    "cpu"))
    w = torch.linspace(-1.0, 1.0, seq.numel()).view(seq.shape)
    (seq * w).sum().backward()
    grads = gather_state_dict({k: p.grad for k, p in enc.named_parameters()},
                              mesh)
    return {"seq": seq.detach().numpy(), "layers": enc.encoder.layers_run,
            "grads": {k: v.numpy() for k, v in grads.items()}}


def tp_checkpoint(rank, world, model, cfg_kwargs, online_sd, batch, src,
                  dst) -> Dict:
    """Restore the ``model: 1`` checkpoint ``src/last_model`` into a state
    on a ``{data: world / model, model: model}`` mesh (each rank its
    shards), report whether the gathered state is the file's bit for bit,
    take one step and save it (rank 0 writes, every rank gathers) under
    ``dst/last_model``."""
    cfg = WavLMConfig.tiny(**cfg_kwargs)
    mesh = make_mesh(model=model, device="cpu",
                     heads=cfg.num_attention_heads)
    state = create_train_state(cfg, online_sd, PROJ, PRED, "cpu", seed=3,
                               mesh=mesh)
    checkpoint.restore_checkpoint(src, "last_model", state)
    saved = torch.load(f"{src}/last_model/{checkpoint.STATE_FILE}",
                       weights_only=True)["tensors"]
    whole = checkpoint.state_tensors(state)
    same = whole.keys() == saved.keys() and all(
        np.array_equal(_bits(whole[k]), _bits(saved[k])) for k in saved)
    step = make_byol_train_step(FusedAdamWSpec(schedule=1e-3))
    local = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in shard_batch(mesh, batch).items()}
    metrics = step(state, local)
    tensors = checkpoint.state_tensors(state)
    if rank == 0:
        checkpoint.save_checkpoint(dst, "last_model", state, {"epoch": 0},
                                   tensors)
    dist.barrier()
    return {"restored_bit_equal": same, "agree": replicas_agree(state),
            "loss": float(metrics["loss"]), "step": state.step}


SER_HIDDEN = 16


def ser_replicated_steps(rank, world, model, batches, layers) -> Dict:
    """Two SER train steps (``task="both"``, every random feature of the
    tiny classifier on) over the ``{data: world / model, model: model}``
    mesh, from seeded weights; the flat buffers' bits and the losses.  A
    process alone (``world`` 1) runs them without a group."""
    cfg = WavLMConfig.tiny()
    classifier = EmotionClassifier(cfg, hidden_dim=SER_HIDDEN, dropout=0.3)
    classifier.load_state_dict(with_random_biases(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(3), SER_HIDDEN), 3), strict=True)
    state = emotion_trainer.create_emotion_state(classifier, seed=11)
    mesh = make_mesh(model=model, device="cpu",
                     heads=cfg.num_attention_heads)
    place_batch, place_state = emotion_trainer.make_batch_placer(
        mesh, len(batches[0]["C"]))
    state = place_state(state)
    step = emotion_trainer.make_emotion_train_step("both")
    losses, runs = [], []
    for batch in batches:
        m = step(state, {k: torch.from_numpy(v)
                         for k, v in place_batch(batch).items()},
                 None, layers, 1e-3)
        losses.append(_bits(m["loss"].reshape(1)))
        runs.append(m["layers_run"])
    return {"losses": losses, "layers_run": runs,
            **{k: _bits(getattr(state, k)) for k in ("params", "mu", "nu")}}
