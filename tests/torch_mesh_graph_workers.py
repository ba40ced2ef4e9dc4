"""Rank functions of ``test_torch_mesh_graphs.py``, run by
``nrse_tpu_torch.parallel.launch.run_ranks`` in gloo groups on the CPU.

As ``torch_dp_workers``: a spawned rank imports this module by name, so
it imports nothing of the JAX package, and it returns numpy or Python.
Each function runs a train step's captured parts (``train.step_graphs.
StepGraphs``, eagerly: nothing is captured on the CPU) beside the eager
mesh step on a twin state, and reports on this rank whether every output
and tensor of the two holds the same bits.
"""

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from nrse_tpu_torch.models.convert import (
    init_byol_state_dict,
    init_emotion_state_dict,
)
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.parallel.mesh import make_mesh, shard_batch
from nrse_tpu_torch.train import byol_trainer as bt
from nrse_tpu_torch.train import emotion_trainer as et
from nrse_tpu_torch.train.step_graphs import check_keep_lists
from torch_init import with_random_biases

LAYERS = 4
PROJ, PRED, HIDDEN = 16, 32, 16
STEPS = 3


def config() -> WavLMConfig:
    """Tiny WavLM at 4 layers, dropout 0.1 at every site, LayerDrop 0.3,
    SpecAugment on."""
    return dataclasses.replace(WavLMConfig.tiny(), num_hidden_layers=LAYERS,
                               layerdrop=0.3)


def _local(mesh, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in shard_batch(mesh, batch).items()}


def _differing(got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in want if not torch.equal(got[k], want[k])]


def byol_parts(rank: int, world: int, model: int,
               batch: Dict[str, np.ndarray]) -> Dict:
    """``STEPS`` BYOL steps on the ``{data: world / model, model: model}``
    mesh: each step the eager mesh step on one state, and on its twin the
    parts of ``byol_trainer.byol_step_graphs`` (the warm-up, then every
    part in replay order with the optimizer's, the layers the step's keep
    lists keep); the names that differ, the layers each tower dropped and
    whether the replicas agree."""
    cfg = config()
    mesh = make_mesh(model=model, device="cpu",
                     heads=cfg.num_attention_heads)
    sd = with_random_biases(init_byol_state_dict(
        cfg, PROJ, PRED, torch.Generator().manual_seed(8)), 8)
    eager, parts = (bt.create_train_state(cfg, sd, PROJ, PRED, "cpu",
                                          seed=5, mesh=mesh)
                    for _ in range(2))
    spec = FusedAdamWSpec(schedule=lambda c: 1e-3 / (c + 1),
                          weight_decay=1e-5, ema_decay=0.99)
    step = bt.make_byol_train_step(spec)
    local = _local(mesh, batch)
    views = {k: local[k] for k in bt.VIEW_KEYS[True]}
    differ, dropped, restored = [], [0, 0], True
    for _ in range(STEPS):
        m = step(eager, local)
        inputs = bt.step_inputs(parts, local)
        rngs = inputs.stage(parts, spec)
        keep = tuple(r.draws.keep for r in rngs)
        for t in (0, 1):
            dropped[t] += LAYERS - sum(keep[t])
        graphs = bt.byol_step_graphs(parts, spec, views, rngs, inputs, True,
                                     key=None)
        stats = [b.clone() for b in graphs.buffers]
        graphs.warm_up()
        restored &= all(torch.equal(b, s)
                        for b, s in zip(graphs.buffers, stats))
        graphs._build(None, optimizer=True, keep=keep)
        loss = graphs.outputs.get("reduce", (graphs.loss,))[0]
        grad_norm, valid_fraction, finite = graphs.outputs["optimizer"]
        got = {"loss": loss, "grad_norm": grad_norm,
               "valid_fraction": valid_fraction, "finite": finite,
               **parts.tensors(), "grads": parts.grads}
        want = {k: m[k] for k in ("loss", "grad_norm", "valid_fraction",
                                  "finite")}
        want.update(eager.tensors(), grads=eager.grads)
        differ.append(_differing(got, want))
        parts.step += 1
    return {"differ": differ, "dropped": dropped, "restored": restored,
            "agree": bt.replicas_agree(parts),
            "loss": float(m["loss"])}


SER_KEYS = (("frozen", [], 0.0, 1e-4), ("whole", list(range(LAYERS)), 1.0,
                                          5e-6))


def _ser_state(cfg, mesh, batch_size: int):
    model = EmotionClassifier(cfg, HIDDEN, dropout=0.3)
    model.load_state_dict(with_random_biases(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(3), HIDDEN), 3), strict=True)
    state = et.create_emotion_state(model, seed=11)
    _, place_state = et.make_batch_placer(mesh, batch_size)
    return place_state(state)


def ser_parts(rank: int, world: int, model: int,
              batch: Dict[str, np.ndarray]) -> Dict:
    """``STEPS`` SER steps (``task="both"``, class weights) frozen and
    with the whole encoder on the ``{data: world / model, model: model}``
    mesh: the eager mesh step on one state, and on its twin the parts of
    ``emotion_trainer.ser_step_graphs`` (the warm-up, then every part in
    replay order with the optimizer's, the layers the step's keep list
    keeps), the replicas checked after each as the step checks them; the
    names that differ and the layers dropped, per key."""
    cfg = config()
    mesh = make_mesh(model=model, device="cpu",
                     heads=cfg.num_attention_heads)
    rows = len(batch["C"])
    eager, parts = _ser_state(cfg, mesh, rows), _ser_state(cfg, mesh, rows)
    step = et.make_emotion_train_step("both")
    local = _local(mesh, batch)
    weights = torch.linspace(0.5, 1.5, 8)
    out = {}
    for name, layers, rest, lr in SER_KEYS:
        differ, dropped, reduced = [], 0, []
        for _ in range(STEPS):
            m = step(eager, local, weights, layers, lr, rest)
            segments = et.trainable_segments(parts, layers, rest)
            spec = et.adamw_spec(lr)
            inputs = et.step_inputs(parts, local)
            rng = inputs.stage(parts, "both", spec)
            dropped += LAYERS - sum(rng.draws.keep)
            graphs = et.ser_step_graphs(parts, "both", spec, segments, local,
                                        weights, rng, inputs, key=None)
            graphs.warm_up()
            graphs._build(None, optimizer=True, keep=(rng.draws.keep,))
            reduced.append("reduce" in graphs.outputs)
            got = {"loss": graphs.outputs.get("reduce", graphs.loss),
                   "grad_norm": graphs.outputs["optimizer"],
                   **parts.tensors(), "grads": parts.grads}
            want = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                    **eager.tensors(), "grads": eager.grads}
            differ.append(_differing(got, want))
            parts.step += 1
            if mesh.tp:
                et.check_replicas(parts, segments)
        out[name] = {"differ": differ, "dropped": dropped,
                     "reduced": reduced}
    return out


def keep_lists(rank: int, world: int, differ: bool) -> str:
    """``check_keep_lists`` of two keep lists that are the same on every
    rank, or (``differ``) whose second list differs on rank 1: what it
    raised, or "agree"."""
    keeps = [[True, False, True, True], [True, True, True, True]]
    if differ and rank == 1:
        keeps[1][2] = False
    mesh = make_mesh(device="cpu")
    try:
        check_keep_lists(mesh, keeps, "a step")
    except RuntimeError as e:
        return str(e)
    return "agree"
