"""Shared machinery of the categorical and dimensional SER trainers.

Port of ``nrse_tpu/train/emotion_trainer.py:36-243`` (the reference's
two trainers share a skeleton: BYOL encoder → classifier → phase 1 with
the encoder frozen → optional phase 2 unfreezing it top-down at a lower
LR; AdamW + ReduceLROnPlateau; validation per epoch).  One train step:
the waveform's z-norm on the device, the classifier in training mode, the
task's loss (weighted CE, or CCC over A/V/D; "both" sums the two, a
single step the JAX package does not have, where it raises), the backward
pass into one flat float32 gradient buffer, the global norm of the
trainable gradients, and ``clip_by_global_norm(1.0) → adamw(lr, wd)``
(``nrse_tpu/train/schedules.py:43-56``) as one K4 launch
(``ops.fused_optimizer``, no EMA) over the trainable parameters.  The LR
is the plateau's current value, given to each step.

Freezing.  The JAX step gates both the gradients and the updates by a
per-layer 0/1 scale on the stacked encoder layers and ``rest_scale`` on
the encoder's other parameters (``emotion_trainer.py:119-139``,
``models/emotion.py:144-167``), so a frozen parameter stays bit-identical:
no weight decay reaches it.  The port lays the flat buffers out as the
encoder's non-layer parameters (the conv frontend, the projection,
``masked_spec_embed``, the positional conv, the final LayerNorm and the
relative-position table, which JAX keeps outside its layers), then
``encoder.layers.0 … L−1``, then the heads, each group starting on a
multiple of 4 floats (K4's 16-byte alignment).  The layers the unfreeze
schedule opens are always the top ones (:func:`~nrse_tpu_torch.models.
emotion.gradually_unfrozen_layers`), so what trains is a suffix of the
buffer (two segments where ``rest_scale`` is 1 with only some layers
open): K4 runs over it alone, the frozen moments stay zero, and the
frozen parameters have ``requires_grad`` off, so the frozen layers run
without a graph (no K3 or K2 for them) and keep their bits.  The branch
that ``task`` does not run has zero gradients and is still decayed, as
optax decays it.  The encoder stays in training mode when frozen:
dropout, LayerDrop and SpecAugment draw as in JAX's
``deterministic=False``.  The Adam count goes on across the phases.

Data parallelism (a state with a ``parallel.mesh.DataMesh``, placed by
:func:`make_batch_placer`): every rank builds the same seeded global batch
and keeps its rows (``nrse_tpu/train/emotion_trainer.py:172-209`` shards
it over the mesh); the losses take the global batch's denominators and
moments (``train.losses``), the trunks' dropout masks are drawn at the
global batch, and after the backward one ``all_reduce`` per trainable
segment sums the gradients, so every rank takes the same K4 step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nrse_tpu_torch.audio.features import zero_mean_unit_var
from nrse_tpu_torch.models.emotion import TASKS, EmotionClassifier
from nrse_tpu_torch.models.wavlm import TrainRNG
from nrse_tpu_torch.ops.fused_optimizer import (
    FusedAdamWSpec,
    fused_adamw_ema_update,
)
from nrse_tpu_torch.parallel.mesh import DataMesh, broadcast_state, shard_batch
from nrse_tpu_torch.train.losses import ccc_loss, ce_weight_category

ALIGN = 4  # floats: K4 takes 16-byte aligned buffers


@dataclasses.dataclass
class EmotionTrainState:
    """Everything the train step carries.  Every parameter of ``model`` is
    a view of ``params`` and its ``.grad`` a view of ``grads``; ``mu`` and
    ``nu`` are AdamW's moments.  ``starts`` holds the first element of each
    group: the encoder's non-layer parameters (0), layer ``i`` (``starts[1
    + i]``), the heads (``starts[-1]``).  ``step`` is the Adam count and the
    step of the random streams, ``seed`` their root; ``mesh`` the data mesh
    (None: one process)."""

    model: EmotionClassifier
    params: torch.Tensor
    grads: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    starts: Tuple[int, ...]
    step: int = 0
    seed: int = 0
    trainable: Optional[Tuple] = None  # (layers, rest) set last
    mesh: Optional[DataMesh] = None

    @property
    def num_layers(self) -> int:
        return len(self.starts) - 2

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tensors a checkpoint holds and the replicas share:
        ``params``, ``mu`` and ``nu``."""
        return {k: getattr(self, k) for k in ("params", "mu", "nu")}


def parameter_groups(model: EmotionClassifier
                     ) -> List[List[torch.nn.Parameter]]:
    """The encoder's non-layer parameters, each layer's, the heads'."""
    layers = [[] for _ in range(model.encoder_config.num_hidden_layers)]
    rest, heads = [], []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "encoder":
            heads.append(p)
        elif parts[1:3] == ["encoder", "layers"] \
                and not name.endswith("rel_attn_embed.weight"):
            layers[int(parts[3])].append(p)
        else:
            rest.append(p)
    return [rest] + layers + [heads]


def create_emotion_state(model: EmotionClassifier, seed: int = 0
                         ) -> EmotionTrainState:
    """The state at step 0 for ``model`` (on its device, in training mode):
    the parameters moved into the flat buffer, ``mu = nu = 0``, everything
    trainable until the first step says otherwise."""
    groups = parameter_groups(model)
    starts, off = [], 0
    for group in groups:
        starts.append(off)
        off += sum(p.numel() for p in group)
        off = -(-off // ALIGN) * ALIGN
    device = next(model.parameters()).device
    flat = torch.zeros(off, dtype=torch.float32, device=device)
    grads = torch.zeros_like(flat)
    for start, group in zip(starts, groups):
        o = start
        for p in group:
            n = p.numel()
            flat[o:o + n].copy_(p.detach().reshape(-1))
            p.data = flat[o:o + n].view_as(p)
            p.grad = grads[o:o + n].view_as(p)
            o += n
    return EmotionTrainState(model=model.train(), params=flat, grads=grads,
                             mu=torch.zeros_like(flat),
                             nu=torch.zeros_like(flat), starts=tuple(starts),
                             seed=int(seed))


def load_encoder_into_classifier(state_dict: Mapping,
                                 encoder_state_dict: Mapping) -> Dict:
    """The classifier's state dict with its encoder replaced by a
    pre-trained one (reference ``categorical_emotions.py:45-50``: load the
    BYOL checkpoint, take its online encoder)."""
    out = {k: v for k, v in state_dict.items()
           if not k.startswith("encoder.")}
    out.update({f"encoder.{k}": v for k, v in encoder_state_dict.items()})
    return out


def trainable_segments(state: EmotionTrainState, layers: Sequence[int],
                       rest_scale: float = 0.0) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` ranges of the flat buffers that train with the
    unfrozen ``layers`` and ``rest_scale`` (0: the encoder's other
    parameters frozen, 1: trainable); sets ``requires_grad`` to match.
    ``layers`` must be the top ones, ``range(k, L)``, as the unfreeze
    schedule gives them."""
    n = state.num_layers
    layers = sorted(int(i) for i in layers)
    first = layers[0] if layers else n
    if layers != list(range(first, n)):
        raise ValueError(f"unfrozen layers {layers} are not the top ones "
                         f"of {n}: what trains must be a suffix of the "
                         "flat buffer")
    if rest_scale not in (0.0, 1.0):
        raise ValueError(f"rest_scale must be 0 or 1, got {rest_scale}")
    rest = rest_scale == 1.0
    starts, end = state.starts, state.params.numel()
    segments = [(starts[1 + first], end)]
    if rest:
        segments = [(0, end)] if first == 0 else \
            [(0, starts[1])] + segments
    key = (first, rest)
    if state.trainable != key:
        for i, group in enumerate(parameter_groups(state.model)):
            train = i == len(starts) - 1 or (i == 0 and rest) \
                or (0 < i and i - 1 >= first)
            for p in group:
                p.requires_grad_(train)
        state.trainable = key
    return segments


def emotion_loss(task: str, logits, dims, batch: Mapping,
                 class_weights: Optional[torch.Tensor],
                 mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Weighted CE of the logits, CCC loss of A/V/D, or (``both``) their
    sum; under a ``mesh`` this rank's part of the global batch's."""
    loss = 0.0
    if task in ("categorical", "both"):
        loss = loss + ce_weight_category(logits, batch["C"], class_weights,
                                         mesh)
    if task in ("dimensional", "both"):
        targets = torch.stack([batch["A"], batch["V"], batch["D"]], dim=1)
        loss = loss + ccc_loss(dims, targets, mesh=mesh)
    return loss


def adamw_spec(learning_rate: float, weight_decay: float = 1e-4,
               clip_norm: float = 1.0) -> FusedAdamWSpec:
    """``clip_by_global_norm(clip_norm) → adamw(lr, wd)`` as K4's spec
    (optax's b1 0.9, b2 0.999, eps 1e-8)."""
    return FusedAdamWSpec(schedule=float(learning_rate),
                          weight_decay=weight_decay, clip_norm=clip_norm)


def make_emotion_train_step(task: str, weight_decay: float = 1e-4,
                            clip_norm: float = 1.0) -> Callable:
    """``train_step(state, batch, class_weights, layers, learning_rate,
    rest_scale=0.0) → metrics``, in place.  ``batch`` holds
    ``input_values`` and ``attention_mask`` ``[B, T]`` and the targets
    ``C``, ``A``, ``V``, ``D`` on the state's device; ``class_weights``
    ``[K]`` (or None); ``layers`` the unfrozen encoder layers (the top
    ones). The metrics ``loss`` and ``grad_norm`` (the global norm of the
    trainable gradients) are device tensors: nothing waits for the card;
    ``layers_run`` counts the layers LayerDrop kept.  Under the state's
    mesh ``batch`` holds this rank's rows and the metrics are the global
    batch's."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")

    def train_step(state: EmotionTrainState, batch: Mapping,
                   class_weights, layers: Sequence[int],
                   learning_rate: float, rest_scale: float = 0.0) -> Dict:
        segments = trainable_segments(state, layers, rest_scale)
        mesh = state.mesh
        rank, world = (mesh.rank, mesh.world) if mesh else (0, 1)
        state.grads.zero_()
        x = zero_mean_unit_var(batch["input_values"])
        logits, dims = state.model(x, batch["attention_mask"], task,
                                   TrainRNG(state.seed, state.step, 0, rank,
                                            world))
        loss = emotion_loss(task, logits, dims, batch, class_weights, mesh)
        loss.backward()
        spec = adamw_spec(learning_rate, weight_decay, clip_norm)
        with torch.no_grad():
            loss = loss.detach()
            if mesh is not None and mesh.distributed:
                for lo, hi in segments:
                    dist.all_reduce(state.grads[lo:hi], group=mesh.group)
                dist.all_reduce(loss, group=mesh.group)
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(state.grads[lo:hi])
                 for lo, hi in segments]))
            for lo, hi in segments:
                fused_adamw_ema_update(
                    state.grads[lo:hi], state.params[lo:hi],
                    state.mu[lo:hi], state.nu[lo:hi], None, spec,
                    state.step, grad_norm)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "layers_run": state.model.encoder.encoder.layers_run}

    return train_step


def make_batch_placer(mesh: DataMesh, batch_size: int
                      ) -> Tuple[Callable, Callable]:
    """``(place_batch, place_state)`` for data-parallel SER training, as
    ``nrse_tpu/train/emotion_trainer.py::make_batch_placer``: raises where
    the global ``batch_size`` does not divide over the ranks (SER eval
    loaders pad their last batch, so a divisible batch size always holds);
    ``place_batch`` keeps this rank's rows of a global host batch (and its
    share of a padded batch's ``__count__``); ``place_state`` gives a
    state the mesh and rank 0's parameters and moments."""
    mesh.local_batch(batch_size)

    def place_batch(batch):
        return shard_batch(mesh, batch)

    def place_state(state: EmotionTrainState) -> EmotionTrainState:
        state.mesh = mesh
        broadcast_state(mesh, state.tensors().values())
        return state

    return place_batch, place_state


def make_emotion_eval_step(task: str) -> Callable:
    """``eval_step(model, batch) → {"logits": [B, K], "dims": [B, 3]}``
    (the branches ``task`` runs) in eval mode without a graph; the model's
    modes are restored after."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")

    @torch.no_grad()
    def eval_step(model: EmotionClassifier, batch: Mapping) -> Dict:
        modes = [(m, m.training) for m in model.modules()]
        model.eval()
        try:
            x = zero_mean_unit_var(batch["input_values"])
            logits, dims = model(x, batch["attention_mask"], task)
        finally:
            for m, training in modes:
                m.training = training
        out = {}
        if logits is not None:
            out["logits"] = logits
        if dims is not None:
            out["dims"] = dims
        return out

    return eval_step


class ReduceLROnPlateau:
    """Host-side metric-driven LR schedule (torch parity:
    ``ReduceLROnPlateau(mode, factor=0.5, patience)`` at
    ``categorical_emotions.py:90-95``)."""

    def __init__(self, initial_lr: float, mode: str = "max",
                 factor: float = 0.5, patience: int = 2,
                 min_lr: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min or max, got {mode!r}")
        self.lr = initial_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if self.best is None:
            self.best = metric
            return self.lr
        improved = (metric > self.best) if self.mode == "max" else \
            (metric < self.best)
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.min_lr, self.lr * self.factor)
                self.bad_epochs = 0
        return self.lr
