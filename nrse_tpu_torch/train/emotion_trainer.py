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

The step's inputs from the host (the kernels' seed table, LayerDrop's
keep list, SpecAugment's spans, the trunks' dropout masks and K4's LR and
bias corrections) are drawn as the model draws them and written to the
device in one copy before the step (:class:`StepInputs`); the step then
reads them there.  On a card, alone or under an NCCL mesh
(``parallel.mesh.capturable``), the step runs from CUDA graphs
(``train.step_graphs``, the counterpart of JAX's jitted step): captured
at the first step of each trainable key and batch shape, the mesh's sums
in its parts, replayed after that one copy.  ``emotion.cuda_graphs:
false`` in the config (``graphs=False`` here) asks for the eager step;
the CPU and a gloo mesh always run it (gloo's collectives cannot be
captured).  Both forms give the same bits.

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
and keeps its data coordinate's rows (``nrse_tpu/train/emotion_trainer.py:
172-209`` shards it over the mesh's ``data`` axis and replicates the state
over both axes); the losses take the global batch's denominators and
moments (``train.losses``), the random streams are those of the data
coordinate of the data axis's size, the trunks' dropout masks are drawn at
the global batch, and after the backward one ``all_reduce`` per trainable
segment sums the gradients over the data group, so every rank takes the
same K4 step.  A ``model`` axis above 1 replicates the step, as JAX runs
it: the encoder stays whole on every rank, the ranks of a model group see
the same rows and the same draws and compute the same step, and nothing
is summed over the model group; after each step ``replicas_agree`` checks
that they hold the same bits, and a difference raises.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nrse_tpu_torch.audio.features import zero_mean_unit_var
from nrse_tpu_torch.models.emotion import TASKS, EmotionClassifier
from nrse_tpu_torch.models.wavlm import SeedTable, StagedDraws, TrainRNG
from nrse_tpu_torch.ops.fused_optimizer import (
    FusedAdamWSpec,
    fused_adamw_ema_update,
    host_scalars,
)
from nrse_tpu_torch.parallel.mesh import (
    DataMesh,
    broadcast_state,
    capturable,
    form_note,
    replicas_agree,
    shard_batch,
)
from nrse_tpu_torch.runtime.graphs import ProgramCache, audio_inputs
from nrse_tpu_torch.runtime.staging import Staging
from nrse_tpu_torch.train.losses import ccc_loss, ce_weight_category
from nrse_tpu_torch.train.step_graphs import (
    StepGraphs,
    encoder_parameter_groups,
)

ALIGN = 4  # floats: K4 takes 16-byte aligned buffers

logger = logging.getLogger(__name__)


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
    # the step's staged inputs by batch shape, and its graphs
    # (train.step_graphs.StepGraphs) of the current key and shape
    inputs: Dict = dataclasses.field(default_factory=dict, repr=False)
    graphs: Optional[object] = dataclasses.field(default=None, repr=False)

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
    return encoder_parameter_groups(model, "encoder",
                                    model.encoder_config.num_hidden_layers)


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


class StepInputs:
    """A train step's inputs from the host for one batch shape, in one
    :class:`~nrse_tpu_torch.runtime.staging.Staging`: the kernels' seed
    table (one tower), SpecAugment's ``[B, T']`` spans, the trunks' ``[3,
    B, H]`` keep masks (``trunks``, the classifier head's ``keep``; None
    without trunk dropout) and K4's eight host scalars (``k4``).
    :meth:`stage` draws a step's as the model would (the same generators,
    in the same order), writes them and copies them over once, and returns
    the step's ``TrainRNG`` reading the table and the encoder's draws."""

    def __init__(self, model: EmotionClassifier, batch: int, samples: int,
                 device):
        enc = model.encoder_config
        self.frames = int(enc.feature_lengths(samples))
        self.batch = batch
        slots = {"seeds": SeedTable.slot(enc.num_hidden_layers),
                 "k4": ((8,), torch.float32)}
        self.spans = enc.has_masked_spec_embed
        if self.spans:
            slots["spans"] = ((batch, self.frames), torch.bool)
        if model.dropout > 0.0:
            slots["trunks"] = ((3, batch, model.shared_dense.out_features),
                               torch.bool)
        self.staging = Staging(device, slots)
        self.table = SeedTable(enc.num_hidden_layers,
                               staging=self.staging)
        self.trunks = self.staging["trunks"] if "trunks" in slots else None
        self.k4 = self.staging["k4"]

    def stage(self, state: "EmotionTrainState", task: str,
              spec: FusedAdamWSpec) -> TrainRNG:
        mesh = state.mesh
        rank, world = (mesh.data_index, mesh.data) if mesh else (0, 1)
        rng = TrainRNG(state.seed, state.step, 0, rank, world)
        model, st = state.model, self.staging
        st.begin()
        self.table.fill(state.seed, state.step, rank, world)
        keep = model.encoder.encoder.layer_keep(rng)
        if self.spans:
            st.host("spans").copy_(model.encoder.time_mask(
                rng, self.batch, self.frames))
        if self.trunks is not None:
            st.host("trunks").copy_(model.head_keep(rng, self.batch, task))
        st.host("k4").copy_(torch.from_numpy(host_scalars(spec,
                                                          state.step)))
        st.push()
        draws = StagedDraws(tuple(keep),
                            st["spans"] if self.spans else None)
        return dataclasses.replace(rng, table=self.table, draws=draws)


def step_inputs(state: EmotionTrainState, batch: Mapping) -> StepInputs:
    """The state's :class:`StepInputs` for this batch's shape."""
    shape = tuple(batch["input_values"].shape)
    if shape not in state.inputs:
        state.inputs[shape] = StepInputs(state.model, shape[0], shape[1],
                                         state.params.device)
    return state.inputs[shape]


def make_emotion_train_step(task: str, weight_decay: float = 1e-4,
                            clip_norm: float = 1.0,
                            graphs: bool = True) -> Callable:
    """``train_step(state, batch, class_weights, layers, learning_rate,
    rest_scale=0.0) → metrics``, in place.  ``batch`` holds
    ``input_values`` and ``attention_mask`` ``[B, T]`` and the targets
    ``C``, ``A``, ``V``, ``D`` on the state's device; ``class_weights``
    ``[K]`` (or None); ``layers`` the unfrozen encoder layers (the top
    ones). The metrics ``loss`` and ``grad_norm`` (the global norm of the
    trainable gradients) are device tensors of their own: nothing waits
    for the card; ``layers_run`` counts the layers LayerDrop kept.  Under
    the state's mesh ``batch`` holds this rank's data coordinate's rows
    and the metrics are the global batch's; under a model axis the step
    raises when the replicas of the model group no longer hold the same
    parameters and moments.

    With ``graphs`` (the default) a state on a card, alone or under an
    NCCL mesh, runs the captured step (``train.step_graphs``); a capture
    that fails raises, naming the step and the part.  Under a model axis
    the replicas are checked after the replay, on the host."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    logged = set()

    def train_step(state: EmotionTrainState, batch: Mapping,
                   class_weights, layers: Sequence[int],
                   learning_rate: float, rest_scale: float = 0.0) -> Dict:
        mesh = state.mesh
        segments = trainable_segments(state, layers, rest_scale)
        spec = adamw_spec(learning_rate, weight_decay, clip_norm)
        inputs = step_inputs(state, batch)
        rng = inputs.stage(state, task, spec)
        captured = graphs and capturable(mesh, state.params.device)
        form = "captured" if captured else "eager"
        if form not in logged:
            logged.add(form)
            logger.info(f"SER train step: the {form} form"
                        + form_note(graphs, captured, mesh))
        if captured:
            key = (state.trainable, tuple(batch["input_values"].shape),
                   task, class_weights is not None)
            if state.graphs is None or state.graphs.key != key:
                state.graphs = None  # the previous key's graphs go first
                state.graphs = ser_step_graphs(
                    state, task, spec, segments, batch, class_weights, rng,
                    inputs, key)
            loss, out = state.graphs.run(
                _step_inputs(batch, class_weights), rng, ("optimizer",))
            loss, grad_norm = out.get("reduce", loss), out["optimizer"]
        else:
            loss, grad_norm = _eager_step(state, task, spec, segments,
                                          batch, class_weights, rng, inputs)
        state.model.encoder.encoder.layers_run = sum(rng.draws.keep)
        state.step += 1
        if mesh is not None and mesh.tp and mesh.distributed:
            check_replicas(state, segments)
        return {"loss": loss, "grad_norm": grad_norm,
                "layers_run": state.model.encoder.encoder.layers_run}

    return train_step


def _step_inputs(batch: Mapping, class_weights) -> Dict:
    """What the captured step reads per step: the batch, and the class
    weights where there are any."""
    if class_weights is None:
        return dict(batch)
    return {**batch, "class_weights": class_weights}


def ser_step_graphs(state: EmotionTrainState, task: str,
                    spec: FusedAdamWSpec, segments, batch: Mapping,
                    class_weights: Optional[torch.Tensor], rng: TrainRNG,
                    inputs: StepInputs, key) -> StepGraphs:
    """The SER train step of ``state`` for one ``key`` (the trainable
    key, the batch shape, the task, whether class weights are given) as
    ``train.step_graphs.StepGraphs``, captured on ``batch`` with ``rng``
    (the step's staged stream) and ``inputs`` (the ``StepInputs`` staged
    for it: the trunks' masks, K4's host scalars): the front z-norms the
    waveform, the head runs ASP, the trunks and :func:`emotion_loss` (this
    rank's part of the global batch's under the state's mesh), a
    ``reduce`` part where the mesh's data axis sums (each trainable
    segment's gradients, then the loss, as :func:`_eager_step`; it
    returns the loss), and one ``optimizer`` part takes the global norm
    and the K4 launches.  No part holds the state (it holds its graphs):
    a state dropped with its graphs frees them at once, and an NCCL
    group's end, which waits for every graph holding its collectives,
    need not wait for the cycle collector."""
    model, mesh = state.model, state.mesh
    grads, params, mu, nu = state.grads, state.params, state.mu, state.nu

    def front(x, rng):
        return model.encoder.front(zero_mean_unit_var(x["input_values"]),
                                   x["attention_mask"], rng)

    def head(back, x, rng):
        logits, dims = model.head(back[0], x["attention_mask"], task, rng,
                                  inputs.trunks)
        return emotion_loss(task, logits, dims, x,
                            x.get("class_weights"), mesh)

    def reduce(loss):
        return _pool(grads, segments, loss, mesh)

    def optimizer():  # K4's count is the staged one (rest)
        gn = global_norm(grads, segments)
        for lo, hi in segments:
            fused_adamw_ema_update(grads[lo:hi], params[lo:hi], mu[lo:hi],
                                   nu[lo:hi], None, spec, 0, gn,
                                   rest=inputs.k4)
        return gn

    return StepGraphs(
        model.encoder, parameter_groups(model), state.trainable, front,
        head, [("optimizer", optimizer)],
        _step_inputs(batch, class_weights), rng, state.grads, key,
        f"the SER train step {state.step} (trainable {state.trainable})",
        reduce=reduce if mesh is not None and mesh.data_reduce else None,
        mesh=mesh)


def _pool(grads: torch.Tensor, segments, loss: torch.Tensor,
          mesh: Optional[DataMesh]) -> torch.Tensor:
    """The step's sums over the mesh's data axis: each trainable segment
    of ``grads`` in place, then ``loss`` (each rank's part of the global
    batch's); returns the loss (``loss`` itself where nothing is
    summed)."""
    if mesh is None or not mesh.data_reduce:
        return loss
    for lo, hi in segments:
        dist.all_reduce(grads[lo:hi], group=mesh.data_group)
    dist.all_reduce(loss, group=mesh.data_group)
    return loss


def _eager_step(state: EmotionTrainState, task: str, spec: FusedAdamWSpec,
                segments, batch: Mapping, class_weights, rng: TrainRNG,
                inputs: StepInputs):
    """The step dispatched op by op, the trunks' masks and K4's host
    scalars read from the staged ``inputs``: ``(loss, grad_norm)``."""
    mesh = state.mesh
    state.grads.zero_()
    x = zero_mean_unit_var(batch["input_values"])
    logits, dims = state.model(x, batch["attention_mask"], task, rng,
                               inputs.trunks)
    loss = emotion_loss(task, logits, dims, batch, class_weights, mesh)
    loss.backward()
    with torch.no_grad():
        loss = _pool(state.grads, segments, loss.detach(), mesh)
        grad_norm = global_norm(state.grads, segments)
        for lo, hi in segments:
            fused_adamw_ema_update(
                state.grads[lo:hi], state.params[lo:hi], state.mu[lo:hi],
                state.nu[lo:hi], None, spec, state.step, grad_norm,
                rest=inputs.k4)
    return loss, grad_norm


def global_norm(grads: torch.Tensor,
                segments: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The global norm of the trainable segments of ``grads``."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(grads[lo:hi]) for lo, hi in segments]))


def check_replicas(state: EmotionTrainState,
                   segments: Sequence[Tuple[int, int]]) -> None:
    """Raise unless the ranks of the state's model group hold the same
    bits in the trainable segments of the parameters and the moments (one
    ``all_reduce`` of checksums over the model group)."""
    mesh = state.mesh
    tensors = [t[lo:hi] for t in (state.params, state.mu, state.nu)
               for lo, hi in segments]
    if not replicas_agree(mesh, tensors, group=mesh.model_group):
        raise RuntimeError(
            f"SER train step {state.step}: the {mesh.model} replicas of "
            f"model group {mesh.data_index} hold different parameters or "
            "moments; a piece of the step is not deterministic")


def make_batch_placer(mesh: DataMesh, batch_size: int
                      ) -> Tuple[Callable, Callable]:
    """``(place_batch, place_state)`` for SER training over a mesh, as
    ``nrse_tpu/train/emotion_trainer.py::make_batch_placer``: raises where
    the global ``batch_size`` does not divide over the data axis (SER eval
    loaders pad their last batch, so a divisible batch size always holds);
    ``place_batch`` keeps the rows of this rank's data index of a global
    host batch (and their share of a padded batch's ``__count__``), the
    same rows on every rank of a model group; ``place_state`` gives a
    state the mesh and rank 0's parameters and moments on every rank."""
    mesh.local_batch(batch_size)

    def place_batch(batch):
        return shard_batch(mesh, batch)

    def place_state(state: EmotionTrainState) -> EmotionTrainState:
        state.mesh = mesh
        broadcast_state(mesh, state.tensors().values())
        return state

    return place_batch, place_state


def make_emotion_eval_step(task: str, graphs: bool = True) -> Callable:
    """``eval_step(model, batch) → {"logits": [B, K], "dims": [B, 3]}``
    (the branches ``task`` runs) in eval mode without a graph; the model's
    modes are restored after.  With ``graphs`` each model's forward runs
    from a ``runtime.graphs.ProgramCache`` (one program per ``(B, T)``,
    on the card a CUDA graph reading the parameters in place from the
    state's flat buffer, so a train step needs no recapture of it); the
    outputs are copies either way."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    caches: Dict[int, Tuple[EmotionClassifier, Callable]] = {}

    def forward_of(model: EmotionClassifier) -> Callable:
        @torch.no_grad()
        def forward(audio: torch.Tensor, mask: torch.Tensor):
            logits, dims = model(zero_mean_unit_var(audio), mask, task)
            return tuple(t for t in (logits, dims) if t is not None)

        return forward

    def run(model: EmotionClassifier, batch: Mapping):
        if not graphs:
            return forward_of(model)(batch["input_values"],
                                     batch["attention_mask"])
        entry = caches.get(id(model))
        if entry is None or entry[0] is not model:
            entry = (model, ProgramCache(
                forward_of(model), batch["input_values"].device,
                audio_inputs(mask_dtype=batch["attention_mask"].dtype)))
            caches[id(model)] = entry
        out = entry[1](batch["input_values"], batch["attention_mask"])
        return out if isinstance(out, tuple) else (out,)

    @torch.no_grad()
    def eval_step(model: EmotionClassifier, batch: Mapping) -> Dict:
        modes = [(m, m.training) for m in model.modules()]
        model.eval()
        try:
            outs = list(run(model, batch))
        finally:
            for m, training in modes:
                m.training = training
        out = {}
        if task in ("categorical", "both"):
            out["logits"] = outs.pop(0)
        if task in ("dimensional", "both"):
            out["dims"] = outs.pop(0)
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
