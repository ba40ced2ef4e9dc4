"""The BYOL training step and eval step.

Port of ``nrse_tpu/train/byol_trainer.py:41-235`` with the JAX package's
fused optimizer (``fused_optimizer: FusedAdamWSpec``).  One train step:

  1. the two views on the device (``audio.augment.make_byol_views``);
  2. the online tower in training mode on the clean view;
  3. the target tower in training mode on the noisy view, without
     gradients, on its own random streams (the ``fold_in(·, 1)`` of
     ``nrse_tpu/models/byol.py:206-208``); its BatchNorm statistics advance
     too;
  4. ``byol_loss(pred, proj, weights=valid)``;
  5. the backward pass, into one flat float32 gradient buffer;
  6. ``grad_norm``, the global L2 norm of the online gradients;
  7. one K4 pass (``ops.fused_optimizer``): clip-scaled AdamW over every
     online parameter and the EMA of the target over the encoder and
     projector, in that order (``byol_trainer.py:129-144``).

With ``on_device_mixing=False`` (JAX's host-side parity path,
``byol_trainer.py:79-107``) the views come in the batch, as
``clean_input_values`` and ``noisy_input_values`` (``data.
noisy_speech_dataset`` with ``featurize``), every row valid.

The step's inputs from the host (both towers' kernel seed pairs, each
tower's LayerDrop keep list and SpecAugment spans, K4's LR, bias
corrections and EMA decay) are drawn as the towers draw them and written
to the device in one copy before the step (:class:`BYOLStepInputs`).  On
a card, alone or under an NCCL mesh (``parallel.mesh.capturable``), the
step runs from CUDA graphs (``train.step_graphs``, the counterpart of
JAX's jitted step, GSPMD's collectives included): captured at the first
step of each batch shape and form, the target a forward-only tower beside
the online encoder, the mesh's reductions in the parts, replayed after
that one copy.  ``graphs=False`` (``training.cuda_graphs: false`` in
``train_byol``) asks for the eager step; the CPU and a gloo mesh always
run it (gloo's collectives cannot be captured).  Both forms give the same
bits.

The state keeps the online parameters, their gradients, ``mu``, ``nu`` and
the target's parameters as flat float32 buffers, the modules' parameters
and ``.grad`` being views into them; online order encoder, projector,
predictor, so the target is a prefix.  The random streams of a step come
from (root seed, step, tower) on the host (``models.wavlm.TrainRNG``).

Data parallelism (a state made with a ``parallel.mesh.DataMesh``): each
rank runs the step on its rows of the global batch; the loss is its part
of the global batch's (the global weight sum), the heads' BatchNorm takes
the global batch's statistics, and after the backward one ``all_reduce``
sums the flat gradient buffer, so ``grad_norm`` and K4 see the global
batch's gradient on every rank and the replicas stay bit-identical (what
the JAX package's GSPMD step computes on an N-wide ``data`` mesh,
``nrse_tpu/train/byol_trainer.py:19-20``).  No
``DistributedDataParallel``: its buckets would replace the ``.grad`` views
of the flat buffer K4 reads whole, and its averaging would divide by the
world size on top of the global denominators.

Tensor parallelism (a mesh whose model axis ``m`` is above 1): the towers
hold this rank's shards of the encoder's layers (``models.wavlm``,
``parallel.mesh.partition_rule``), and each flat buffer holds first the
shards (``split`` elements) and then the replicated parameters, the
target's buffer being a prefix of the online one as before.  The gradient
is summed over the data group, the rows' axis; ``grad_norm`` is the global
norm, ``sqrt(Σ over the model group of Σ shard² + Σ replicated²)``, each
replicated element counted once, and K4 clips with it on each rank's
buffers.  The shards are broadcast and compared within the data group,
the replicated parameters over every rank.  A checkpoint holds the ``model:
1`` layout: :meth:`BYOLTrainState.checkpoint_tensors` gathers the model
group's shards into it and :meth:`BYOLTrainState.load_checkpoint_tensors`
shards it again, so a run resumes at any ``tpu.mesh``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from nrse_tpu_torch.audio.augment import make_byol_views
from nrse_tpu_torch.models.byol import (
    ONLINE,
    TARGET,
    OnlineNetwork,
    TargetNetwork,
    byol_loss,
    byol_loss_per_sample,
    make_target,
)
from nrse_tpu_torch.models.heads import use_mesh
from nrse_tpu_torch.models.wavlm import (
    SeedTable,
    StagedDraws,
    TrainRNG,
    WavLMConfig,
)
from nrse_tpu_torch.ops.fused_optimizer import (
    FusedAdamWSpec,
    fused_adamw_ema_update,
    host_scalars,
)
from nrse_tpu_torch.parallel.mesh import (
    DataMesh,
    capturable,
    form_note,
    gather_state_dict,
    partition_rule,
    shard_state_dict,
)
from nrse_tpu_torch.parallel.mesh import broadcast_state as _broadcast
from nrse_tpu_torch.parallel.mesh import replicas_agree as _replicas_agree
from nrse_tpu_torch.runtime.graphs import ProgramCache
from nrse_tpu_torch.runtime.staging import Staging
from nrse_tpu_torch.train.step_graphs import (
    ForwardTower,
    StepGraphs,
    encoder_parameter_groups,
)

logger = logging.getLogger(__name__)

# the flat buffers of the state, and which tower's parameters each holds
FLAT = {"params": "online", "mu": "online", "nu": "online",
        "target_params": "target"}
# the batch keys of each form of the views (on_device_mixing True, False)
VIEW_KEYS = {True: ("clean", "noise", "snr"),
             False: ("clean_input_values", "noisy_input_values")}


@dataclasses.dataclass
class BYOLTrainState:
    """Everything the train step carries.  ``step`` is also the Adam step
    count; ``seed`` is the root of every random stream; ``mesh`` the mesh
    (None: one process); ``split`` the flat buffers' leading elements that
    are this rank's shards under a model axis (0 without one)."""

    online: OnlineNetwork
    target: TargetNetwork
    params: torch.Tensor         # flat online parameters
    grads: torch.Tensor          # flat, the parameters' .grad
    mu: torch.Tensor
    nu: torch.Tensor
    target_params: torch.Tensor  # flat target parameters (a prefix's EMA)
    step: int = 0
    seed: int = 0
    mesh: Optional[DataMesh] = None
    split: int = 0
    # the step's staged inputs by batch shape (BYOLStepInputs), and its
    # graphs (train.step_graphs.StepGraphs) of the current shape and form
    inputs: Dict = dataclasses.field(default_factory=dict, repr=False)
    graphs: Optional[object] = dataclasses.field(default=None, repr=False)
    # the eval step's program caches (runtime.graphs.ProgramCache), by
    # (whether they return the embeddings, whether they mix the views)
    programs: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def tp(self) -> bool:
        return self.mesh is not None and self.mesh.tp

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tensors a checkpoint holds and the replicas share, by name:
        ``params``, ``mu``, ``nu``, ``target_params`` and each tower's
        buffers (``online.<name>``, ``target.<name>``: the BatchNorm
        running statistics)."""
        out = {k: getattr(self, k)
               for k in ("params", "mu", "nu", "target_params")}
        for tower, module in (("online", self.online),
                              ("target", self.target)):
            for name, buf in module.named_buffers():
                out[f"{tower}.{name}"] = buf
        return out

    def _named(self, flat: torch.Tensor,
               tower: str) -> Dict[str, torch.Tensor]:
        """A flat buffer of ``tower``'s parameters as views named after
        them, in the buffer's order."""
        out, off = {}, 0
        for name, p in flat_order(getattr(self, tower), self.mesh):
            out[name] = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
        return out

    def whole_shapes(self, tower: str) -> Dict[str, torch.Size]:
        """``tower``'s parameter shapes in the ``model: 1`` layout, in
        module order."""
        out = {}
        for n, p in getattr(self, tower).named_parameters():
            shape = list(p.shape)
            dim = partition_rule(n, p) if self.tp else None
            if dim is not None:
                shape[dim] *= self.mesh.model
            out[n] = torch.Size(shape)
        return out

    def gathered(self, flat: torch.Tensor,
                 tower: str) -> Dict[str, torch.Tensor]:
        """A flat buffer of ``tower``'s parameters (``params``, ``grads``,
        ``mu``, ...) as the ``model: 1`` state dict, the model group's
        shards gathered: a collective over the model group under a model
        axis (its ranks all call it), views of ``flat`` without one."""
        return gather_state_dict(self._named(flat, tower), self.mesh)

    def checkpoint_tensors(self) -> Dict[str, torch.Tensor]:
        """:meth:`tensors` in the ``model: 1`` layout, the flat buffers
        laid out as one process lays them out (the towers' parameters in
        module order, whole).  Under a model axis a collective over the
        model group; without one :meth:`tensors` itself."""
        out = self.tensors()
        if not self.tp:
            return out
        for key, tower in FLAT.items():
            whole = self.gathered(out[key], tower)
            out[key] = torch.cat([whole[n].reshape(-1)
                                  for n in self.whole_shapes(tower)])
        return out

    def checkpoint_shapes(self) -> Dict[str, torch.Size]:
        """The shapes of :meth:`checkpoint_tensors`, without a
        collective."""
        out = {k: v.shape for k, v in self.tensors().items()}
        for key, tower in FLAT.items():
            out[key] = torch.Size([sum(
                s.numel() for s in self.whole_shapes(tower).values())])
        return out

    @torch.no_grad()
    def load_checkpoint_tensors(self, tensors: Mapping) -> None:
        """Write ``tensors`` (the ``model: 1`` layout of
        :meth:`checkpoint_tensors`) into the state in place, each rank
        keeping its shards."""
        for key, dst in self.tensors().items():
            src = tensors[key]
            if key not in FLAT or not self.tp:
                dst.copy_(src)
                continue
            whole, off = {}, 0
            for n, shape in self.whole_shapes(FLAT[key]).items():
                whole[n] = src[off:off + shape.numel()].view(shape)
                off += shape.numel()
            local = shard_state_dict(whole, self.mesh)
            for n, view in self._named(dst, FLAT[key]).items():
                view.copy_(local[n])


def flat_order(module: nn.Module, mesh: Optional[DataMesh]
               ) -> List[Tuple[str, nn.Parameter]]:
    """``module``'s named parameters in the order of the flat buffers:
    under a model axis the ones ``partition_rule`` splits first, then the
    replicated ones, each in module order; module order otherwise."""
    named = list(module.named_parameters())
    if mesh is None or not mesh.tp:
        return named
    return ([(n, p) for n, p in named if partition_rule(n, p) is not None]
            + [(n, p) for n, p in named if partition_rule(n, p) is None])


def flatten_params(params: List[nn.Parameter], device) -> torch.Tensor:
    """One float32 buffer holding ``params``, which become views of it."""
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                       device=device)
    off = 0
    for p in params:
        n = p.numel()
        flat[off:off + n].copy_(p.detach().reshape(-1))
        p.data = flat[off:off + n].view_as(p)
        off += n
    return flat


def _load(module: nn.Module, state_dict: Mapping, device) -> nn.Module:
    # copies: the module's buffers (BatchNorm statistics) advance in place,
    # and must not write through into the caller's state dict
    sd = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32,
                                   copy=True)
          for k, v in state_dict.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def create_train_state(config: WavLMConfig, online_state_dict: Mapping,
                       projection_dim: int = 1024,
                       prediction_dim: int = 2048, device="cuda",
                       seed: int = 0,
                       target_state_dict: Optional[Mapping] = None,
                       compute_dtype: Optional[torch.dtype] = None,
                       mesh: Optional[DataMesh] = None) -> BYOLTrainState:
    """The state at step 0: float32 parameters on ``device`` (computing in
    ``compute_dtype``, default float32), the target a real copy of the
    online encoder and projector unless ``target_state_dict`` is given,
    ``mu = nu = 0``.  With a ``mesh``, the heads' BatchNorms take global
    statistics, and every rank starts from rank 0's state; under a model
    axis the state dicts (``model: 1`` ones) are sharded and each rank
    keeps its shards."""
    device = torch.device(device)
    tp_mesh = mesh if mesh is not None and mesh.tp else None
    online = _load(OnlineNetwork(config, projection_dim, prediction_dim,
                                 device="meta", compute_dtype=compute_dtype,
                                 mesh=tp_mesh),
                   shard_state_dict(online_state_dict, tp_mesh), device)
    if target_state_dict is None:
        target = make_target(online)
    else:
        target = _load(TargetNetwork(config, projection_dim, device="meta",
                                     compute_dtype=compute_dtype,
                                     mesh=tp_mesh),
                       shard_state_dict(target_state_dict, tp_mesh), device)
    target.requires_grad_(False)
    online_params = flat_order(online, tp_mesh)
    target_params = flat_order(target, tp_mesh)
    if [(n, p.shape) for n, p in online_params[:len(target_params)]] != \
            [(n, p.shape) for n, p in target_params]:
        raise ValueError("the target's parameters are not a prefix of the "
                         "online tower's")
    params = flatten_params([p for _, p in online_params], device)
    grads = torch.zeros_like(params)
    off = 0
    for _, p in online_params:
        p.grad = grads[off:off + p.numel()].view_as(p)
        off += p.numel()
    state = BYOLTrainState(
        online=online.train(), target=target.train(), params=params,
        grads=grads, mu=torch.zeros_like(params),
        nu=torch.zeros_like(params),
        target_params=flatten_params([p for _, p in target_params], device),
        seed=seed, mesh=mesh,
        split=sum(p.numel() for n, p in online_params
                  if tp_mesh is not None and partition_rule(n, p) is not None))
    if mesh is not None:
        use_mesh(online, mesh)
        use_mesh(target, mesh)
        broadcast_state(state)
    return state


def _parts(state: BYOLTrainState):
    """``(shards, replicated)``: the state's tensors split into this
    rank's shards (the flat buffers' first ``split`` elements) and the
    rest."""
    shards, rest = [], []
    for key, t in state.tensors().items():
        if key in FLAT and state.split:
            shards.append(t[:state.split])
            rest.append(t[state.split:])
        else:
            rest.append(t)
    return shards, rest


def broadcast_state(state: BYOLTrainState) -> None:
    """Rank 0's state on every rank of the state's mesh (at the start and
    after a resume); under a model axis the shards from the data group's
    first rank (data index 0, this model index) within the data group."""
    mesh = state.mesh
    if mesh is None:
        return
    shards, rest = _parts(state)
    _broadcast(mesh, rest)
    if shards and mesh.data_reduce:
        _broadcast(mesh, shards, mesh.data_rank(0), mesh.data_group)


def replicas_agree(state: BYOLTrainState) -> bool:
    """True when the ranks of the state's mesh hold the same bits where
    they should: every rank in the replicated parameters, the moments and
    the BatchNorm statistics, and the ranks of each data group in their
    shards (an ``all_reduce`` of checksums each)."""
    mesh = state.mesh
    if mesh is None:
        return True
    shards, rest = _parts(state)
    agree = _replicas_agree(mesh, rest)
    if shards and mesh.data_reduce:
        agree = _replicas_agree(mesh, shards, mesh.data_group) and agree
    return agree


def grad_norm_of(grads: torch.Tensor, split: int,
                 mesh: Optional[DataMesh]) -> torch.Tensor:
    """The global L2 norm of the online gradients ``grads`` (a state's
    flat buffer, its first ``split`` elements this rank's shards): under
    a model axis ``sqrt(Σ over the model group of Σ shard² + Σ
    replicated²)``."""
    if mesh is None or not mesh.tp:
        return torch.linalg.vector_norm(grads)
    shard = torch.linalg.vector_norm(grads[:split])
    rest = torch.linalg.vector_norm(grads[split:])
    sq = (shard * shard).reshape(1)
    dist.all_reduce(sq, group=mesh.model_group)
    return torch.sqrt(sq[0] + rest * rest)


def _pool(grads: torch.Tensor, loss: torch.Tensor,
          valid_fraction: torch.Tensor, mesh: Optional[DataMesh]):
    """The step's sums over the mesh's data axis, in place on ``grads``:
    the flat gradients, then the loss (each rank's part of the global
    batch's) and the mean of the ranks' ``valid_fraction``.  Returns
    ``(loss, valid_fraction)``, themselves where nothing is summed."""
    if mesh is None or not mesh.data_reduce:
        return loss, valid_fraction
    dist.all_reduce(grads, group=mesh.data_group)
    pooled = torch.stack([loss, valid_fraction / mesh.data])
    dist.all_reduce(pooled, group=mesh.data_group)
    return pooled[0], pooled[1]


class BYOLStepInputs:
    """A BYOL train step's inputs from the host for one batch shape, in one
    :class:`~nrse_tpu_torch.runtime.staging.Staging`: both towers' seed
    table, each tower's SpecAugment ``[B, T']`` spans (where the encoder
    has a masked embedding) and K4's eight host scalars (``k4``).
    :meth:`stage` draws a step's as the towers would (the same
    generators, ``TrainRNG(seed, step, ONLINE | TARGET, rank, world)``,
    in the same order), writes them and copies them over once, and
    returns each tower's ``TrainRNG`` reading the table and its draws (its
    keep list stays on the host, which picks the layers to run)."""

    def __init__(self, config: WavLMConfig, batch: int, samples: int,
                 device):
        self.frames = int(config.feature_lengths(samples))
        self.batch = batch
        slots = {"seeds": SeedTable.slot(config.num_hidden_layers, 2),
                 "k4": ((8,), torch.float32)}
        self.spans = config.has_masked_spec_embed
        if self.spans:
            for tower in (ONLINE, TARGET):
                slots[f"spans {tower}"] = ((batch, self.frames), torch.bool)
        self.staging = Staging(device, slots)
        self.table = SeedTable(config.num_hidden_layers, 2,
                               staging=self.staging)
        self.k4 = self.staging["k4"]

    def stage(self, state: BYOLTrainState, spec: FusedAdamWSpec
              ) -> Tuple[TrainRNG, TrainRNG]:
        mesh = state.mesh
        rank, world = (mesh.data_index, mesh.data) if mesh else (0, 1)
        st = self.staging
        st.begin()
        self.table.fill(state.seed, state.step, rank, world)
        draws = []
        for tower, module in ((ONLINE, state.online),
                              (TARGET, state.target)):
            rng = TrainRNG(state.seed, state.step, tower, rank, world)
            encoder = module.encoder
            # an encoder in eval mode draws nothing and runs every layer
            keep = encoder.encoder.layer_keep(
                rng if encoder.training else None)
            spans = None
            if self.spans:
                spans = st[f"spans {tower}"]
                st.host(f"spans {tower}").copy_(encoder.time_mask(
                    rng, self.batch, self.frames))
            draws.append((rng, StagedDraws(tuple(keep), spans)))
        st.host("k4").copy_(torch.from_numpy(host_scalars(spec,
                                                          state.step)))
        st.push()
        return tuple(dataclasses.replace(rng, table=self.table, draws=d)
                     for rng, d in draws)


def step_inputs(state: BYOLTrainState, batch: Mapping,
                on_device_mixing: bool = True) -> BYOLStepInputs:
    """The state's :class:`BYOLStepInputs` for this batch's shape."""
    shape = tuple(batch[VIEW_KEYS[on_device_mixing][0]].shape)
    if shape not in state.inputs:
        state.inputs[shape] = BYOLStepInputs(
            state.online.encoder.config, shape[0], shape[1],
            state.params.device)
    return state.inputs[shape]


def byol_views(batch: Mapping, on_device_mixing: bool = True):
    """``(clean_views, noisy_views, valid)`` of a batch: mixed on the
    device from ``clean``, ``noise`` and ``snr``, or the batch's
    ``clean_input_values`` and ``noisy_input_values``, every row valid
    (``nrse_tpu/train/byol_trainer.py:100-107``)."""
    if on_device_mixing:
        return make_byol_views(batch["clean"], batch["noise"], batch["snr"])
    clean = batch["clean_input_values"]
    return (clean, batch["noisy_input_values"],
            torch.ones(clean.shape[0], dtype=torch.bool,
                       device=clean.device))


def make_byol_train_step(spec: FusedAdamWSpec, graphs: bool = True,
                         on_device_mixing: bool = True
                         ) -> Callable[[BYOLTrainState, Dict], Dict]:
    """``train_step(state, batch) → metrics`` for ``batch = {"clean":
    [B, T], "noise": [B, T], "snr": [B]}`` (with ``on_device_mixing``
    False, ``{"clean_input_values": [B, T], "noisy_input_values": [B,
    T]}``) on the state's device.  Updates the state in place.  The towers
    run in the modes they are in (the state is made in training mode).
    The metrics ``loss``, ``grad_norm``, ``valid_fraction`` and
    ``finite`` are device tensors (nothing waits for the card), of the
    global batch under a mesh; ``layers_online`` and ``layers_target``
    count the layers each tower ran under LayerDrop.  Under a mesh
    ``batch`` holds this rank's rows (its data coordinate's: the ranks of
    a model group take the same rows).

    With ``graphs`` (the default) a state on a card, alone or under an
    NCCL mesh, runs the captured step (:func:`byol_step_graphs`),
    captured at the first step of each batch shape and form (by every
    rank at the same step: the ranks' batches share one shape); a capture
    that fails raises, naming the step and the part."""
    token = object()  # this step's spec and form: one key of graphs
    logged = set()

    def train_step(state: BYOLTrainState, batch: Dict) -> Dict:
        mesh = state.mesh
        inputs = step_inputs(state, batch, on_device_mixing)
        rngs = inputs.stage(state, spec)
        captured = graphs and capturable(mesh, state.params.device)
        form = "captured" if captured else "eager"
        if form not in logged:
            logged.add(form)
            logger.info(f"BYOL train step: the {form} form"
                        + form_note(graphs, captured, mesh))
        if captured:
            views = {k: batch[k] for k in VIEW_KEYS[on_device_mixing]}
            key = (token, tuple(v.shape for v in views.values()))
            if state.graphs is None or state.graphs.key != key:
                state.graphs = None  # the previous key's graphs go first
                state.graphs = byol_step_graphs(
                    state, spec, views, rngs, inputs, on_device_mixing, key)
            loss, out = state.graphs.run(views, rngs[0], ("optimizer",),
                                         rngs[1])
            grad_norm, valid_fraction, finite = out["optimizer"]
            if "reduce" in out:  # the data group's
                loss = out["reduce"][0]
        else:
            loss, grad_norm, valid_fraction = _eager_step(
                state, spec, batch, rngs, inputs, on_device_mixing)
            finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        layers = []
        for module, rng in zip((state.online, state.target), rngs):
            module.encoder.encoder.layers_run = sum(rng.draws.keep)
            layers.append(module.encoder.encoder.layers_run)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "valid_fraction": valid_fraction, "finite": finite,
                "layers_online": layers[0], "layers_target": layers[1]}

    return train_step



def _eager_step(state: BYOLTrainState, spec: FusedAdamWSpec, batch: Dict,
                rngs: Tuple[TrainRNG, TrainRNG], inputs: BYOLStepInputs,
                on_device_mixing: bool):
    """The step dispatched op by op, the towers' draws and K4's host
    scalars read from the staged ``inputs``: ``(loss, grad_norm,
    valid_fraction)``."""
    online, target, mesh = state.online, state.target, state.mesh
    clean, noisy, valid = byol_views(batch, on_device_mixing)
    state.grads.zero_()
    pred, _, _ = online(clean, rngs[0])
    with torch.no_grad():
        proj, _ = target(noisy, rngs[1])
    loss = byol_loss(pred, proj, weights=valid, mesh=mesh)
    loss.backward()
    with torch.no_grad():
        loss, valid_fraction = _pool(state.grads, loss.detach(),
                                     valid.float().mean(), mesh)
        grad_norm = grad_norm_of(state.grads, state.split, mesh)
        fused_adamw_ema_update(state.grads, state.params, state.mu,
                               state.nu, state.target_params, spec,
                               state.step, grad_norm, rest=inputs.k4)
    return loss, grad_norm, valid_fraction


def byol_step_graphs(state: BYOLTrainState, spec: FusedAdamWSpec,
                     views: Mapping, rngs: Tuple[TrainRNG, TrainRNG],
                     inputs: BYOLStepInputs, on_device_mixing: bool,
                     key) -> StepGraphs:
    """The BYOL train step of ``state`` for one ``key`` (the step's spec
    and form, the batch's shapes) as ``train.step_graphs.StepGraphs``,
    captured on ``views`` (the batch's tensors of its form) with ``rngs``
    (both towers' staged streams) and ``inputs`` (K4's staged scalars):
    the front zeroes the gradients, makes the views and runs the online
    front on the clean one; the target is a forward-only tower on the
    noisy one; the head runs the online heads, the target's projector and
    ``byol_loss``; where the mesh's data axis sums, a ``reduce`` part
    sums what :func:`_eager_step` sums (the flat gradients, the loss and
    ``valid_fraction`` over the data group) and returns ``(loss,
    valid_fraction)``; one ``optimizer`` part takes the global norm (over
    the model group under a model axis) and the K4 launch (AdamW and the
    target's EMA) and returns ``(grad_norm, valid_fraction, finite)``.
    The heads' BatchNorm statistics are the buffers the warm-up puts back.
    No part holds the state itself (it holds its graphs), so a state
    dropped with its graphs frees their memory at once, without waiting
    for the cycle collector."""
    online, target, mesh, split = (state.online, state.target, state.mesh,
                                   state.split)
    grads, params, mu, nu, target_params = (
        state.grads, state.params, state.mu, state.nu, state.target_params)
    static = {}  # the views, valid and the loss, made inside the parts

    def front(x, rng):
        clean, static["noisy"], static["valid"] = byol_views(
            x, on_device_mixing)
        return online.encoder.front(clean, None, rng)

    def target_front(x, rng):
        return target.encoder.front(static["noisy"], None, rng)

    def head(back, x, rng, target_back):
        pred, _ = online.heads(back[1].float())
        with torch.no_grad():
            proj = target.projector(target_back[1].float())
        loss = byol_loss(pred, proj, weights=static["valid"], mesh=mesh)
        static["loss"] = loss.detach()
        return loss

    pools = mesh is not None and mesh.data_reduce

    def reduce(loss):
        static["pooled"] = _pool(grads, loss, static["valid"].float().mean(),
                                 mesh)
        return static["pooled"]

    def optimizer():
        gn = grad_norm_of(grads, split, mesh)
        fused_adamw_ema_update(grads, params, mu, nu, target_params, spec,
                               0, gn, rest=inputs.k4)
        loss, valid_fraction = static["pooled"] if pools else (
            static["loss"], static["valid"].float().mean())
        return gn, valid_fraction, torch.isfinite(loss) & torch.isfinite(gn)

    layers = online.encoder.config.num_hidden_layers
    return StepGraphs(
        online.encoder, encoder_parameter_groups(online, "encoder", layers),
        (0, True), front, head, [("optimizer", optimizer)], views, rngs[0],
        state.grads, key, f"the BYOL train step {state.step}",
        tower=ForwardTower(target.encoder, target_front, rngs[1]),
        buffers=[b for m in (online, target) for b in m.buffers()],
        reduce=reduce if pools else None, mesh=mesh)


def make_byol_eval_step(embeddings: bool = False, graphs: bool = True,
                        on_device_mixing: bool = True
                        ) -> Callable[[BYOLTrainState, Dict], Tuple]:
    """``eval_step(state, batch) → (loss [B], similarity [B])``: the BYOL
    loss per sample and the clean↔noisy cosine of the online encoder's
    pooled embeddings, from three encoder forwards in eval mode
    (``byol_trainer.py:183-235``); the towers' modes are restored after.
    With ``embeddings``, also those pooled clean and noisy embeddings
    ``[B, C]`` in float32, which JAX's ``make_byol_embed_step``
    (``:238-261``) computes in a pass of its own.  ``on_device_mixing``
    as :func:`make_byol_train_step` takes it: False reads the batch's
    ``clean_input_values`` and ``noisy_input_values``.

    With ``graphs`` (the default) a state alone or under an NCCL mesh
    runs the step from a ``runtime.graphs.ProgramCache`` of the form's
    inputs kept on the state (the counterpart of JAX's jitted
    ``eval_step`` and ``embed_step``: one program a batch shape, on the
    card a CUDA graph reading both towers' parameters and the heads'
    running statistics in place, so a train step needs no recapture of
    it; a tensor-parallel encoder's ``reduce_from_model`` inside it); a
    state under a gloo mesh runs it eagerly.  Under a mesh every rank
    meets each batch shape at the same step (the loaders give every rank
    one batch size and pad the last batch), so the ranks of a model group
    capture it together.  The outputs are copies either way."""
    logged = set()
    keys = VIEW_KEYS[on_device_mixing]

    def forward_of(state: BYOLTrainState) -> Callable:
        online, target = state.online, state.target

        @torch.no_grad()
        def forward(*inputs):
            clean, noisy, _ = byol_views(dict(zip(keys, inputs)),
                                         on_device_mixing)
            clean_emb = online.encoder(clean)[1].float()
            noisy_emb = online.encoder(noisy)[1].float()
            pred, _ = online.heads(clean_emb)
            proj = target.projector(target.encoder(noisy)[1].float())
            loss = byol_loss_per_sample(pred, proj)

            def unit(e):
                return e / torch.clamp_min(
                    torch.linalg.vector_norm(e, dim=1, keepdim=True), 1e-10)

            sim = (unit(clean_emb) * unit(noisy_emb)).sum(1)
            if embeddings:
                return loss, sim, clean_emb, noisy_emb
            return loss, sim

        return forward

    @torch.no_grad()
    def eval_step(state: BYOLTrainState, batch: Dict):
        online, target, mesh = state.online, state.target, state.mesh
        captured = graphs and (mesh is None or capturable(
            mesh, state.params.device))
        form = "captured" if captured else "eager"
        if form not in logged:
            logged.add(form)
            logger.info(f"BYOL eval step: the {form} form"
                        + form_note(graphs, captured, mesh))
        modes = [(m, m.training) for m in online.modules()] + \
            [(m, m.training) for m in target.modules()]
        online.eval()
        target.eval()
        try:
            inputs = tuple(batch[k] for k in keys)
            if not captured:
                return forward_of(state)(*inputs)
            name = (embeddings, on_device_mixing)
            cache = state.programs.get(name)
            if cache is None:
                cache = state.programs[name] = ProgramCache(
                    forward_of(state), state.params.device,
                    tuple((x.dtype, 0.0) for x in inputs))
            return cache(*inputs)
        finally:  # the train step finds its modes again
            for m, training in modes:
                m.training = training

    return eval_step
