"""The ``('data', 'model')`` mesh: one rank per process, the batch split
over the data axis, the WavLM layers split Megatron-style over the model
axis.

Counterpart of ``nrse_tpu/parallel/mesh.py``.  The JAX package builds a
device mesh, shards batches over ``data``, shards the layers' matmul
weights over ``model`` by ``param_partition_spec`` and lets GSPMD insert
the collectives.  Here every rank is a process with one device, so the
mesh is the group itself, laid out as JAX lays its devices
(``np.asarray(devices).reshape(data, model)``): rank ``r`` sits at ``(r //
model, r % model)``.  :func:`make_mesh` returns a :class:`DataMesh`
carrying the world, the rank's coordinates and two sets of groups made
once with ``dist.new_group``: the **data group** (the ranks with this
rank's model index, over which gradients and batch statistics are summed)
and the **model group** (the ranks with this rank's data index, which
hold the shards of one layer and see the same rows).

  * :func:`shard_batch` keeps the data coordinate's rows of a global batch;
  * :func:`partition_rule` is ``param_partition_spec`` for the port's
    state-dict names in torch's ``[out, in]`` layout: the dimension split
    over ``model``, or None for a replicated tensor;
    :func:`shard_state_dict` and :func:`gather_state_dict` take a ``model:
    1`` state dict to this rank's shards and back, bit for bit;
  * :func:`broadcast_state` copies a source rank's tensors over a group and
    :func:`replicas_agree` checks that the ranks of a group hold the same
    bits;
  * :func:`capturable` says whether a step under a mesh runs from captured
    CUDA graphs: on a card, with no group or an NCCL one.  Every group a
    step uses has its NCCL communicator made by :func:`make_mesh`, with one
    eager collective each, so that no capture creates one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from nrse_tpu_torch.parallel.distributed import (
    local_device,
    process_count,
    process_index,
)

# WavLM-large's heads: the model axis must divide them
DEFAULT_HEADS = 16


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of a run, ``data × model`` of them.  ``distributed`` is
    False for a process that runs alone (no group: every reduction is the
    identity); True inside a group, also of one rank, whose collectives
    then run.  ``data_group`` holds the ranks with this rank's model index
    (None: the default group, every rank, which it is when ``model`` is
    1); ``model_group`` the ranks with this rank's data index (None when
    ``model`` is 1); ``backend`` the group's (None without one)."""

    world: int
    rank: int
    device: torch.device
    distributed: bool = False
    model: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    backend: Optional[str] = None

    @property
    def data(self) -> int:
        """The size of the data axis."""
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def tp(self) -> bool:
        """True when the layers are split over a model axis of 2 or more."""
        return self.model > 1

    @property
    def data_reduce(self) -> bool:
        """Whether the data axis's reductions run: in a group, unless the
        data axis of a tensor-parallel mesh is one rank (a data group of
        one, whose sums are the identity)."""
        return self.distributed and (self.data > 1 or not self.tp)

    def model_rank(self, index: int) -> int:
        """The global rank at model index ``index`` of this rank's model
        group."""
        return self.data_index * self.model + index

    def data_rank(self, index: int) -> int:
        """The global rank at data index ``index`` of this rank's data
        group."""
        return index * self.model + self.model_index

    def local_batch(self, batch_size: int) -> int:
        """The rows of a global batch of ``batch_size`` each rank holds;
        raises where the batch does not divide over the data axis."""
        if batch_size % self.data:
            raise ValueError(
                f"batch size {batch_size} must be divisible by the mesh's "
                f"'data' axis ({self.data} ranks); adjust the batch size "
                f"or tpu.mesh in the config")
        return batch_size // self.data


def make_mesh(data: int = -1, model: int = 1, device="cuda",
              heads: int = DEFAULT_HEADS) -> DataMesh:
    """The ``data × model`` mesh over every rank of the group (one rank
    without a group).  ``data=-1`` means the world size over ``model``; any
    other ``data`` must make ``data·model`` the world size: every rank is a
    process, and the JAX package refuses meshes over a subset of the
    processes (``nrse_tpu/parallel/mesh.py:55-62``).  ``model`` must divide
    ``heads``, the encoder's attention heads (WavLM-large's 16 unless
    given).  ``device``: a ``cuda`` with no index becomes the rank's card,
    ``cuda:LOCAL_RANK``.  Every rank of the group must call it: the groups
    of the two axes are made here."""
    model, heads = int(model), int(heads)
    if model < 1 or heads % model:
        raise ValueError(
            f"tpu.mesh model={model}: the model axis splits the "
            f"{heads} attention heads, so it must divide {heads}")
    world = process_count()
    if int(data) == -1:
        if world % model:
            raise ValueError(
                f"tpu.mesh model={model} needs a multiple of {model} ranks "
                f"(data x model of them), and the group has {world}; start "
                f"{model}, {2 * model}, ... ranks or use model: 1")
        data = world // model
    data = int(data)
    if data * model != world:
        raise ValueError(
            f"tpu.mesh data={data} x model={model} differs from the {world} "
            "ranks of the group: every rank is a process with one device, "
            "and a mesh over a subset of the processes is refused; use "
            "data: -1")
    rank = process_index()
    groups = {}
    if model > 1:
        # every rank makes every group, in one order
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if j == rank % model:
                groups["data_group"] = g
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if i == rank // model:
                groups["model_group"] = g
    mesh = DataMesh(world=world, rank=rank, device=local_device(device),
                    distributed=dist.is_initialized(), model=model,
                    backend=dist.get_backend() if dist.is_initialized()
                    else None, **groups)
    if mesh.backend == "nccl" and mesh.device.type == "cuda":
        _make_communicators(mesh)
    return mesh


def _make_communicators(mesh: DataMesh) -> None:
    """One eager ``all_reduce`` over the world and over each of the rank's
    groups: NCCL makes a group's communicator at its first collective, and
    that must not be inside a CUDA graph's capture (the optimizer parts of
    a captured step are captured without a warm-up)."""
    x = torch.zeros(1, device=mesh.device)
    for group in [None] + [g for g in (mesh.data_group, mesh.model_group)
                           if g is not None]:
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize(mesh.device)


def capturable(mesh: Optional[DataMesh], device) -> bool:
    """Whether a train step on ``device`` under ``mesh`` runs from
    captured CUDA graphs: on a card, alone or in an NCCL group, whose
    collectives a graph holds.  A gloo group's collectives copy through
    the host and cannot be captured, and nothing is captured on the
    CPU."""
    if torch.device(device).type != "cuda":
        return False
    return mesh is None or not mesh.distributed or mesh.backend == "nccl"


def form_note(graphs: bool, captured: bool,
              mesh: Optional[DataMesh]) -> str:
    """What a step's log line adds to the form it names (``captured`` or
    eager): the group it ran in, or why it ran eagerly."""
    if not graphs:
        return " (graphs off)"
    if mesh is None or not mesh.distributed:
        return ""
    return (f" (a {mesh.backend} mesh of {mesh.world} ranks, data "
            f"{mesh.data} x model {mesh.model}"
            + ("" if captured else
               ": a gloo group's collectives cannot be captured") + ")")


def mesh_from_config(config: Mapping, device,
                     heads: int = DEFAULT_HEADS) -> DataMesh:
    """:func:`make_mesh` of the config's ``tpu.mesh`` (default data -1,
    model 1) for an encoder of ``heads`` attention heads."""
    mesh_cfg = (config.get("tpu") or {}).get("mesh") or {}
    return make_mesh(mesh_cfg.get("data", -1), mesh_cfg.get("model", 1),
                     device, heads)


def shard_batch(mesh: DataMesh, batch: Mapping) -> dict:
    """The data coordinate's rows ``[d·b, (d+1)·b)`` of every array or
    tensor of a global batch (``b`` = the global rows / the data axis, ``d``
    the rank's data index; the ranks of a model group get the same rows).
    A padded batch's ``__count__`` (its real rows, the first ones) becomes
    the rank's real rows: ``clamp(count − d·b, 0, b)``, so the counts of
    one model index sum to the global one."""
    out = {}
    rows = None
    d = mesh.data_index
    for k, v in batch.items():
        if k == "__count__":
            continue
        n = v.shape[0]
        if rows is None:
            rows = n
        elif n != rows:
            raise ValueError(f"batch entries hold {rows} and {n} rows")
        b = mesh.local_batch(n)
        out[k] = v[d * b:(d + 1) * b]
    if "__count__" in batch:
        b = mesh.local_batch(rows)
        count = int(batch["__count__"]) - d * b
        out["__count__"] = np.asarray(min(max(count, 0), b), np.int32)
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel partition rules
# ---------------------------------------------------------------------------

# modules split by their output rows (heads, FFN columns), and by their
# input columns
ROW_SPLIT = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
COLUMN_SPLIT = ("out_proj", "output_dense")


def partition_rule(name: str, tensor) -> Optional[int]:
    """The dimension of a parameter of the port's WavLM or BYOL state dict
    split over the ``model`` axis, or None where it is replicated.  The
    port's counterpart of ``param_partition_spec``
    (``nrse_tpu/parallel/mesh.py:151-179``) in torch's ``[out, in]``
    layout, per layer (JAX's leaves are stacked ``[L, in, out]``):

      * q/k/v projections and the FFN's ``intermediate_dense``: the weight
        by its output rows (dim 0), the bias with them;
      * ``out_proj`` and the FFN's ``output_dense``: the weight by its
        input columns (dim 1), the bias replicated;
      * everything else replicated."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    leaf, module = parts[-1], parts[-2]
    ndim = len(tensor.shape)
    if leaf == "weight" and ndim == 2:
        if module in ROW_SPLIT:
            return 0
        if module == "out_proj" or (module == "output_dense"
                                    and "feed_forward" in parts):
            return 1
    if leaf == "bias" and ndim == 1 and module in ROW_SPLIT:
        return 0
    return None


def _part(value, dim: int, parts: int, index: int):
    """Part ``index`` of ``parts`` equal parts of ``value`` (a tensor or a
    numpy array) along ``dim``, contiguous."""
    n = value.shape[dim]
    if n % parts:
        raise ValueError(f"a dimension of {n} does not split into {parts} "
                         "equal parts over the model axis")
    size = n // parts
    idx = [slice(None)] * len(value.shape)
    idx[dim] = slice(index * size, (index + 1) * size)
    part = value[tuple(idx)]
    if torch.is_tensor(part):
        return part.contiguous().clone()
    return np.ascontiguousarray(part).copy()


def shard_state_dict(state_dict: Mapping, mesh: DataMesh) -> Dict:
    """This rank's shards of a ``model: 1`` state dict (tensors or numpy
    arrays): the model index's part of every tensor :func:`partition_rule`
    splits, the others as they are (all of them without a model
    axis)."""
    if mesh is None or not mesh.tp:
        return dict(state_dict)
    out = {}
    for k, v in state_dict.items():
        dim = partition_rule(k, v)
        out[k] = v if dim is None else _part(v, dim, mesh.model,
                                             mesh.model_index)
    return out


@torch.no_grad()
def gather_state_dict(local: Mapping[str, torch.Tensor],
                      mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """The ``model: 1`` state dict of the model group's shards (the
    inverse of :func:`shard_state_dict`, bit for bit), on every rank of
    the group: each model rank broadcasts its split tensors packed into one
    buffer per dtype, and the parts are joined along their split
    dimension.  A collective over the model group: its ranks all call
    it.  Without a model axis (or a mesh) ``local`` itself."""
    if mesh is None or not mesh.tp:
        return dict(local)
    split = {k: partition_rule(k, v) for k, v in local.items()}
    out = {k: v for k, v in local.items() if split[k] is None}
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in local.items():
        if split[k] is not None:
            by_dtype.setdefault(v.dtype, []).append(k)
    for names in by_dtype.values():
        pack = torch.cat([local[k].reshape(-1) for k in names])
        parts = []
        for j in range(mesh.model):
            buf = pack if j == mesh.model_index else torch.empty_like(pack)
            dist.broadcast(buf, mesh.model_rank(j), group=mesh.model_group)
            parts.append(buf)
        off = 0
        for k in names:
            v = local[k]
            n = v.numel()
            out[k] = torch.cat([p[off:off + n].view(v.shape) for p in parts],
                               dim=split[k])
            off += n
    return {k: out[k] for k in local}


# ---------------------------------------------------------------------------
# Replicas
# ---------------------------------------------------------------------------

@torch.no_grad()
def broadcast_state(mesh: DataMesh, tensors: Iterable[torch.Tensor],
                    source: int = 0, group=None) -> None:
    """Rank ``source``'s values of ``tensors`` on every rank of ``group``
    (the world by default), in place (at the start of a run, and after a
    resume).  ``source`` is a global rank of the group."""
    if not mesh.distributed:
        return
    for t in tensors:
        dist.broadcast(t, source, group=group)


CHECKSUM_CHUNK = 1 << 24  # elements summed at a time
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def checksum(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Two int64 sums (wrapping) of the tensors' bits, word by word:
    plain, and each word weighted by its position modulo 1024 plus 1, so
    that swapped values change it too."""
    total = None
    for t in tensors:
        words = t.detach().reshape(-1)
        words = words.view(_WORDS[words.element_size()])
        for chunk in words.split(CHECKSUM_CHUNK):
            w = chunk.to(torch.int64)
            pos = torch.arange(w.numel(), device=w.device) % 1024 + 1
            s = torch.stack([w.sum(), (w * pos).sum()])
            total = s if total is None else total + s
    if total is None:
        raise ValueError("no tensors to checksum")
    return total


@torch.no_grad()
def replicas_agree(mesh: DataMesh, tensors: Iterable[torch.Tensor],
                   group=None) -> bool:
    """True when every rank of ``group`` (the world by default) holds the
    same bits in ``tensors``: the max and min over the ranks of
    :func:`checksum` agree (one ``all_reduce``)."""
    if not mesh.distributed:
        return True
    c = checksum(tensors)
    both = torch.cat([c, -c])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    return bool((both[:2] + both[2:] == 0).all())
