"""The data mesh: one rank per process, the batch split over the ranks.

Counterpart of ``nrse_tpu/parallel/mesh.py``.  The JAX package builds a
``('data','model')`` device mesh, shards batches over ``data`` and lets
GSPMD insert the collectives.  Here every rank is a process with one
device, so the mesh is the group itself: :func:`make_mesh` returns a
:class:`DataMesh` (world size, rank, device, group), :func:`shard_batch`
keeps the rank's rows of a global batch, :func:`broadcast_state` copies
rank 0's tensors to every rank, and :func:`replicas_agree` checks that the
replicas still hold the same bits.

Not ported yet: the tensor-parallel partition rules
(``param_partition_spec``, ``model > 1``; ``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from nrse_tpu_torch.parallel.distributed import (
    local_device,
    process_count,
    process_index,
)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of a data-parallel run.  ``distributed`` is False for a
    process that runs alone (no group: every reduction is the identity);
    True inside a group, also of one rank, whose collectives then run."""

    world: int
    rank: int
    device: torch.device
    distributed: bool = False
    group: Optional[object] = None  # None: the default group

    def local_batch(self, batch_size: int) -> int:
        """The rows of a global batch of ``batch_size`` each rank holds;
        raises where the batch does not divide over the ranks."""
        if batch_size % self.world:
            raise ValueError(
                f"batch size {batch_size} must be divisible by the mesh's "
                f"'data' axis ({self.world} ranks); adjust the batch size "
                f"or tpu.mesh in the config")
        return batch_size // self.world


def make_mesh(data: int = -1, model: int = 1, device="cuda") -> DataMesh:
    """The data mesh over every rank of the group (one rank without a
    group).  ``data=-1`` means the world size; any other ``data`` must
    equal it: every rank is a process, and the JAX package refuses meshes
    over a subset of the processes (``nrse_tpu/parallel/mesh.py:55-62``).
    ``model > 1`` (tensor parallelism) is not ported yet.  ``device``: a
    ``cuda`` with no index becomes the rank's card,
    ``cuda:LOCAL_RANK``."""
    if int(model) != 1:
        raise ValueError(
            f"tpu.mesh model={model}: tensor parallelism is not ported to "
            "nrse_tpu_torch yet (ROADMAP.md, Queue 1: tensor parallelism, "
            "model > 1); use model: 1")
    world = process_count()
    data = world if int(data) == -1 else int(data)
    if data != world:
        raise ValueError(
            f"tpu.mesh data={data} differs from the {world} ranks of the "
            "group: every rank is a process with one device, and a mesh "
            "over a subset of the processes is refused; use data: -1")
    return DataMesh(world=world, rank=process_index(),
                    device=local_device(device),
                    distributed=dist.is_initialized())


def mesh_from_config(config: Mapping, device) -> DataMesh:
    """:func:`make_mesh` of the config's ``tpu.mesh`` (default data -1,
    model 1)."""
    mesh_cfg = (config.get("tpu") or {}).get("mesh") or {}
    return make_mesh(mesh_cfg.get("data", -1), mesh_cfg.get("model", 1),
                     device)


def shard_batch(mesh: DataMesh, batch: Mapping) -> dict:
    """The rank's rows ``[r·b, (r+1)·b)`` of every array or tensor of a
    global batch (``b`` = the global rows / the world size).  A padded
    batch's ``__count__`` (its real rows, the first ones) becomes the
    rank's real rows: ``clamp(count − r·b, 0, b)``, so the ranks' counts
    sum to the global one."""
    out = {}
    rows = None
    for k, v in batch.items():
        if k == "__count__":
            continue
        n = v.shape[0]
        if rows is None:
            rows = n
        elif n != rows:
            raise ValueError(f"batch entries hold {rows} and {n} rows")
        b = mesh.local_batch(n)
        out[k] = v[mesh.rank * b:(mesh.rank + 1) * b]
    if "__count__" in batch:
        b = mesh.local_batch(rows)
        count = int(batch["__count__"]) - mesh.rank * b
        out["__count__"] = np.asarray(min(max(count, 0), b), np.int32)
    return out


@torch.no_grad()
def broadcast_state(mesh: DataMesh, tensors: Iterable[torch.Tensor],
                    source: int = 0) -> None:
    """Rank ``source``'s values of ``tensors`` on every rank, in place
    (at the start of a run, and after a resume)."""
    if not mesh.distributed:
        return
    for t in tensors:
        dist.broadcast(t, source, group=mesh.group)


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
def replicas_agree(mesh: DataMesh, tensors: Iterable[torch.Tensor]) -> bool:
    """True when every rank holds the same bits in ``tensors``: the max
    and min over ranks of :func:`checksum` agree (one ``all_reduce``)."""
    if not mesh.distributed:
        return True
    c = checksum(tensors)
    both = torch.cat([c, -c])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool((both[:2] + both[2:] == 0).all())
