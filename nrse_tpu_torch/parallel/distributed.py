"""Data and tensor parallelism over processes: joining the group, and the
host-side and in-step reductions.

Counterpart of ``nrse_tpu/parallel/distributed.py``.  The JAX package runs
one process per host over a global ``('data','model')`` mesh and lets
GSPMD insert the collectives; the port runs one process per GPU (a rank)
in a ``torch.distributed`` group and reduces by hand, with ``all_reduce``
and ``broadcast`` only (the two collectives every backend takes on CUDA
tensors, gloo included).

  * :func:`initialize` / :func:`maybe_initialize` — join the group, from
    the ``tpu.distributed`` config block (``coordinator_address`` →
    ``tcp://``, ``num_processes`` → world size, ``process_id`` → rank) or
    from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); NCCL for ``cuda``, gloo for ``cpu``
    unless the block or the caller names a backend.  A rank that cannot
    join raises: nothing falls back to one process.
  * :func:`leave` — leave the group, every captured CUDA graph of the
    process freed first.
  * :func:`process_count`, :func:`process_index`, :func:`is_primary`,
    :func:`local_device` — the rank's place, and its card
    (``cuda:LOCAL_RANK``).
  * :func:`process_local_indices` — the rank's strided shard of a
    dataset's index space, every shard of one length (a copy of the JAX
    package's numpy function).
  * :func:`aggregate_metrics`, :func:`aggregate_sums`,
    :func:`broadcast_scalar` — host-side scalars agreed across ranks
    (validation pools sums, the early-stopping decision is rank 0's).
  * :func:`all_reduce_sum` — the in-step reduction with a gradient over
    the mesh's data axis: the forward sums across its ranks and so does
    the backward.  Each rank's loss is its part of a global sum (its
    numerator over the global denominator), so the backward's sum gives
    every rank the gradient of the global loss at its own rows.
  * :func:`copy_to_model` and :func:`reduce_from_model` — Megatron's two
    conjugate operators over the mesh's model axis (Shoeybi et al. 2019,
    §3): the first is the identity forward and sums the gradient across
    the model group backward, and goes before the products whose weights
    are split by output rows; the second sums across the model group
    forward and is the identity backward, and goes after the products
    whose weights are split by input columns.  Both sum in float32 (the
    callers keep the row-parallel partial products float32 and round once
    after the sum and the bias, as one rank's whole product is rounded
    once; a bf16 gradient is summed in float32 and cast back).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nrse_tpu_torch.runtime.graphs import release_graphs

# how long a rank waits for the others to join or to reach a collective
TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device_type: str) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               device_type: str = "cuda") -> None:
    """Join the group of ``num_processes`` ranks as ``process_id``, with
    rank 0 listening at ``coordinator_address`` (``host:port``, or a
    ``tcp://`` or ``env://`` URL)."""
    addr = str(coordinator_address)
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend or default_backend(device_type),
                            init_method=addr, world_size=int(num_processes),
                            rank=int(process_id), timeout=TIMEOUT)


def maybe_initialize(config: Mapping[str, Any]) -> bool:
    """Join the group the config or the environment describes; True when
    this call joined one (the caller then destroys it), False when the
    process already belongs to one or runs alone.

    The ``tpu.distributed`` block (as the JAX package reads it, plus the
    port's ``backend``):

    .. code-block:: yaml

        tpu:
          distributed:
            enabled: true
            coordinator_address: "10.0.0.2:29500"
            num_processes: 4
            process_id: 0
            backend: nccl    # default: nccl for cuda, gloo for cpu

    With the block enabled but no address, or without the block, torchrun's
    environment (``WORLD_SIZE`` and ``RANK``, rank 0 at ``MASTER_ADDR:
    MASTER_PORT``) is read; with neither the process runs alone."""
    if dist.is_initialized():
        return False
    block = ((config.get("tpu") or {}).get("distributed") or {})
    device_type = torch.device(
        "cuda" if str(config.get("device", "cuda")) == "gpu"
        else str(config.get("device", "cuda"))).type
    backend = block.get("backend")
    if block.get("enabled", False) and block.get("coordinator_address"):
        initialize(block["coordinator_address"], block["num_processes"],
                   block["process_id"], backend, device_type)
        return True
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        initialize("env://", int(os.environ["WORLD_SIZE"]),
                   int(os.environ["RANK"]), backend, device_type)
        return True
    if block.get("enabled", False):
        raise RuntimeError("tpu.distributed is enabled but names no "
                           "coordinator_address, and torchrun's WORLD_SIZE "
                           "and RANK are not set")
    return False


def leave() -> None:
    """Destroy the group, after freeing every CUDA graph this process
    captured (``runtime.graphs.release_graphs``), on every path out of a
    run, a raised one included: NCCL's end of a group waits for every
    graph that holds its collectives."""
    release_graphs()
    dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that writes logs, checkpoints and wandb."""
    return process_index() == 0


def local_device(device) -> torch.device:
    """The rank's device: a ``cuda`` with no index becomes
    ``cuda:LOCAL_RANK`` (torchrun's variable; the rank modulo the cards
    on the host without it); anything else is kept."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None \
            or not dist.is_initialized():
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        process_index() % max(1, torch.cuda.device_count())
    return torch.device("cuda", index)


def process_local_indices(n_items: int,
                          batch_size_per_process: Optional[int] = None,
                          pid: Optional[int] = None,
                          nproc: Optional[int] = None) -> np.ndarray:
    """This rank's strided shard of ``range(n_items)``.

    Copied from ``nrse_tpu/parallel/distributed.py::process_local_indices``.
    Strided (``pid::nproc``) so class and length distributions stay
    balanced; every shard is truncated to the shortest (and optionally to
    a multiple of the per-process batch), since every rank must run the
    same number of steps or the gradient reduction at the tail deadlocks.
    """
    pid = process_index() if pid is None else pid
    nproc = process_count() if nproc is None else nproc
    shard = np.arange(pid, n_items, nproc, dtype=np.int64)
    min_len = n_items // nproc
    if batch_size_per_process:
        min_len = (min_len // batch_size_per_process) * batch_size_per_process
    return shard[:min_len]


def _collective_device() -> torch.device:
    """Where a host-side scalar goes for a collective: the current card
    under NCCL, which takes nothing else, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _reduce_scalars(metrics: Mapping[str, Any],
                    group=None) -> Dict[str, float]:
    """``{key: Σ over the ranks of group}`` of host scalars, in float64."""
    keys = sorted(metrics)
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float64, device=_collective_device())
    dist.all_reduce(local, group=group)
    return {k: float(v) for k, v in zip(keys, local.cpu().tolist())}


def _data_axis(mesh) -> Tuple[int, Any]:
    """``(ranks, group)`` the host-side reductions run over: the mesh's
    data axis (the ranks of a model group hold the same rows and the same
    values), or every rank without a mesh."""
    if mesh is None or not mesh.tp:
        return process_count(), None
    return (mesh.data if mesh.data_reduce else 1), mesh.data_group


def aggregate_metrics(metrics: Mapping[str, Any],
                      mesh=None) -> Dict[str, float]:
    """The mean over the data axis's ranks of host-side scalar metrics;
    alone, each as a float."""
    n, group = _data_axis(mesh)
    if n == 1:
        return {k: float(v) for k, v in metrics.items()}
    return {k: v / n for k, v in _reduce_scalars(metrics, group).items()}


def aggregate_sums(metrics: Mapping[str, Any],
                   mesh=None) -> Dict[str, float]:
    """The sum over the data axis's ranks of host-side scalar metrics:
    pooled (sum, count) pairs give weighted means, where a mean of
    per-rank means would let an empty bin's placeholder in."""
    n, group = _data_axis(mesh)
    if n == 1:
        return {k: float(v) for k, v in metrics.items()}
    return _reduce_scalars(metrics, group)


def broadcast_scalar(value: float, source: int = 0) -> float:
    """Rank ``source``'s value on every rank (e.g. the early-stopping
    decision)."""
    if process_count() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_collective_device())
    dist.broadcast(t, source)
    return float(t.item())


def barrier() -> None:
    """Every rank waits for the others (after rank 0 wrote a checkpoint
    the others may read); alone, nothing."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum across the group; the backward sums the incoming gradients
    across the group too (each rank's loss is its part of the global
    sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over the data axis of ``mesh`` (a ``parallel.mesh.
    DataMesh``), with a gradient; ``x`` itself without a group."""
    if mesh is None or not mesh.data_reduce:
        return x
    return _AllReduceSum.apply(x, mesh.data_group)


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in float32, cast back to x's dtype (a
    new tensor: x is not touched)."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` forward; its gradient summed over the model group backward.
    Before a product whose weight is split by output rows, and around a
    replicated parameter that each rank uses for its own heads only.  The
    identity without a model axis."""
    if mesh is None or not mesh.tp:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over the model group forward (in float32, cast back to
    x's dtype); the gradient as it is backward.  After a product whose
    weight is split by input columns.  The identity without a model
    axis."""
    if mesh is None or not mesh.tp:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)
