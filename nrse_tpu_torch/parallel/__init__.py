"""Data parallelism over processes with ``torch.distributed`` (counterpart
of ``nrse_tpu/parallel``): ``distributed`` joins the group and reduces,
``mesh`` splits batches over the ranks and keeps the replicas equal,
``dryrun`` runs one tiny BYOL step over gloo ranks on the CPU."""

from nrse_tpu_torch.parallel.mesh import (
    DataMesh,
    broadcast_state,
    make_mesh,
    mesh_from_config,
    replicas_agree,
    shard_batch,
)

__all__ = [
    "DataMesh",
    "broadcast_state",
    "make_mesh",
    "mesh_from_config",
    "replicas_agree",
    "shard_batch",
]
