"""Data and tensor parallelism over processes with ``torch.distributed``
(counterpart of ``nrse_tpu/parallel``): ``distributed`` joins the group
and reduces (over the data axis, and Megatron's two operators over the
model axis), ``mesh`` lays the ranks out as ``data × model``, splits
batches over the data axis and parameters over the model axis and keeps
the replicas equal, ``dryrun`` runs one tiny BYOL step over gloo ranks on
the CPU at both kinds of mesh."""

from nrse_tpu_torch.parallel.mesh import (
    DataMesh,
    broadcast_state,
    gather_state_dict,
    make_mesh,
    mesh_from_config,
    partition_rule,
    replicas_agree,
    shard_batch,
    shard_state_dict,
)

__all__ = [
    "DataMesh",
    "broadcast_state",
    "gather_state_dict",
    "make_mesh",
    "mesh_from_config",
    "partition_rule",
    "replicas_agree",
    "shard_batch",
    "shard_state_dict",
]
