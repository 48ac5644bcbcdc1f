"""Parallelism of the port: the device mesh over torch.distributed and the
sharding rules (the names follow ``determined_tpu/parallel``)."""

from determined_tpu_torch.config.experiment import MeshConfig
from determined_tpu_torch.parallel.mesh import Mesh, MeshAxes, make_mesh
from determined_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    ShardPlan,
    batch_shard,
    batch_sharding,
    check_ported,
    fsdp_shard_dim,
    logical_to_mesh_spec,
    shard_model,
)

__all__ = [
    "DEFAULT_RULES",
    "Mesh",
    "MeshAxes",
    "MeshConfig",
    "ShardPlan",
    "batch_shard",
    "batch_sharding",
    "check_ported",
    "fsdp_shard_dim",
    "logical_to_mesh_spec",
    "make_mesh",
    "shard_model",
]
