"""Multi-device scaling: data parallelism over the devices of one host."""

from .mesh_utils import (
    DeviceMesh,
    Replicated,
    Sharded,
    dp_mesh,
    gather,
    make_sharded_fleet_step,
    make_sharded_sqp_fleet,
    replicate,
    shard_batch,
    shard_ekf_fleet,
    shard_pytree,
    shard_trailing,
)

__all__ = [
    "dp_mesh",
    "make_sharded_fleet_step",
    "make_sharded_sqp_fleet",
    "shard_batch",
    "shard_ekf_fleet",
    "shard_pytree",
    "shard_trailing",
    "replicate",
]
