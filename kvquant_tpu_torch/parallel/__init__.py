"""Tensor and data parallelism on torch.distributed (port of
kvquant_tpu/parallel): one process per rank, rank-local shards, explicit
collectives (``collectives``)."""

from .mesh import make_mesh, Mesh, MeshConfig
from .shardings import (
    param_shardings,
    cache_shardings,
    quant_shardings,
    data_sharding,
    shard_params,
    shard_cache,
    shard_quant,
    shard_config,
    shard_data,
)

__all__ = [
    "make_mesh",
    "Mesh",
    "MeshConfig",
    "param_shardings",
    "cache_shardings",
    "quant_shardings",
    "data_sharding",
    "shard_params",
    "shard_cache",
    "shard_quant",
    "shard_config",
    "shard_data",
]
