"""Parallelism primitives: device meshes and logical sharding rules. Port of
``ray_tpu/parallel``.

Every axis (dp / fsdp / tp / sp / pp / ep) is a named axis of one
``DeviceMesh``; parameters are placed by logical rules, each rank holding its
local shard, and collectives are explicit ``torch.distributed`` calls. The
port runs every axis (``sp`` through ring attention and ``pp`` through the
GPipe schedule, both over :func:`ppermute`); the reference's ``constrain``
is not ported.
"""

from ray_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    Mesh,
    MeshSpec,
    auto_spec,
    check_mesh,
    local_mesh,
    make_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    LogicalRules,
    NamedSharding,
    P,
    PartitionSpec,
    all_gather,
    all_gather_dim,
    all_reduce,
    all_reduce_,
    exchange,
    grad_all_reduce,
    logical_to_mesh_spec,
    named_sharding,
    p2p_transport,
    ppermute,
    reduce_scatter_dim,
    shard_tree,
    shardings_from_logical,
)

__all__ = [
    "MeshSpec",
    "Mesh",
    "AXIS_NAMES",
    "make_mesh",
    "auto_spec",
    "local_mesh",
    "check_mesh",
    "LogicalRules",
    "DEFAULT_RULES",
    "PartitionSpec",
    "P",
    "NamedSharding",
    "logical_to_mesh_spec",
    "named_sharding",
    "shardings_from_logical",
    "shard_tree",
    "all_gather",
    "all_gather_dim",
    "reduce_scatter_dim",
    "all_reduce",
    "all_reduce_",
    "grad_all_reduce",
    "ppermute",
    "exchange",
    "p2p_transport",
]
