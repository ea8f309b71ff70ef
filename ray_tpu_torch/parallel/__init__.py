"""Parallelism layer of the port (counterpart of ``ray_tpu.parallel``): a
`DeviceMesh` with named axes for every strategy (dp / fsdp / pp / sp / tp /
ep) and the ambient mesh (`use_mesh`), the collectives of the JAX
package's SPMD code with their gradients (`collectives`), a logical-axis
sharding-rule engine that places parameter trees on the mesh as DTensors,
the GPipe pipeline (`pipeline`), and the gang bootstrap over a
`torch.distributed.Store` (`coordinator`).  Collectives run over NCCL on
the cards, gloo on the CPU.
"""

import importlib

from .mesh import (  # noqa: F401
    MeshSpec,
    MESH_AXES,
    create_mesh,
    auto_mesh_shape,
    current_mesh,
    local_mesh,
    mesh_shape_for,
    use_mesh,
)
from .coordinator import join_mesh_gang, leave_mesh_gang  # noqa: F401

# The sharding engine and the pipeline import DTensor, about a second of
# import on a CPU that a rank which only joins a gang need not pay: their
# names load on first use.
_LAZY = {
    **{name: "sharding" for name in (
        "PartitionSpec", "ShardingRules", "logical_to_mesh_axes",
        "named_sharding", "pytree_shardings", "shard_pytree", "constrain",
        "batch_sharding", "device_put", "DP_RULES", "FSDP_RULES",
        "TP_RULES", "FSDP_TP_RULES")},
    **{name: "pipeline" for name in (
        "microbatch", "pipeline_apply", "unmicrobatch")},
}
_SUBMODULES = ("collectives", "sharding", "pipeline")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
