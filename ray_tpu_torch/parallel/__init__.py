"""Parallelism layer of the port (counterpart of ``ray_tpu.parallel``): a
`DeviceMesh` with named axes for every strategy (dp / fsdp / pp / sp / tp /
ep) and the ambient mesh (`use_mesh`), the collectives of the JAX
package's SPMD code with their gradients (`collectives`), a logical-axis
sharding-rule engine that places parameter trees on the mesh as DTensors,
the GPipe pipeline (`pipeline`), and the gang bootstrap over a
`torch.distributed.Store` (`coordinator`).  Collectives run over NCCL on
the cards, gloo on the CPU.
"""

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
from .sharding import (  # noqa: F401
    PartitionSpec,
    ShardingRules,
    logical_to_mesh_axes,
    named_sharding,
    pytree_shardings,
    shard_pytree,
    constrain,
    batch_sharding,
    device_put,
    DP_RULES,
    FSDP_RULES,
    TP_RULES,
    FSDP_TP_RULES,
)
from .coordinator import join_mesh_gang, leave_mesh_gang  # noqa: F401
from .pipeline import microbatch, pipeline_apply, unmicrobatch  # noqa: F401
