"""Training entry points of the port (counterpart of ``ray_tpu.train``):
the Train gang on the port's actor layer (`TorchTrainer` → `BackendExecutor`
→ `WorkerGroup` of spawned rank processes → the train function with
``air.session.report``; NCCL on the card, gloo on the CPU, or no process
group and `host_collective` on a store with `HostArrayConfig`) and the RL
trainer."""

from .backend import (  # noqa: F401
    Backend,
    BackendConfig,
    HostArrayConfig,
    SpmdConfig,
)
from .backend_executor import (  # noqa: F401
    BackendExecutor,
    TrainingFailedError,
)
from .checkpointing import CheckpointManager  # noqa: F401
from .rl import RLTrainer  # noqa: F401
from .trainer import TorchCompatTrainer, TorchTrainer  # noqa: F401
from .worker_group import WorkerGroup  # noqa: F401
