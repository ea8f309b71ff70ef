"""Shared ML primitives of the port (counterpart of ``ray_tpu.air``): the
checkpoint (dicts, directories, sharded trees of tensors), the run and scaling configuration, the result of a
run and the in-train-loop session."""

from .checkpoint import Checkpoint  # noqa: F401
from .config import (  # noqa: F401
    CheckpointConfig,
    ElasticConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .result import Result  # noqa: F401
from . import session  # noqa: F401
