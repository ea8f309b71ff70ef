"""Shared ML primitives of the port (counterpart of ``ray_tpu.air``): the
dict-backed checkpoint, the run configuration and the result of a run."""

from .checkpoint import Checkpoint  # noqa: F401
from .config import CheckpointConfig, FailureConfig, RunConfig  # noqa: F401
from .result import Result  # noqa: F401
