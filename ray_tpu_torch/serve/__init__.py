"""Serving of the port (counterpart of ``ray_tpu.serve``): the decode
session core, its continuous-batching engine and the engine's knobs; gang
replicas (`gang`: one replica over a process group) and the replica
context."""

from .config import DecodeEngineConfig  # noqa: F401
from .decode_session import (  # noqa: F401
    ContinuousBatchingEngine,
    DecodeSessionCore,
)
from .prefix_cache import PrefixIndex  # noqa: F401
from .gang import GangContext, get_gang_context  # noqa: F401
