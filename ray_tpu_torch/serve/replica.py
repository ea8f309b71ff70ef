"""The replica context (counterpart of the part of
``ray_tpu/serve/replica.py`` that the serving path reads:
`ReplicaContext` and `get_replica_context`).

The decode engine looks the context up to name itself after its
deployment and replica (`decode_session.DecodeSessionCore.engine`).  The
port has no single-process replica actor yet, so nothing sets the context:
outside a replica, and inside a gang member (as in the JAX package, whose
gang members never set it), `get_replica_context` raises and the engine
keeps the names ``"decode"`` / ``"local"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ReplicaContext:
    """What ``get_replica_context()`` returns inside a replica."""
    deployment: str
    replica_tag: str


#: set by a replica in its own process before the user callable is built
_replica_context: Optional[ReplicaContext] = None


def get_replica_context() -> ReplicaContext:
    if _replica_context is None:
        raise RuntimeError(
            "get_replica_context() may only be called inside a Serve "
            "replica (deployment __init__ or request handler)")
    return _replica_context
