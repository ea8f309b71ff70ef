"""Error types of the port (counterpart of ``ray_tpu/exceptions.py``, the
part the decode engine, the actor layer and Train raise)."""

from __future__ import annotations


class ReplicaUnavailableError(Exception):
    """A decode replica cannot take a session now: its slots and its wait
    queue are full, it is draining, or an admission timed out.

    A typed fast-shed signal, as in the JAX package: a caller maps it to
    503 + ``Retry-After`` and retries elsewhere or later."""

    def __init__(self, deployment: str, retry_after_s: float = 1.0):
        self.deployment = deployment
        self.retry_after_s = retry_after_s
        super().__init__(
            f"no live replicas for deployment {deployment!r} "
            f"(retry after ~{retry_after_s:g}s)")


class ActorDiedError(Exception):
    """An actor's process ended (any exit code, a signal included): every
    pending and later call on it fails with this at once.  Carries the
    process id and its exit code (negative: the signal that ended it)."""

    def __init__(self, actor: str, pid: int, exitcode):
        self.actor = actor
        self.pid = pid
        self.exitcode = exitcode
        super().__init__(f"actor {actor} (pid {pid}) died with exit code "
                         f"{exitcode}")

    def __reduce__(self):
        return (self.__class__, (self.actor, self.pid, self.exitcode))


class GetTimeoutError(TimeoutError):
    """A ``get`` whose results were not all ready within its timeout."""


class CheckpointWriteError(Exception):
    """A checkpoint commit failed durably (ENOSPC/EIO in the staging or
    replace dance).  The previous checkpoint is intact and loadable: the
    manager rolls the dance back before raising, so callers keep training
    and retry the save later."""

    def __init__(self, name: str, detail: str):
        self.name = name
        self.detail = detail
        super().__init__(f"checkpoint {name!r} write failed ({detail}); "
                         f"previous checkpoint kept")

    def __reduce__(self):
        return (self.__class__, (self.name, self.detail))
