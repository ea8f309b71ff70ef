"""Error types of the port (counterpart of ``ray_tpu/exceptions.py``, the
part the decode engine raises)."""

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
