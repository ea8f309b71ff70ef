"""Gang replicas: one Serve replica that spans several processes
(counterpart of ``ray_tpu/serve/gang.py``).

A replica that hosts one sharded program: ``gang_size`` member processes,
each on its own card (``cuda:<rank % cards>``; gloo on the CPU with
``device="cpu"``), joined into one process group and one `DeviceMesh`.
The user callable reads its gang context (mesh, rank, world size, device)
with `get_gang_context()` in ``__init__`` and places its weights over
``ctx.mesh`` (`parallel.shard_pytree`); the model's serving entry points
gather placed weights whole once a call (`models.whole_params`), so every
member computes the same thing and the leader's (rank 0's) value answers
the request.

What differs from the JAX package, and why:

  * Members are actors of the port's own layer (`core.actors`: spawned
    processes on this host), not placement-group actors of a runtime:
    ``gang_strategy`` must be ``"PACK"`` and the record's ``pg`` is None.
    Each member applies ``ray_actor_options["runtime_env"]["env_vars"]``
    through its env dict before the callable is unpickled, and joins the
    gang with `parallel.coordinator.join_mesh_gang` on a `TCPStore` that
    `start_gang_replica` hosts for the replica (MASTER_ADDR /
    MASTER_PORT), the store taking the place of the controller's KV.  On
    the card the kernels are built once, before any member spawns.
  * The fan-out lives in the calling process.  A port handle owns a pipe
    and a process and cannot be sent to another process, so the JAX leader's
    follower handles (``set_peers``) have no counterpart: the record's
    ``handle`` is a `GangHandle` that addresses the gang as one unit.
    ``handle.handle_request.remote(args, kwargs, method)`` keeps the call
    shape the JAX router uses on the leader; under one lock it numbers the
    request, sends ``participate(seq, ...)`` to each follower and then
    ``execute(seq, ...)`` to the leader, and answers with the leader's
    value, a member's error surfacing through one bounded `actors.get`.
  * A sequence gap raises at once.  A port actor answers one call at a
    time in the order sent, so every member sees the requests in the same
    order; a member that waited for an earlier number (as the JAX
    follower does, bounded by ``serve_gang_stall_timeout_s``) would hold
    its only thread while that call sits behind it in the pipe.  The stall
    bound becomes the caller's ``get`` timeout.
  * A member's death (found from its pipe at once, never from a timeout)
    fails the request in flight with `ActorDiedError` and every later one
    with `ReplicaUnavailableError`, without waiting for the leader, which
    may sit in a collective with the dead peer; as in the JAX package the
    whole replica is then to be replaced: `stop_gang_replica` kills every
    member and closes the store.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import inspect
import os
import threading
from typing import Any, Callable, Dict, List, Optional

from ..core import actors
from ..exceptions import (ActorDiedError, GetTimeoutError,
                          ReplicaUnavailableError)

#: seconds `start_gang_replica` waits for every member's mesh join and
#: callable (the JAX package's ``serve_gang_ready_timeout_s``)
serve_gang_ready_timeout_s = 300.0
#: seconds a request may take through the gang before the caller fails it
#: and gives the replica up (the JAX follower's stall bound,
#: ``serve_gang_stall_timeout_s``)
serve_gang_stall_timeout_s = 600.0

_CTX: Optional["GangContext"] = None


@dataclasses.dataclass
class GangContext:
    """What a deployment callable sees when it runs inside a gang."""

    mesh: Any                 # DeviceMesh spanning the gang
    rank: int                 # this member's gang rank (0 = leader)
    world_size: int
    group_name: str
    deployment_name: str
    replica_id: str
    device: Any = None        # this member's torch.device


def get_gang_context() -> Optional[GangContext]:
    """The current gang context, or None outside a gang replica."""
    return _CTX


class GangReplicaWorker:
    """One member of a gang replica.  Rank 0 is the leader."""

    def __init__(self, deployment_name: str, replica_id: str, rank: int,
                 world_size: int, group_name: str, callable_blob: bytes,
                 init_args: tuple, init_kwargs: Dict[str, Any],
                 user_config: Any, mesh_text: Optional[str],
                 device: str = "cuda"):
        global _CTX
        from datetime import timedelta

        import torch
        import torch.distributed as dist

        from ..parallel.coordinator import join_mesh_gang
        from ..parallel.mesh import MeshSpec

        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self.rank = rank
        self.world_size = world_size
        if device == "cpu":
            dev = torch.device("cpu")
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        store = None
        if world_size > 1:
            store = dist.TCPStore(
                os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                is_master=False,
                timeout=timedelta(seconds=serve_gang_ready_timeout_s))
        mesh = join_mesh_gang(
            group_name, world_size, rank=rank, store=store,
            timeout_s=serve_gang_ready_timeout_s,
            spec=MeshSpec.parse(mesh_text) if mesh_text else None,
            device=dev.type)
        _CTX = GangContext(mesh=mesh, rank=rank, world_size=world_size,
                           group_name=group_name,
                           deployment_name=deployment_name,
                           replica_id=replica_id, device=dev)
        fc = actors.loads_function(callable_blob)
        self._is_function = not inspect.isclass(fc)
        self._callable = fc if self._is_function \
            else fc(*init_args, **init_kwargs)
        self._next_seq = 0
        self._num_ongoing = 0
        self._total = 0
        if user_config is not None:
            self.reconfigure(user_config)

    def ready(self) -> bool:
        return True

    def reconfigure(self, user_config: Any) -> bool:
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    # -- request path ------------------------------------------------------
    def execute(self, seq: int, args: tuple, kwargs: Dict[str, Any],
                method: Optional[str] = None) -> Any:
        """The leader's part of request ``seq``: its value answers it."""
        return self._run(seq, args, kwargs, method)

    def participate(self, seq: int, args: tuple, kwargs: Dict[str, Any],
                    method: Optional[str] = None) -> bool:
        """A follower's part of request ``seq``: the same computation, so
        the gang's collectives meet."""
        self._run(seq, args, kwargs, method)
        return True

    def _run(self, seq: int, args: tuple, kwargs: Dict[str, Any],
             method: Optional[str]) -> Any:
        if seq != self._next_seq:
            raise RuntimeError(
                f"gang member {self.rank} of {self.replica_id} got request "
                f"{seq} while expecting {self._next_seq}: a gap in the "
                f"gang's sequence; the replica needs replacement")
        self._num_ongoing += 1
        self._total += 1
        try:
            target = self._callable
            if not self._is_function:
                target = getattr(target, method or "__call__")
            result = target(*args, **kwargs)
            if inspect.iscoroutine(result):
                import asyncio
                result = asyncio.run(result)
            return result
        finally:
            self._num_ongoing -= 1
            self._next_seq = seq + 1

    def stats(self) -> Dict[str, Any]:
        return {"replica_id": self.replica_id, "rank": self.rank,
                "world_size": self.world_size,
                "num_ongoing": self._num_ongoing, "total": self._total}


class _Remote:
    """``handle.<method>.remote(...)``, as on an actor handle."""

    def __init__(self, fn: Callable[..., cf.Future]):
        self.remote = fn


class GangHandle:
    """The calling process's side of a gang replica: one unit to call,
    whatever its size.  ``handle_request``, ``ready``, ``stats`` and
    ``reconfigure`` return `concurrent.futures.Future`s, as actor methods
    do."""

    def __init__(self, name: str, rid: str,
                 members: List[actors.ActorHandle], store: Any,
                 max_concurrency: int):
        self.deployment_name = name
        self.replica_id = rid
        self._members = members
        self._store = store            # the gang's TCPStore, held open
        self._lock = threading.Lock()
        self._seq = 0
        self._failed: Optional[BaseException] = None
        self._num_ongoing = 0
        self._total = 0
        self._waiters = cf.ThreadPoolExecutor(
            max_concurrency, thread_name_prefix=f"serve-gang:{rid}")
        self.handle_request = _Remote(self._handle_request)
        self.ready = _Remote(lambda: self._all("ready"))
        self.reconfigure = _Remote(
            lambda user_config: self._all("reconfigure", user_config))
        self.stats = _Remote(self._stats)

    def __repr__(self):
        return (f"GangHandle({self.deployment_name}/{self.replica_id}, "
                f"{len(self._members)} members)")

    def _handle_request(self, args: tuple, kwargs: Optional[Dict] = None,
                        method: Optional[str] = None) -> cf.Future:
        """Number the request and send it to every member, followers first,
        under one lock: each member runs the gang's requests in one
        order."""
        fut: cf.Future = cf.Future()
        kwargs = kwargs or {}
        with self._lock:
            if self._failed is not None:
                fut.set_exception(
                    ReplicaUnavailableError(self.deployment_name))
                return fut
            seq = self._seq
            self._seq += 1
            parts = [m.participate.remote(seq, args, kwargs, method)
                     for m in self._members[1:]]
            parts.insert(0, self._members[0].execute.remote(
                seq, args, kwargs, method))
            self._num_ongoing += 1
            self._total += 1
        self._waiters.submit(self._settle, fut, parts)
        return fut

    def _settle(self, fut: cf.Future, parts: List[cf.Future]) -> None:
        """The leader's value, or the first error any member gives: a
        member's death at once, a stall after serve_gang_stall_timeout_s.
        Either of those two gives the replica up."""
        try:
            value = actors.get(parts, serve_gang_stall_timeout_s)[0]
        except Exception as e:
            with self._lock:
                if isinstance(e, (ActorDiedError, GetTimeoutError)) \
                        and self._failed is None:
                    self._failed = e
                self._num_ongoing -= 1
            fut.set_exception(e)
        else:
            with self._lock:
                self._num_ongoing -= 1
            fut.set_result(value)

    def _all(self, method: str, *args) -> cf.Future:
        """``method`` on every member; the leader's value."""
        parts = [getattr(m, method).remote(*args) for m in self._members]
        return self._waiters.submit(
            lambda: actors.get(parts, serve_gang_stall_timeout_s)[0])

    def _stats(self) -> cf.Future:
        """The leader's stats, with the requests the gang has taken and
        has in flight counted here."""
        leader = self._members[0].stats.remote()

        def merge():
            st = actors.get(leader, serve_gang_stall_timeout_s)
            with self._lock:
                return {**st, "num_ongoing": self._num_ongoing,
                        "total": self._total}
        return self._waiters.submit(merge)

    def _close(self) -> None:
        with self._lock:
            if self._failed is None:
                self._failed = RuntimeError(f"{self!r} was stopped")
        self._waiters.shutdown(wait=False, cancel_futures=True)
        self._store = None


def start_gang_replica(name: str, rid: str, entry: Dict[str, Any],
                       cfg: Dict[str, Any], *,
                       device: Optional[str] = None) -> Dict[str, Any]:
    """Start one gang replica and block until every member has joined the
    mesh and built its callable.  ``entry`` holds ``callable_blob`` (a
    class or function by `actors.dumps_function`), ``init_args`` and
    ``init_kwargs``; ``cfg`` the deployment's ``gang_size``, ``gang_mesh``
    (MeshSpec text), ``gang_strategy``, ``max_concurrent_queries``,
    ``user_config`` and ``ray_actor_options``.  ``device`` None runs the
    members on the cards (raises without CUDA), ``"cpu"`` on gloo.
    Returns the replica record ``{"id", "handle", "gang", "pg"}``:
    ``handle`` the `GangHandle`, ``gang`` the member actors in rank order,
    ``pg`` None (no placement groups in the port)."""
    from datetime import timedelta

    import torch.distributed as dist

    from ..parallel.coordinator import _free_port, _local_ip

    gang_size = int(cfg.get("gang_size", 1) or 1)
    strategy = cfg.get("gang_strategy") or "PACK"
    if strategy != "PACK":
        raise ValueError(f"gang_strategy {strategy!r}: the port packs every "
                         f"gang member on this host (only 'PACK')")
    if device not in (None, "cpu", "cuda"):
        raise ValueError(f"device {device!r}: None (the card), 'cuda' or "
                         f"'cpu'")
    if device != "cpu":
        from ..device import resolve_device
        from ..kernels import build
        resolve_device(None)           # raises without CUDA
        build.build_all()              # once, before the members load them
    opts = dict(cfg.get("ray_actor_options") or {})
    env = dict((opts.get("runtime_env") or {}).get("env_vars") or {})
    addr, port = _local_ip(), _free_port()
    store = dist.TCPStore(
        addr, port, is_master=True, wait_for_workers=False,
        timeout=timedelta(seconds=serve_gang_ready_timeout_s))
    env.update(MASTER_ADDR=addr, MASTER_PORT=port)
    group_name = f"serve_gang_{rid}"
    members: List[actors.ActorHandle] = []
    try:
        worker = actors.remote(GangReplicaWorker).options(env=env)
        for rank in range(gang_size):
            members.append(worker.remote(
                name, rid, rank, gang_size, group_name,
                entry["callable_blob"], tuple(entry.get("init_args") or ()),
                dict(entry.get("init_kwargs") or {}),
                cfg.get("user_config"), cfg.get("gang_mesh"),
                "cpu" if device == "cpu" else "cuda"))
        # constructors run at once (the mesh join is a barrier): every
        # member ready means the process group linked the gang
        actors.get([m.ready.remote() for m in members],
                   serve_gang_ready_timeout_s)
    except BaseException:
        for m in members:
            actors.kill(m)
        raise
    handle = GangHandle(name, rid, members, store, int(
        cfg.get("max_concurrent_queries", 8)) + 4)
    return {"id": rid, "handle": handle, "gang": members, "pg": None}


def stop_gang_replica(rep: Dict[str, Any]) -> None:
    """Kill every member of the replica and close its store; no process of
    the gang outlives this."""
    for m in rep.get("gang", []):
        actors.kill(m)
    handle = rep.get("handle")
    if isinstance(handle, GangHandle):
        handle._close()
