"""A small actor layer over multiprocessing's spawn context (counterpart of
the part of ``ray_tpu/api.py`` that Train uses: ``remote``, ``get``,
``kill``).

``remote(cls).options(env=...).remote(*args)`` starts a fresh Python
process (spawn, never fork: CUDA cannot live in a forked child), applies the
env dict, builds the instance there and returns an `ActorHandle`.
``handle.method.remote(*args)`` sends the call over a pipe and returns a
`concurrent.futures.Future`; the actor runs its calls one at a time in
order.  ``get(futures, timeout)`` always takes a timeout.  A process that
ends, whatever its exit code, fails every pending and later call at once
with `ActorDiedError` (its pid and exit code), found from the pipe's end of
file and the process sentinel, never by waiting out a timeout.  ``kill``
sends SIGTERM, then SIGKILL after a grace period, then joins.  A chaos plan
armed in the parent (`util.fault_injection.arm`) arms every actor spawned
after it.

Calls, arguments and results cross the pipe as `pickle` bytes (a result
pickled twice, so one that cannot be unpickled here fails its own call and
no other), so tensors travel by value.  Functions go by reference
(`dumps_function`); one that cannot (a closure, a lambda) goes by value
through ``cloudpickle`` where it is installed, and is refused with a
`TypeError` where it is not.  Nothing
of the JAX runtime's controller, nodelet or object store is here: every
actor is a child of the process that made it.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import multiprocessing
import multiprocessing.connection as mpc
import os
import pickle
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Union

from ..exceptions import ActorDiedError, GetTimeoutError

_CTX = multiprocessing.get_context("spawn")
#: the longest any one wait of the layer blocks before it looks again
_POLL_S = 1.0
#: how long `kill` waits after SIGTERM, then after SIGKILL
KILL_GRACE_S = 5.0


def dumps_function(fn) -> bytes:
    """``fn`` as bytes: by reference with pickle, else by value with
    cloudpickle where it is installed."""
    try:
        return pickle.dumps(fn)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        try:
            import cloudpickle
        except ImportError:
            raise TypeError(
                f"{fn!r} cannot be pickled by reference (a closure, lambda "
                f"or local function), and cloudpickle, which would carry it "
                f"by value, is not installed: define it at module level"
            ) from e
        return cloudpickle.dumps(fn)


def loads_function(blob: bytes):
    return pickle.loads(blob)


def _error_reply(e: Exception) -> Exception:
    """``e`` with the actor's traceback as a note, if it survives pickling;
    else a RuntimeError carrying its type, message and traceback."""
    tb = "".join(traceback.format_exception(e))
    try:
        e.add_note(f"in the actor (pid {os.getpid()}):\n{tb}")
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}\n{tb}")


def _actor_main(conn, env: Dict[str, Any], blob: bytes, parent: int) -> None:
    """The actor process: apply ``env``, arm the chaos plan it inherited
    (``RAY_TPU_CHAOS_PLAN``), build the instance, then answer calls until
    the parent's end of the pipe closes or the parent is gone.  A
    constructor that raised makes every call raise its error; an exit or
    interrupt raised in a call ends the process, as it would any other
    program."""
    for key, value in env.items():
        os.environ[str(key)] = str(value)
    from ..util import fault_injection
    fault_injection.maybe_arm_from_config()
    instance, init_error = None, None
    try:
        cls, args, kwargs = pickle.loads(blob)
        instance = cls(*args, **kwargs)
    except Exception as e:
        init_error = _error_reply(e)
    while True:
        try:
            while not conn.poll(_POLL_S):
                if os.getppid() != parent:
                    return
            call_id, method, args, kwargs = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            return
        try:
            if init_error is not None:
                raise init_error
            reply = pickle.dumps((call_id, True, pickle.dumps(
                getattr(instance, method)(*args, **kwargs))))
        except Exception as e:
            reply = pickle.dumps(
                (call_id, False, pickle.dumps(_error_reply(e))))
        try:
            conn.send_bytes(reply)
        except (EOFError, OSError):
            return


class _Method:
    def __init__(self, actor: "ActorHandle", name: str):
        self._actor = actor
        self._name = name

    def remote(self, *args, **kwargs) -> cf.Future:
        return self._actor._call(self._name, args, kwargs)


class ActorHandle:
    """A running actor: ``handle.<method>.remote(...)`` → a Future."""

    def __init__(self, cls: type, args: tuple, kwargs: dict,
                 env: Optional[Dict[str, Any]] = None):
        self._name = cls.__name__
        blob = pickle.dumps((cls, args, kwargs))
        self._conn, child = _CTX.Pipe()
        self._proc = _CTX.Process(
            target=_actor_main, args=(child, dict(env or {}), blob,
                                      os.getpid()),
            name=f"actor:{self._name}", daemon=True)
        self._proc.start()
        child.close()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pending: Dict[int, cf.Future] = {}
        self._died: Optional[ActorDiedError] = None
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name=f"actor-reader:{self.pid}")
        self._reader.start()

    @property
    def pid(self) -> int:
        return self._proc.pid

    @property
    def exitcode(self) -> Optional[int]:
        return self._proc.exitcode

    def is_alive(self) -> bool:
        return self._died is None and self._proc.is_alive()

    def __getattr__(self, name: str) -> _Method:
        if name.startswith("_"):
            raise AttributeError(name)
        return _Method(self, name)

    def __repr__(self):
        return f"ActorHandle({self._name}, pid {self.pid})"

    def _call(self, method: str, args: tuple, kwargs: dict) -> cf.Future:
        fut: cf.Future = cf.Future()
        with self._lock:
            if self._died is not None:
                fut.set_exception(self._died)
                return fut
            call_id = next(self._ids)
            msg = pickle.dumps((call_id, method, args, kwargs))
            self._pending[call_id] = fut
            try:
                self._conn.send_bytes(msg)
            except OSError:
                pass    # the process is gone: the reader fails the call
        return fut

    def _read(self) -> None:
        """Resolve replies as they come; at the pipe's end, or once the
        process has ended and its pipe is drained, fail what is left."""
        while True:
            try:
                ready = mpc.wait([self._conn, self._proc.sentinel],
                                 timeout=_POLL_S)
                if self._conn in ready or self._conn.poll():
                    call_id, ok, payload = pickle.loads(
                        self._conn.recv_bytes())
                elif self._proc.sentinel in ready:
                    break
                else:
                    continue
            except (EOFError, OSError):
                break
            with self._lock:
                fut = self._pending.pop(call_id, None)
            if fut is None:
                continue
            try:
                value = pickle.loads(payload)
            except Exception as e:
                ok, value = False, RuntimeError(
                    f"the reply of {self!r} cannot be unpickled here: {e!r}")
            if ok:
                fut.set_result(value)
            else:
                fut.set_exception(value)
        self._proc.join(KILL_GRACE_S)
        died = ActorDiedError(self._name, self.pid, self._proc.exitcode)
        with self._lock:
            self._died = died
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.set_exception(died)


class RemoteClass:
    """``remote(cls)``: ``.options(env=...)`` then ``.remote(*args)``
    starts an actor."""

    def __init__(self, cls: type, env: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._env = dict(env or {})

    def options(self, *, env: Optional[Dict[str, Any]] = None
                ) -> "RemoteClass":
        return RemoteClass(self._cls, {**self._env, **(env or {})})

    def remote(self, *args, **kwargs) -> ActorHandle:
        return ActorHandle(self._cls, args, kwargs, self._env)


def remote(cls: type) -> RemoteClass:
    return RemoteClass(cls)


def get(futures: Union[cf.Future, Sequence[cf.Future]], timeout: float):
    """The results of ``futures`` (one Future or a list), in order.  Raises
    the first error any of them holds as soon as it is known (an actor's
    exception, `ActorDiedError`), and `GetTimeoutError` when they are not
    all ready within ``timeout`` seconds."""
    if timeout is None or not timeout < float("inf"):
        raise ValueError("get needs a finite timeout")
    single = isinstance(futures, cf.Future)
    futs: List[cf.Future] = [futures] if single else list(futures)
    deadline = time.monotonic() + timeout
    pending = set(futs)
    while pending:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise GetTimeoutError(f"{len(pending)} of {len(futs)} results "
                                  f"not ready within {timeout} s")
        done, pending = cf.wait(pending, timeout=remaining,
                                return_when=cf.FIRST_EXCEPTION)
        for fut in done:
            if fut.exception() is not None:
                raise fut.exception()
    out = [fut.result() for fut in futs]
    return out[0] if single else out


def kill(actor: ActorHandle, grace_s: float = KILL_GRACE_S) -> None:
    """SIGTERM, then SIGKILL if the process outlives ``grace_s``, then a
    join; every pending call fails with `ActorDiedError`."""
    proc = actor._proc
    if proc.is_alive():
        proc.terminate()
        proc.join(grace_s)
    if proc.is_alive():
        proc.kill()
        proc.join(grace_s)
    actor._reader.join(grace_s + _POLL_S)
