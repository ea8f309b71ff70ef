"""Collective communication groups over host arrays (counterpart of
``ray_tpu/util/collective.py``).

Named groups with allreduce / allgather / reducescatter / broadcast /
send / recv / barrier on numpy values (the Gloo role).  Tensors on the card
never come through here: they sync in the step through the port's
in-graph collectives (`mesh_collective_hints`).

Where the JAX package keeps a group's state in a named rendezvous actor,
the port keeps it in a `torch.distributed.Store` (the KV of
`parallel.coordinator`): the port's actors cannot be reached by name from
another process.  `_store_reduce` does the actor's reduction and also
serves `train.host_collective`:

  * a rank's contribution is its `core.serialization` bytes under
    ``<prefix>/<key>/<rank>``, cut into pieces the store takes (its libuv
    server refuses a value over 8 MiB), with the piece count written last;
  * every rank waits for all ``world_size`` contributions, reads them and
    reduces them in rank order with numpy, as the JAX actor does, so the
    values are its bit for bit;
  * each rank then adds one to a read counter; the last reader deletes the
    key's entries, so the store does not grow with steps (the JAX actor
    never drops a finished key).

Inputs may be numpy-likes or tensors (copied to the host); results are
numpy, as in the JAX package.  Every wait is bounded (120 s by default)
and raises `TimeoutError`.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.serialization import deserialize, serialize_to_bytes

#: bytes a store value holds at most (TCPStore's libuv server takes 8 MiB)
_PIECE = 4 << 20

_groups: Dict[str, "_GroupClient"] = {}
_default_store = None


def _host(value) -> np.ndarray:
    """``value`` as a host numpy array (a tensor is copied off its
    device)."""
    import torch
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: cast the tensor to "
                            "float32 first (allreduce_pytree does)")
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _wait(store, keys: List[str], timeout_s: float, what: str) -> None:
    try:
        store.wait(keys, timedelta(seconds=timeout_s))
    except RuntimeError as e:   # torch.distributed.DistStoreError
        raise TimeoutError(f"{what} timed out after {timeout_s} s") from e


def _put(store, key: str, value) -> int:
    """Write ``value``'s bytes under ``key``; the piece count last, so its
    presence means the whole value is there.  → bytes written."""
    blob = serialize_to_bytes(value)
    n = max(1, -(-len(blob) // _PIECE))
    for i in range(n):
        store.set(f"{key}/{i}", blob[i * _PIECE:(i + 1) * _PIECE])
    store.set(f"{key}/n", str(n))
    return len(blob)


def _get(store, key: str) -> Tuple[Any, int]:
    """The value `_put` wrote under ``key`` (present) and its bytes."""
    n = int(store.get(f"{key}/n"))
    blob = b"".join(store.get(f"{key}/{i}") for i in range(n))
    return deserialize(blob), len(blob)


def _drop(store, key: str) -> None:
    n = int(store.get(f"{key}/n"))
    for i in range(n):
        store.delete_key(f"{key}/{i}")
    store.delete_key(f"{key}/n")


def _combine(values: List[np.ndarray], op: str, world_size: int):
    """The JAX actors' reduction of the rank-ordered contributions."""
    if op == "sum" or op == "mean":
        out = np.sum(values, axis=0)
        if op == "mean":
            out = out / world_size
    elif op == "max":
        out = np.max(values, axis=0)
    elif op == "min":
        out = np.min(values, axis=0)
    elif op == "prod":
        out = np.prod(values, axis=0)
    elif op == "gather":
        out = list(values)
    else:
        raise ValueError(f"unknown reduce op {op!r}")
    return out


def _store_reduce(store, key: str, rank: int, world_size: int, value,
                  op: str, timeout_s: float, held: Optional[list] = None):
    """Contribute ``value`` under ``key`` and return the reduction of every
    rank's contribution.  ``held``, if given, has the bytes of all the
    contributions the store held at once for this key appended."""
    _put(store, f"{key}/{rank}", np.asarray(value))
    _wait(store, [f"{key}/{r}/n" for r in range(world_size)], timeout_s,
          f"collective {key!r}")
    got = [_get(store, f"{key}/{r}") for r in range(world_size)]
    out = _combine([v for v, _ in got], op, world_size)
    if held is not None:
        held.append(sum(n for _, n in got))
    if store.add(f"{key}/read", 1) == world_size:
        for r in range(world_size):
            _drop(store, f"{key}/{r}")
        store.delete_key(f"{key}/read")
    return out


class _GroupClient:
    def __init__(self, name: str, world_size: int, rank: int, store):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.store = store
        self._counters: Dict[str, int] = {}

    def _key(self, tag: str) -> str:
        return f"collective/{self.name}/{tag}/{self._seq(tag)}"

    def _seq(self, tag: str) -> int:
        n = self._counters.get(tag, 0)
        self._counters[tag] = n + 1
        return n

    def reduce(self, value, op: str, tag: str, timeout_s: float):
        return _store_reduce(self.store, self._key(tag), self.rank,
                             self.world_size, _host(value), op, timeout_s)


def init_collective_group(world_size: int, rank: int, *,
                          backend: str = "host",
                          group_name: str = "default",
                          store=None) -> None:
    """Join a named group.  ``backend="host"`` only (numpy through a
    store).  ``store`` is any `torch.distributed.Store` every member
    shares; by default a `TCPStore` at MASTER_ADDR:MASTER_PORT that rank 0
    hosts (one a process, shared by its groups)."""
    global _default_store
    if backend != "host":
        raise ValueError(f"backend {backend!r}: only 'host' (tensors on the "
                         "card use the in-graph collectives, "
                         "mesh_collective_hints)")
    if store is None:
        if _default_store is None:
            from ..parallel.coordinator import _default_store as tcp_store
            _default_store = tcp_store(world_size, rank,
                                       timedelta(seconds=120))
        store = _default_store
    _groups[group_name] = _GroupClient(group_name, world_size, rank, store)


def destroy_collective_group(group_name: str = "default") -> None:
    """Forget the group.  Its keys are already gone: each entry is deleted
    by its last reader, so the name can be joined again."""
    _groups.pop(group_name, None)


def _group(group_name: str) -> _GroupClient:
    if group_name not in _groups:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized "
            "(call init_collective_group)")
    return _groups[group_name]


def allreduce(value, *, op: str = "sum", group_name: str = "default",
              timeout_s: float = 120.0):
    return _group(group_name).reduce(value, op, "ar", timeout_s)


def allgather(value, *, group_name: str = "default",
              timeout_s: float = 120.0) -> List[Any]:
    return _group(group_name).reduce(value, "gather", "ag", timeout_s)


def reducescatter(value, *, op: str = "sum", group_name: str = "default",
                  timeout_s: float = 120.0):
    """Reduce, then return this rank's slice of axis 0 (`np.array_split`:
    uneven splits give the first ranks one row more)."""
    g = _group(group_name)
    full = g.reduce(value, op, "rs", timeout_s)
    chunks = np.array_split(np.asarray(full), g.world_size, axis=0)
    return chunks[g.rank]


def broadcast(value, *, src_rank: int = 0, group_name: str = "default",
              timeout_s: float = 120.0):
    """``src_rank``'s value on every rank; the last of the other ranks to
    read it deletes it."""
    g = _group(group_name)
    key = g._key("bc")
    if g.rank == src_rank:
        value = _host(value)
        if g.world_size > 1:
            _put(g.store, key, value)
        return value
    _wait(g.store, [f"{key}/n"], timeout_s, "broadcast")
    out, _ = _get(g.store, key)
    if g.store.add(f"{key}/read", 1) == g.world_size - 1:
        _drop(g.store, key)
        g.store.delete_key(f"{key}/read")
    return out


def send(value, dst_rank: int, *, group_name: str = "default",
         timeout_s: float = 120.0) -> None:
    g = _group(group_name)
    # Sequence per (src, dst) pair: the nth send from src to dst meets the
    # nth recv of dst from src, whatever the traffic to or from other peers.
    key = f"collective/{g.name}/p2p/{g.rank}->{dst_rank}/" \
          f"{g._seq(f'send:{dst_rank}')}"
    _put(g.store, key, _host(value))


def recv(src_rank: int, *, group_name: str = "default",
         timeout_s: float = 120.0):
    g = _group(group_name)
    key = f"collective/{g.name}/p2p/{src_rank}->{g.rank}/" \
          f"{g._seq(f'recv:{src_rank}')}"
    _wait(g.store, [f"{key}/n"], timeout_s, f"recv from rank {src_rank}")
    out, _ = _get(g.store, key)
    _drop(g.store, key)
    return out


def barrier(*, group_name: str = "default",
            timeout_s: float = 120.0) -> None:
    _group(group_name).reduce(np.zeros(()), "sum", "bar", timeout_s)


def mesh_collective_hints() -> Dict[str, str]:
    """The in-graph equivalent of each op (`ray_tpu_torch.parallel.
    collectives`, on the mesh's process groups)."""
    return {
        "allreduce": "collectives.psum(x, axes)",
        "allgather": "collectives.all_gather(x, axis, dim)",
        "reducescatter": "collectives.psum(x, axes), then this rank's "
                         "block (or a DTensor redistribute to Shard)",
        "broadcast": "replicate via sharding (distribute_tensor(x, mesh, "
                     "[Replicate()]))",
        "send/recv": "collectives.ppermute(x, axis, perm)",
        "alltoall": "collectives.all_to_all(x, axis, split_axis, "
                    "concat_axis)",
    }
