"""Multi-process mesh bootstrap (counterpart of
``ray_tpu/parallel/coordinator.py``).

The JAX package's gang rendezvouses through the runtime controller's KV:
ranks are claimed with a compare-and-set put, rank 0 publishes the
coordinator address and every member calls ``jax.distributed.initialize``.
The port has no runtime yet, so its KV is a `torch.distributed.Store`: a
`TCPStore` at ``MASTER_ADDR:MASTER_PORT`` by default, or any store the
caller passes (a `FileStore` on a shared path will do).  Each member
claims the lowest free rank with ``compare_set``, then
``init_process_group`` runs on a store prefixed by the gang's name and the
mesh is built over the group.

A gang of one needs no rendezvous: `create_mesh` starts a one-rank group.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Dict, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import MeshSpec, create_mesh

_NS = "mesh_gang"
_STORES: Dict[str, dist.Store] = {}


def _default_store(world_size: int, rank: Optional[int],
                   timeout: timedelta) -> dist.Store:
    """A TCPStore at MASTER_ADDR:MASTER_PORT; rank 0 (or, with no rank
    given, whoever binds the port first) hosts it."""
    host = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = int(os.environ["MASTER_PORT"])
    if rank is not None:
        return dist.TCPStore(host, port, world_size, rank == 0,
                             timeout=timeout, wait_for_workers=False)
    try:
        return dist.TCPStore(host, port, world_size, True, timeout=timeout,
                             wait_for_workers=False)
    except (RuntimeError, OSError):
        return dist.TCPStore(host, port, world_size, False, timeout=timeout)


def join_mesh_gang(group_name: str, world_size: int,
                   rank: Optional[int] = None, *,
                   store: Optional[dist.Store] = None,
                   timeout_s: float = 120.0,
                   spec: Optional[MeshSpec] = None,
                   device: Optional[str] = None) -> DeviceMesh:
    """Join the named gang and return a mesh spanning it.

    Every member calls this with the same ``group_name`` / ``world_size``
    (and ``store``, or the same MASTER_ADDR / MASTER_PORT).  A member that
    passes no ``rank`` claims the lowest unclaimed one with a
    compare-and-set on the store.  ``device`` is "cuda" (NCCL, each rank
    on ``cuda:<rank % cards>``) or "cpu" (gloo)."""
    if world_size <= 1:
        return create_mesh(spec, device=device)
    timeout = timedelta(seconds=timeout_s)
    if store is None:
        store = _default_store(world_size, rank, timeout)
    store.set_timeout(timeout)
    if rank is None:
        claim = f"{socket.gethostname()}:{os.getpid()}".encode()
        for r in range(world_size):
            key = f"{_NS}/{group_name}/rank/{r}"
            if store.compare_set(key, b"", claim) == claim:
                rank = r
                break
        if rank is None:
            raise TimeoutError(f"could not claim a rank in {group_name}: "
                               f"all {world_size} slots taken")
    device = device or "cuda"
    if device == "cuda":
        import torch
        torch.cuda.set_device(rank % torch.cuda.device_count())
    _STORES[group_name] = store
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        store=dist.PrefixStore(f"{_NS}/{group_name}/pg", store),
        rank=rank, world_size=world_size, timeout=timeout)
    return create_mesh(spec, device=device)


def leave_mesh_gang(group_name: str) -> None:
    """Drop this member's rank claims of ``group_name`` and tear the
    process group down."""
    store = _STORES.pop(group_name, None)
    if store is not None:
        for r in range(dist.get_world_size() if dist.is_initialized()
                       else 0):
            try:
                store.delete_key(f"{_NS}/{group_name}/rank/{r}")
            except (RuntimeError, NotImplementedError):
                pass
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _local_ip() -> str:
    """This host's address as its peers would reach it; the loopback
    address where name resolution gives none."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
