"""Host-side collectives of a Train gang (counterpart of
``ray_tpu/train/host_collective.py``).

The Gloo role for host data: the ranks of a `HostArrayConfig` gang
allreduce and gather numpy values without a process group.  Where the JAX
package has a reducer actor that its trainer owns, the port's trainer hosts
a `TCPStore` and each rank reduces through it with
`util.collective._store_reduce` (rank-ordered numpy, the JAX reducer's
values bit for bit; the last reader deletes each key).  Tensors on the card
sync in the step instead (`SpmdConfig`).

With no gang set (outside a `HostArrayConfig` run), `allreduce` returns
its value as it is and `allgather` returns ``[value]``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..util.collective import _host, _store_reduce

_STORE = None            # (store, prefix, world_size, rank) once set
_COUNTERS: Dict[str, int] = {}
_PEAK_HELD = 0    # the most bytes of one reduce's contributions held at once

_OPS = ("sum", "mean", "max", "min", "gather")


def _set_store(store, prefix: str, world_size: int, rank: int) -> None:
    global _STORE, _PEAK_HELD
    _STORE = None if store is None else (store, prefix, world_size, rank)
    _COUNTERS.clear()
    _PEAK_HELD = 0


def peak_held_bytes() -> int:
    """The most bytes of every rank's contribution to one reduce that the
    store held at once, over this process's reduces."""
    return _PEAK_HELD


def _run(key: str, value, op: str, timeout_s: float = 120.0):
    global _PEAK_HELD
    if _STORE is None:
        if op == "gather":
            return [value]
        return np.asarray(value)
    if op not in _OPS:
        raise ValueError(f"unknown op {op}")
    store, prefix, world_size, rank = _STORE
    held: List[int] = []
    try:
        out = _store_reduce(store, f"{prefix}/{key}", rank, world_size,
                            value, op, timeout_s, held=held)
    except TimeoutError as e:
        raise TimeoutError(f"host allreduce {key!r} timed out") from e
    _PEAK_HELD = max(_PEAK_HELD, held[0])
    return out


def _next_key(tag: str) -> str:
    n = _COUNTERS.get(tag, 0)
    _COUNTERS[tag] = n + 1
    return f"{tag}/{n}"


def allreduce(value, op: str = "mean", tag: str = "allreduce"):
    """Blocking allreduce of a numpy-like value across the train gang."""
    return _run(_next_key(tag), _host(value), op)


def allgather(value, tag: str = "allgather"):
    """Every rank's value, in world-rank order."""
    return _run(_next_key(tag), _host(value), "gather")


def barrier(tag: str = "barrier"):
    _run(_next_key(tag), np.zeros(()), "sum")


def _flatten(tree) -> Tuple[list, Any]:
    """Leaves in ``jax.tree_util``'s order (dict keys sorted, None no
    leaf) and the skeleton `_unflatten` fills."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


_LEAF = object()


def _unflatten(skeleton, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it) if node is _LEAF else node

    return walk(skeleton)


def _flat_f32(leaves) -> np.ndarray:
    """The leaves as one float32 host vector.  Tensors on one device are
    joined there and copied to the host once."""
    import torch
    sizes = [l.numel() if isinstance(l, torch.Tensor) else int(np.size(l))
             for l in leaves]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    by_dev: Dict[Any, list] = {}
    for i, l in enumerate(leaves):
        if isinstance(l, torch.Tensor):
            by_dev.setdefault(l.device, []).append(i)
    if len(by_dev) == 1 and len(by_dev[next(iter(by_dev))]) == len(leaves):
        return torch.cat([l.detach().reshape(-1).to(torch.float32)
                          for l in leaves]).cpu().numpy()
    flat = np.empty(int(offs[-1]), np.float32)
    for i, l in enumerate(leaves):
        if not isinstance(l, torch.Tensor):
            flat[offs[i]:offs[i + 1]] = np.ravel(np.asarray(l,
                                                            dtype=np.float32))
    for idx in by_dev.values():
        host = torch.cat([leaves[i].detach().reshape(-1).to(torch.float32)
                          for i in idx]).cpu().numpy()
        o = 0
        for i in idx:
            flat[offs[i]:offs[i + 1]] = host[o:o + sizes[i]]
            o += sizes[i]
    return flat


def allreduce_pytree(tree, op: str = "mean", tag: str = "tree"):
    """Allreduce every leaf of a tree (gradients in host data-parallel
    loops) as one float32 vector.

    Each leaf comes back in its own dtype and shape, and as what went in: a
    tensor as a tensor on its own device, anything else as a numpy array.
    (The JAX function hands back numpy for every leaf, which ``jnp`` code
    takes as it is; torch code does not.)"""
    import torch
    leaves, skeleton = _flatten(tree)
    flat = _flat_f32(leaves) if leaves else np.zeros((0,), np.float32)
    reduced = _run(_next_key(tag), flat, op)
    out, off = [], 0
    on_dev: Dict[Any, torch.Tensor] = {}
    for l in leaves:
        size = l.numel() if isinstance(l, torch.Tensor) else int(np.size(l))
        if isinstance(l, torch.Tensor):
            if l.device not in on_dev:
                on_dev[l.device] = torch.from_numpy(
                    np.ascontiguousarray(reduced, np.float32)).to(l.device)
            out.append(on_dev[l.device][off:off + size].to(l.dtype)
                       .reshape(l.shape))
        else:
            out.append(np.asarray(reduced[off:off + size],
                                  dtype=np.asarray(l).dtype)
                       .reshape(np.shape(l)))
        off += size
    return _unflatten(skeleton, out)
