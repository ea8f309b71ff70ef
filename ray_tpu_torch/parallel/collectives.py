"""The collectives of ``jax.lax`` the JAX package's SPMD code uses, over one
named axis of a `DeviceMesh`, each with its gradient.

Gradients follow JAX's rule for values that are the same on every rank of
an axis (invariant) and values that differ (varying): `psum` makes a
varying value invariant and hands each rank's input the gradient of the
result once (its backward is the identity, JAX's transpose of ``psum``);
`pvary` marks an invariant value as used by varying code and sums the
ranks' gradients of it (its backward is a `psum`).  Code that runs the same
loss on every rank and takes each rank's gradients this way gets, summed
over the ranks that hold distinct parts of the data, the gradient of the
one global loss.

Every function takes the mesh (default: `current_mesh`) and skips its
communication where the axis has size 1: a rank never sends to itself.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size, current_mesh

Axes = Union[str, Sequence[str]]


def _mesh(mesh: Optional[DeviceMesh]) -> DeviceMesh:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass one or enter use_mesh(mesh)")
    return mesh


def _live(mesh: DeviceMesh, axes: Axes) -> Tuple[str, ...]:
    """The axes of ``axes`` the mesh has with size > 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if axis_size(a, mesh) > 1)


def axis_index(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's coordinate on ``axis`` (0 where the mesh lacks it)."""
    mesh = _mesh(mesh)
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def _all_reduce(x: torch.Tensor, mesh: DeviceMesh,
                axes: Tuple[str, ...]) -> torch.Tensor:
    out = x.contiguous().clone()
    for a in axes:
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, axes: Axes,
         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (``jax.lax.psum``); the backward hands
    each rank's input the result's gradient unchanged."""
    mesh = _mesh(mesh)
    live = _live(mesh, axes)
    return _Psum.apply(x, mesh, live) if live else x


def pvary(x: torch.Tensor, axes: Axes,
          mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """``x`` itself, its gradient summed over the ranks of ``axes``: an
    invariant value entering code that differs across those ranks."""
    mesh = _mesh(mesh)
    live = _live(mesh, axes)
    return _Pvary.apply(x, mesh, live) if live else x


def _permute(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """Send ``x`` to ``dst`` for (me, dst) in perm, receive from ``src`` for
    (src, me); zeros where nothing arrives."""
    group = mesh.get_group(axis)
    me = mesh.get_local_rank(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = tuple((dst, src) for src, dst in perm)
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, ctx.axis, ctx.inverse), None, None, None


def ppermute(x: torch.Tensor, axis: str, perm: Iterable[Tuple[int, int]],
             mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """``jax.lax.ppermute``: (src, dst) pairs of axis indices; a rank no
    pair sends to gets zeros.  The backward runs the inverse permutation.
    At axis size 1 nothing is sent."""
    mesh = _mesh(mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if axis_size(axis, mesh) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Ppermute.apply(x, mesh, axis, perm)


def _all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                split: int, concat: int) -> torch.Tensor:
    n = axis_size(axis, mesh)
    shape = list(x.shape)
    # [.., n, chunk, ..] with the chunk index in front: chunk j goes to j
    parts = x.unflatten(split, (n, shape[split] // n)).movedim(split, 0)
    send = parts.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    # what rank j sent sits at j: it becomes block j of the concat axis
    got = recv.movedim(0, concat)
    return got.flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.args = (mesh, axis, concat, split)
        return _all_to_all(x, mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g.contiguous(), *ctx.args),
                None, None, None, None)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int, mesh: Optional[DeviceMesh] = None
               ) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``split_axis`` cut into
    axis-size blocks, block j sent to rank j, the received blocks joined
    along ``concat_axis`` in rank order."""
    mesh = _mesh(mesh)
    if axis_size(axis, mesh) == 1:
        return x
    split_axis %= x.dim()
    concat_axis %= x.dim()
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _gather(x: torch.Tensor, mesh: DeviceMesh, axis: str,
            dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(axis_size(axis, mesh))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, mesh: DeviceMesh, axis: str,
           dim: int) -> torch.Tensor:
    n, i = axis_size(axis, mesh), mesh.get_local_rank(axis)
    return x.chunk(n, dim=dim)[i]


class _GatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, *ctx.args).contiguous(), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        summed = _all_reduce(g, mesh, (axis,))
        return _chunk(summed, mesh, axis, dim).contiguous(), None, None, None


class _ShardInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _chunk(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


def all_gather(x: torch.Tensor, axis: str, dim: int,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: the ranks' blocks of
    ``axis`` joined along ``dim`` in rank order.  Each rank may use the
    result its own way: a block's gradient is the sum of every rank's
    gradient of it (JAX's transpose, ``psum_scatter``)."""
    mesh = _mesh(mesh)
    if axis_size(axis, mesh) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim())


def all_gather_invariant(x: torch.Tensor, axis: str, dim: int,
                         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """`all_gather` for a result every rank uses the same way (a value the
    same on every rank): each rank's block gets its own part of the
    result's gradient, once."""
    mesh = _mesh(mesh)
    if axis_size(axis, mesh) == 1:
        return x
    return _GatherInvariant.apply(x, mesh, axis, dim % x.dim())


def shard(x: torch.Tensor, axis: str, dim: int,
          mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """This rank's block of ``dim`` of a value the same on every rank of
    ``axis``; the blocks' gradients are gathered back, so ``x``'s gradient
    is whole on every rank.  The inverse of `all_gather_invariant`."""
    mesh = _mesh(mesh)
    if axis_size(axis, mesh) == 1:
        return x
    return _ShardInvariant.apply(x, mesh, axis, dim % x.dim())
