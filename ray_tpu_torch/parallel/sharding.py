"""Logical-axis sharding rules (counterpart of
``ray_tpu/parallel/sharding.py``).

Model code names every parameter's dimensions with *logical* axes
(("embed", "mlp"), ("heads", "kv"), ...) and a `ShardingRules` table maps
them onto mesh axes: swapping DP for FSDP for FSDP×TP is a change of rules,
not of the model.  A spec (`PartitionSpec`, one entry per tensor dimension:
a mesh axis, a tuple of them, or None) becomes DTensor placements, one per
mesh dimension; `shard_pytree` places a parameter tree as DTensors, so
``to_local()`` on rank r is the shard JAX's device r holds.

A tensor dimension split over several mesh axes is split in the order the
mesh lists them (major to minor), as in JAX; a spec that names them in
another order is refused.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from .collectives import pvary
from .mesh import axis_sizes, current_mesh

logger = logging.getLogger(__name__)

MeshAxis = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis, a tuple of mesh axes or
    None (replicated); ``jax.sharding.PartitionSpec``'s shape."""

    def __new__(cls, *entries: MeshAxis) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class ShardingRules(dict):
    """logical axis name → mesh axis (str), tuple of mesh axes, or None."""

    def spec_for(self, logical_axes: Optional[Sequence[str]]
                 ) -> PartitionSpec:
        if logical_axes is None:
            return P()
        return P(*(self.get(a) for a in logical_axes))

    def with_overrides(self, **overrides: MeshAxis) -> "ShardingRules":
        new = ShardingRules(self)
        new.update(overrides)
        return new


# Canonical rule tables for transformer-family models, as in the JAX
# package.  Logical names: batch, seq, embed, mlp, heads, kv, vocab, expert,
# stage (pipeline), kv_seq.
DP_RULES = ShardingRules(
    batch=("dp", "fsdp"), seq=None, embed=None, mlp=None, heads=None,
    kv=None, vocab=None, expert=None, stage=None, kv_seq=None)

FSDP_RULES = ShardingRules(
    batch=("dp", "fsdp"), seq=None, embed="fsdp", mlp=None, heads=None,
    kv=None, vocab=None, expert=None, stage=None, kv_seq=None)

TP_RULES = ShardingRules(
    batch=("dp", "fsdp"), seq=None, embed=None, mlp="tp", heads="tp",
    kv=None, vocab="tp", expert=None, stage=None, kv_seq=None)

FSDP_TP_RULES = ShardingRules(
    batch=("dp", "fsdp"), seq="sp", embed="fsdp", mlp="tp", heads="tp",
    kv=None, vocab="tp", expert="ep", stage="pp", kv_seq=None)


def logical_to_mesh_axes(logical_axes: Optional[Sequence[str]],
                         rules: Mapping[str, MeshAxis]) -> PartitionSpec:
    if logical_axes is None:
        return P()
    return P(*(rules.get(a) for a in logical_axes))


def _axes_of(entry: MeshAxis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _drop_missing_axes(spec: PartitionSpec,
                       mesh: DeviceMesh) -> PartitionSpec:
    """Remove mesh axes the mesh doesn't have (lets the same rules run on a
    mesh without the trivial axes)."""
    names = mesh.mesh_dim_names

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None
    return P(*(fix(e) for e in spec))


def _drop_nondividing_axes(spec: PartitionSpec, mesh: DeviceMesh,
                           shape) -> PartitionSpec:
    """Replicate any dimension whose mesh-axis product does not divide it
    (GQA kv heads under tp > n_kv_heads, an odd vocab under wide tp)."""
    sizes = axis_sizes(mesh)
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(
            f"sharding spec {spec} has {len(entries)} entries for a "
            f"rank-{len(shape)} array of shape {tuple(shape)} — bad "
            "logical-axes annotation")
    entries = entries + (None,) * (len(shape) - len(entries))

    def fix(entry, dim):
        if entry is None:
            return None
        prod = 1
        for a in _axes_of(entry):
            prod *= sizes.get(a, 1)
        if prod and dim % prod == 0:
            return entry
        logger.warning(
            "sharding: axis %r (mesh extent %d) does not divide dim of "
            "size %d (shape %s) — replicating that dimension instead",
            entry, prod, dim, tuple(shape))
        return None

    return P(*(fix(e, d) for e, d in zip(entries, shape)))


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``); `placements`
    gives the DTensor placements, one per mesh dimension."""

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def placements(self) -> Tuple[Any, ...]:
        names = self.mesh.mesh_dim_names
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(self.spec):
            axes = _axes_of(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {entry!r} names mesh axes out of the "
                    f"mesh's order {names}")
            for i in order:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {names[i]!r} shards two "
                                     f"dimensions in {self.spec}")
                out[i] = Shard(dim)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def named_sharding(mesh: DeviceMesh, logical_axes: Optional[Sequence[str]],
                   rules: Mapping[str, MeshAxis]) -> NamedSharding:
    spec = logical_to_mesh_axes(logical_axes, rules)
    return NamedSharding(mesh, _drop_missing_axes(spec, mesh))


def _is_axes_leaf(x) -> bool:
    return x is None or isinstance(x, tuple)


def _tree_map(fn, axes: Any, *trees: Any) -> Any:
    """``fn(axes_leaf, *leaves)`` over a dict tree of logical-axis leaves
    and matching trees."""
    if _is_axes_leaf(axes):
        return fn(axes, *trees)
    return {k: _tree_map(fn, v, *(t[k] for t in trees))
            for k, v in axes.items()}


def pytree_shardings(params_axes: Any, mesh: DeviceMesh,
                     rules: Mapping[str, MeshAxis],
                     params: Any = None) -> Any:
    """A tree of logical-axis tuples → a tree of `NamedSharding`s.  With
    ``params`` given, each leaf's spec is fitted to its shape: a mesh axis
    that does not divide its dimension replicates it."""
    if params is None:
        return _tree_map(lambda ax: named_sharding(mesh, ax, rules),
                         params_axes)

    def fit(ax, p):
        s = named_sharding(mesh, ax, rules)
        return NamedSharding(mesh, _drop_nondividing_axes(s.spec, mesh,
                                                          p.shape))

    return _tree_map(fit, params_axes, params)


def device_put(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """Place a whole tensor (the same on every rank) as a DTensor
    (``jax.device_put`` with a sharding)."""
    return distribute_tensor(x, sharding.mesh, sharding.placements())


def shard_pytree(params: Any, params_axes: Any, mesh: DeviceMesh,
                 rules: Mapping[str, MeshAxis]) -> Any:
    """Place a tree of whole tensors (the same on every rank) on the mesh as
    DTensors under the rules (shape-aware: a non-dividing assignment
    replicates)."""
    shardings = pytree_shardings(params_axes, mesh, rules, params=params)
    return _tree_map(lambda _, p, s: device_put(p, s), params_axes, params,
                     shardings)


def constrain(x: torch.Tensor, logical_axes: Optional[Sequence[str]],
              rules: Mapping[str, MeshAxis],
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Redistribute a DTensor to the rules' spec for ``logical_axes``
    (``with_sharding_constraint``); a plain tensor, or no mesh, is returned
    as it is."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _drop_missing_axes(logical_to_mesh_axes(logical_axes, rules),
                              mesh)
    spec = _drop_nondividing_axes(spec, mesh, x.shape)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements())


def batch_sharding(mesh: DeviceMesh, rules: Mapping[str, MeshAxis],
                   ndim: int = 2) -> NamedSharding:
    """Sharding for input batches: batch axis sharded, rest replicated."""
    axes = ["batch"] + [None] * (ndim - 1)
    spec = logical_to_mesh_axes(axes, {**rules, None: None})
    return NamedSharding(mesh, _drop_missing_axes(spec, mesh))


# -- compute on placed tensors -------------------------------------------------

def batch_rows(x: torch.Tensor, mesh: DeviceMesh,
               axes: Sequence[str] = ("dp", "fsdp")) -> torch.Tensor:
    """This rank's rows of a whole batch split over ``axes`` (major to
    minor), as `batch_sharding` places it; a DTensor gives its local
    shard."""
    if isinstance(x, DTensor):
        return x.to_local()
    sizes = axis_sizes(mesh)
    index, count = 0, 1
    for a in axes:
        n = sizes.get(a, 1)
        index = index * n + (mesh.get_local_rank(a) if n > 1 else 0)
        count *= n
    if x.shape[0] % count:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"{count} ranks of {tuple(axes)}")
    return x.chunk(count, dim=0)[index] if count > 1 else x


def gather_for_compute(x: torch.Tensor, mesh: DeviceMesh,
                       summed_axes: Sequence[str],
                       keep: Sequence[str] = ()) -> torch.Tensor:
    """The whole of a placed weight, as a plain tensor with autograd: a
    DTensor is gathered, and its gradient comes back in its own placements,
    summed over the mesh axes ``summed_axes`` (those whose ranks compute on
    different data) and taken as it is over the others (whose ranks compute
    the same).  A plain tensor is used as it is, its gradient summed over
    ``summed_axes``.

    A DTensor sharded over a mesh axis of ``keep`` stays sharded over it:
    it is gathered over the other axes and comes back as a DTensor sharded
    over the ``keep`` axes only, whose local block is the part this rank
    computes with (a pipeline stage's slab, `pipeline.pipeline_apply`);
    that block's gradient is this rank's alone."""
    if not isinstance(x, DTensor):
        return pvary(x, summed_axes, mesh)
    names = x.device_mesh.mesh_dim_names
    kept = [p if a in keep else Replicate()
            for a, p in zip(names, x.placements)]
    grads = [p if a in keep else Partial() if a in summed_axes
             else Replicate() for a, p in zip(names, kept)]
    local = x.redistribute(x.device_mesh, kept).to_local(
        grad_placements=grads)
    if all(p.is_replicate() for p in kept):
        return local
    return DTensor.from_local(local, x.device_mesh, kept, run_check=False)
