"""GPipe-style pipeline parallelism over the mesh's ``pp`` axis
(counterpart of ``ray_tpu/parallel/pipeline.py``).

The model's layers are one stacked tree (leading "layers" axis); stage s
runs the slab of layers ``[s·L/n, (s+1)·L/n)``.  A stacked weight placed
on pp (``layers="pp"``) is a DTensor whose local block is that slab, so
each stage holds only its own layers, as under JAX's ``P("pp")`` in_specs;
a whole stack (the same on every stage) is sliced.  Each pp rank runs the
JAX package's schedule as a loop of ``n_micro + n_stages - 1`` ticks: stage
0 takes in microbatch t while there is one, every stage applies its slab,
the last stage writes its output for microbatch ``t - (n_stages - 1)``, and
the state moves one stage on by `ppermute`.  The outputs, non-zero only on
the last stage, are summed over pp so every stage returns them.

The microbatch state is a tuple of tensors (activations and, e.g., a MoE
aux-loss scalar), each with a leading ``n_micro`` axis.  Gradients follow
JAX's rules (`parallel.collectives`): the inputs are the same on every
stage and their gradients are summed over pp (a whole stack's too), a
placed slab's gradient stays on its stage, and the output's gradient
reaches the last stage once.  Every stage builds the same autograd graph (stage
choices are `torch.where`, not Python branches), so the backward's
permutations meet on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .collectives import axis_index, ppermute, psum, pvary
from .mesh import current_mesh

State = Tuple[torch.Tensor, ...]


def _select(pred: bool, a: State, b: State) -> State:
    cond = torch.tensor(pred, device=a[0].device)
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def pipeline_apply(stage_fn: Callable[[Dict[str, torch.Tensor], State],
                                      State],
                   stacked_params: Dict[str, torch.Tensor], x_mb: State, *,
                   n_stages: int, n_micro: int,
                   mesh: Optional[DeviceMesh] = None,
                   axis: str = "pp") -> State:
    """Run microbatches through a pipelined stack of layers.

    ``stage_fn(slab, state)`` applies one stage's layers to one
    microbatch's state.  Each leaf of ``stacked_params`` is the whole
    stack (a plain tensor, the same on every stage: each stage takes its
    slab) or a DTensor sharded on its leading dim over ``axis`` and
    replicated over the mesh's other axes, whose local block is the slab
    (`sharding.gather_for_compute` with ``keep=("pp",)``).  Every tensor of
    ``x_mb`` has leading dim ``n_micro``.  → the output microbatch state,
    the same on every stage."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("pipeline_apply needs a mesh with a pp axis: pass "
                         "one or enter use_mesh(mesh)")
    stage = axis_index(axis, mesh)
    last = n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    x_mb = tuple(pvary(x, axis, mesh) for x in x_mb)
    slab = {name: _slab(name, w, stage, n_stages, mesh, axis)
            for name, w in stacked_params.items()}

    state = tuple(torch.zeros_like(x[0]) for x in x_mb)
    outputs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        inject = tuple(x[min(t, n_micro - 1)] for x in x_mb)
        h = _select(stage == 0, inject, state)
        y = tuple(stage_fn(slab, h))
        out_t = t - last
        if out_t >= 0:
            zero = tuple(torch.zeros_like(v) for v in y)
            outputs[out_t] = _select(stage == last, y, zero)
        if t < n_micro + n_stages - 2:     # the last tick's state is unused
            state = tuple(ppermute(v, axis, perm, mesh) for v in y)
    stacked = tuple(torch.stack(parts) for parts in zip(*outputs))
    # the outputs are non-zero on the last stage only: the sum broadcasts
    return tuple(psum(v, axis, mesh) for v in stacked)


def _slab(name: str, w: torch.Tensor, stage: int, n_stages: int,
          mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This stage's layers of one stacked weight."""
    if w.shape[0] % n_stages:
        raise ValueError(f"{name}: {w.shape[0]} layers not divisible "
                         f"by {n_stages} stages")
    if isinstance(w, DTensor):
        want = tuple(Shard(0) if a == axis else Replicate()
                     for a in w.device_mesh.mesh_dim_names)
        if tuple(w.placements) != want:
            raise ValueError(f"{name}: a placed stack must be sharded on "
                             f"its layers over {axis!r} and replicated "
                             f"elsewhere, not {w.placements}")
        return w.to_local()
    per = w.shape[0] // n_stages
    return pvary(w, axis, mesh)[stage * per:(stage + 1) * per]


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[b, ...] → [n_micro, b/n_micro, ...]."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `microbatch`."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


