"""Sequence-parallel attention: ring (ppermute) and Ulysses (all_to_all)
(counterpart of ``ray_tpu/ops/ring_attention.py``).

  * **Ring attention** — each rank holds a block of the sequence; K/V blocks
    rotate around the ``sp`` ring (`ppermute`) while each rank accumulates
    blockwise online-softmax statistics (fp32) for its own queries.
    Causality comes from masks by the relation between ranks; a step whose
    keys all lie after the rank's queries leaves the statistics as they
    were.  Dense products, as in the JAX package: not the flash kernels.
  * **Ulysses** — `all_to_all` from sequence-sharded to head-sharded, the
    local `multi_head_attention` over the whole sequence (the Hopper flash
    kernels on the card), and `all_to_all` back.  Needs heads % sp == 0.

The ``*_shard`` functions take each rank's LOCAL blocks [batch, seq/n,
heads, head_dim] and run the collectives over ``axis_name`` of the mesh
(default: the ambient one).  `make_ring_attention` /
`make_ulysses_attention` wrap them for whole tensors: each rank takes its
block, and the output is gathered back whole on every rank.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel import collectives
from ..parallel.collectives import (all_gather_invariant, all_to_all,
                                    axis_index, ppermute, shard)
from ..parallel.mesh import current_mesh

_NEG = -1e30


def _online_block(q, k, v, mask, sm_scale, m, l, acc):
    """One blockwise online-softmax accumulation step (fp32 statistics).
    q:[B,Sq,H,D] k/v:[B,Sk,H,D] mask broadcastable to [B,H,Sq,Sk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m_new, l_new, acc * alpha + pv


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, axis_name: str = "sp", axis_size: int,
                         causal: bool = True,
                         sm_scale: Optional[float] = None,
                         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Ring attention over each rank's LOCAL blocks [B, S/n, H, D]; KV
    heads may divide the query heads."""
    from .attention import repeat_kv
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    b, s_loc, h, d = q.shape
    my = axis_index(axis_name, mesh) if axis_size > 1 else 0
    dev = q.device
    rows = torch.arange(s_loc, device=dev)[:, None]
    diag = rows >= torch.arange(s_loc, device=dev)[None, :]

    m = torch.full((b, h, s_loc, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=dev)
    perm = [(j, (j + 1) % axis_size) for j in range(axis_size)]
    k_cur, v_cur = k, v
    for i in range(axis_size):
        src = (my - i) % axis_size                # owner rank of k_cur
        if not causal or src < my:
            mask = torch.ones_like(diag)
        elif src == my:
            mask = diag
        else:
            mask = torch.zeros_like(diag)
        m2, l2, acc2 = _online_block(q, k_cur, v_cur, mask, sm_scale,
                                     m, l, acc)
        if causal and src > my:
            # every key after every query: the statistics stay.  The block
            # still runs, so each rank's autograd graph has the same shape
            # and the backward's permutations meet
            skip = torch.tensor(True, device=dev)
            m2 = torch.where(skip, m, m2)
            l2 = torch.where(skip, l, l2)
            acc2 = torch.where(skip, acc, acc2)
        m, l, acc = m2, l2, acc2
        if i < axis_size - 1:                     # the last rotation is idle
            k_cur = ppermute(k_cur, axis_name, perm, mesh)
            v_cur = ppermute(v_cur, axis_name, perm, mesh)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ulysses_attention_shard(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, axis_name: str = "sp",
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            inner_impl: str = "auto",
                            mesh: Optional[DeviceMesh] = None
                            ) -> torch.Tensor:
    """Ulysses: seq-sharded [B, S/n, H, D] → head-sharded whole-sequence
    attention → seq-sharded output.  Requires H % n == 0."""
    from .attention import multi_head_attention

    def a2a(x, split, concat):
        return all_to_all(x, axis_name, split, concat, mesh)

    q_h, k_h, v_h = a2a(q, 2, 1), a2a(k, 2, 1), a2a(v, 2, 1)
    out = multi_head_attention(q_h, k_h, v_h, causal=causal,
                               sm_scale=sm_scale, impl=inner_impl)
    return a2a(out, 1, 2)


# -- whole-tensor wrappers -----------------------------------------------------

def _whole(shard_fn, mesh: DeviceMesh, axis_name: str):
    def fn(q, k, v):
        blocks = [shard(x, axis_name, 1, mesh) for x in (q, k, v)]
        return all_gather_invariant(shard_fn(*blocks), axis_name, 1, mesh)
    return fn


def make_ring_attention(mesh: DeviceMesh, axis_name: str = "sp",
                        causal: bool = True):
    """(q, k, v) → out on whole tensors [B, S, H, D], the same on every
    rank; each rank attends for its block of S."""
    return _whole(functools.partial(
        ring_attention_shard, axis_name=axis_name,
        axis_size=collectives.axis_size(axis_name, mesh), causal=causal,
        mesh=mesh), mesh, axis_name)


def make_ulysses_attention(mesh: DeviceMesh, axis_name: str = "sp",
                           inner_impl: str = "auto", causal: bool = True):
    return _whole(functools.partial(
        ulysses_attention_shard, axis_name=axis_name, causal=causal,
        inner_impl=inner_impl, mesh=mesh), mesh, axis_name)


def ring_attention(q, k, v, *, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   axis_name: str = "sp", axis_size: Optional[int] = None,
                   mesh: Optional[DeviceMesh] = None):
    """Shard-level entry of the model's attention dispatch: LOCAL blocks
    over ``axis_name`` of ``mesh`` (default: the ambient mesh), whose size
    ``axis_size`` defaults to."""
    if axis_size is None:
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is None:
            raise ValueError(
                "ring attention needs a mesh or a static axis_size; enter "
                "use_mesh(mesh) or call through make_ring_attention(mesh)")
        axis_size = collectives.axis_size(axis_name, mesh)
    return ring_attention_shard(q, k, v, axis_name=axis_name,
                                axis_size=axis_size, causal=causal,
                                sm_scale=sm_scale, mesh=mesh)
