"""Attention dispatch (counterpart of ``ray_tpu/ops/attention.py``).

All shapes are ``[batch, seq, heads, head_dim]`` with KV heads a divisor of
the query heads (GQA).  `multi_head_attention` picks the implementation:

  * ``"flash"``     — `flash_attention` (the Hopper kernel on CUDA tensors)
  * ``"reference"`` — plain softmax(QKᵀ)V in fp32
  * ``"ring"``      — sequence-parallel ring attention
    (`ray_tpu_torch.ops.ring_attention`) over the ``sp`` axis of ``mesh``
    (default: the ambient mesh), on each rank's LOCAL blocks of the
    sequence; reference attention where the mesh has no ``sp`` axis wider
    than 1
  * ``"auto"``      — flash for a CUDA tensor whose head_dim and dtype the
    kernel takes, reference otherwise (CPU tensors: what JAX itself runs on
    the CPU)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .flash_attention import DTYPES, HEAD_DIMS, flash_attention


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand [b, s, h_kv, d] → [b, s, h_kv*n_rep, d]."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(QKᵀ)V with fp32 statistics and a bottom-right aligned causal
    mask, applied as an additive -1e30 bias (so a row that sees no key
    averages V uniformly, as the JAX reference does)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        rows = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        mask = rows >= torch.arange(s_k, device=q.device)[None, :]
        s = s + (1.0 - mask.float()) * -1e30
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _flash_ok(q: torch.Tensor) -> bool:
    return (q.is_cuda and q.shape[-1] in HEAD_DIMS and q.dtype in DTYPES)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         sm_scale: Optional[float] = None,
                         impl: str = "auto",
                         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    if impl == "auto":
        impl = "flash" if _flash_ok(q) else "reference"
    if impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, sm_scale=sm_scale)
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "ring":
        from ..parallel.mesh import axis_size, current_mesh
        from .ring_attention import ring_attention_shard
        mesh = mesh if mesh is not None else current_mesh()
        sp = axis_size("sp", mesh)
        if sp <= 1:
            return reference_attention(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
        return ring_attention_shard(q, k, v, axis_name="sp", axis_size=sp,
                                    causal=causal, sm_scale=sm_scale,
                                    mesh=mesh)
    raise ValueError(f"unknown attention impl {impl!r}")
