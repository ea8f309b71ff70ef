"""Mixture-of-experts FFN with top-k routing and capacity-based dispatch
(counterpart of ``ray_tpu/ops/moe.py``).

The GShard/Switch einsum formulation, as in the JAX package: router logits
→ top-k gates per token; a dense one-hot *dispatch* tensor
[batch, seq, experts, capacity] gathers tokens into per-expert buffers;
the expert FFNs run batched over a leading ``expert`` axis; a gate-weighted
*combine* tensor of the same shape merges their outputs back into token
order.  Tokens beyond an expert's capacity are dropped: their combine
weight is zero, and the residual connection carries them through.

Capacity is per batch row: the running count of each expert's load runs
over one row's ``s·k`` choices, so rows (the serve engine's slots) never
compete for an expert.  Every shape depends only on the input's shape, and
no step reads a value back to the host, so the engine's decode step stays
one CUDA graph with experts.

Where a plain PyTorch translation would part from the JAX function:

* ``jax.nn.one_hot`` gives a zero row for an index out of range (a token
  past its expert's capacity); `torch.nn.functional.one_hot` raises there,
  and without ``num_classes`` reads the maximum back to the host.  Every
  one-hot here is a comparison with an ``arange``.
* ``jax.lax.top_k`` breaks ties toward the lower index; `torch.topk`
  promises no order.  The top k come from a stable descending sort.

``constrain(x, logical_axes)``, as in the JAX package, is an optional
hook applied to the two expert-major intermediates with ("expert",
"batch", None, None) (`parallel.constrain` redistributes a DTensor there).
``batch_mean`` is the port's own: how the router statistics of the aux
loss are averaged over the batch and the sequence.  By default it is the
local mean; a data-parallel caller passes one that averages over every
rank's rows, so the aux loss is the global batch's, as JAX computes it on
the whole array.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def expert_capacity(seq_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert buffer size: ``ceil(tokens * k / E * factor)`` rounded up
    to a multiple of 8, at least 8, as in the JAX package."""
    cap = math.ceil(seq_tokens * top_k * capacity_factor / n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row, as ``jax.nn.one_hot``."""
    classes = torch.arange(n, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == classes).float()


def _top_k(gates: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, ties to the lower index."""
    values, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gates(y: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(softmax gates [b,s,E], top-k gates renormalised [b,s,k], their
    experts [b,s,k]), all routing in fp32."""
    logits = torch.einsum("bsd,de->bse", y.float(), router_w.float())
    gates = torch.softmax(logits, dim=-1)
    gate_k, idx_k = _top_k(gates, top_k)
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, gate_k, idx_k


def _local_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(0, 1))


def route(y: torch.Tensor, router_w: torch.Tensor, top_k: int,
          capacity: int, batch_mean: Optional[Callable] = None):
    """Dispatch and combine tensors.

    y [b, s, d] activations; router_w [d, E].  → (dispatch [b,s,E,C] 0/1
    in y's dtype, combine [b,s,E,C] fp32, aux loss: the Switch
    load-balancing loss, an fp32 scalar).  ``batch_mean`` averages a
    [b, s, E] statistic over the batch and sequence (None: the local
    mean)."""
    b, s, _ = y.shape
    n_experts = router_w.shape[-1]
    gates, gate_k, idx_k = _gates(y, router_w, top_k)
    onehot = _one_hot(idx_k, n_experts)                         # [b,s,k,E]
    # position of each (token, choice) in its expert's buffer: the running
    # count over the row's s·k choices in order
    flat = onehot.reshape(b, s * top_k, n_experts)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, top_k, n_experts)
    within = (pos < capacity).float() * onehot                 # [b,s,k,E]
    pos_oh = _one_hot(pos.long(), capacity)                    # [b,s,k,E,C]
    combine = torch.einsum("bsk,bske,bskec->bsec", gate_k, within, pos_oh)
    dispatch = (combine > 0.0).to(y.dtype)
    # E * sum_e f_e * p_e: f_e the share of tokens whose first choice is e,
    # p_e the mean gate of e
    top1 = _one_hot(idx_k[..., 0], n_experts)
    mean = batch_mean or _local_mean
    aux = n_experts * torch.mean(mean(top1) * mean(gates))
    return dispatch, combine, aux


def moe_ffn(y: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, w_gate: Optional[torch.Tensor] = None, *,
            top_k: int = 2, capacity_factor: float = 2.0,
            constrain: Optional[Callable] = None,
            batch_mean: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward block.

    y [b,s,d]; router_w [d,E]; w_in [E,d,f]; w_out [E,f,d]; w_gate [E,d,f]
    selects SwiGLU (None → GELU, the tanh approximation as
    ``jax.nn.gelu``).  The products run in y's dtype.  → (out [b,s,d],
    aux loss)."""
    s = y.shape[1]
    n_experts = w_in.shape[0]
    dt = y.dtype
    cap = expert_capacity(s, n_experts, top_k, capacity_factor)
    dispatch, combine, aux = route(y, router_w, top_k, cap, batch_mean)
    # token-major → expert-major [E, b, C, d]
    xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), y)
    if constrain is not None:
        xe = constrain(xe, ("expert", "batch", None, None))
    up = torch.einsum("ebcd,edf->ebcf", xe, w_in.to(dt))
    if w_gate is not None:
        gate = torch.einsum("ebcd,edf->ebcf", xe, w_gate.to(dt))
        z = F.silu(gate) * up
    else:
        z = F.gelu(up, approximate="tanh")
    oe = torch.einsum("ebcf,efd->ebcd", z, w_out.to(dt))
    if constrain is not None:
        oe = constrain(oe, ("expert", "batch", None, None))
    out = torch.einsum("ebcd,bsec->bsd", oe, combine.to(dt))
    return out, aux


def moe_ffn_reference(y: torch.Tensor, router_w: torch.Tensor,
                      w_in: torch.Tensor, w_out: torch.Tensor,
                      w_gate: Optional[torch.Tensor] = None, *,
                      top_k: int = 2) -> torch.Tensor:
    """Every token through its top-k experts exactly, no capacity limit,
    in fp32: the oracle the dispatch path must agree with when capacity is
    ample (``capacity_factor = E / k``)."""
    n_experts = w_in.shape[0]
    _, gate_k, idx_k = _gates(y, router_w, top_k)
    yf = y.float()
    up = torch.einsum("bsd,edf->bsef", yf, w_in.float())
    if w_gate is not None:
        g = torch.einsum("bsd,edf->bsef", yf, w_gate.float())
        z = F.silu(g) * up
    else:
        z = F.gelu(up, approximate="tanh")
    all_out = torch.einsum("bsef,efd->bsed", z, w_out.float())   # [b,s,E,d]
    weight = torch.einsum("bsk,bske->bse", gate_k,
                          _one_hot(idx_k, n_experts))
    return torch.einsum("bsed,bse->bsd", all_out, weight).to(y.dtype)
