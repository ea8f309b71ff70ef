"""Shared off-policy learner scaffolding (counterpart of
``ray_tpu/rl/learner.py``): gradients of a loss over a params tree, Polyak
averaging, and the sample → TD gradient → optimizer step → Polyak loop
behind a learn-start gate.

The JAX package compiles the gate as a ``lax.cond`` over a ``lax.scan``;
here the buffer's size is a host int (`replay`), so the gate is a Python
``if`` and the updates a loop, with no read of the device."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .policy import tree_leaves


def value_and_grad(loss_fn: Callable, params, *args):
    """``loss_fn(params, *args) -> (loss, aux)`` → (loss, aux, grads in
    `tree_leaves` order of ``params``), everything detached.  A leaf the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    detach = (lambda x: x.detach() if torch.is_tensor(x) else x)
    aux = ({k: detach(v) for k, v in aux.items()} if isinstance(aux, dict)
           else detach(aux))
    return loss.detach(), aux, grads


@torch.no_grad()
def polyak(targets, params, tau: float) -> None:
    """``targets = (1 - tau) * targets + tau * params``, in place."""
    t = tree_leaves(targets)
    torch._foreach_mul_(t, 1 - tau)
    torch._foreach_add_(t, tree_leaves(params), alpha=tau)


def make_update_gate(optimizer, *, tau: float, learn_start: int,
                     num_updates: int, sample_fn: Callable,
                     loss_fn: Callable):
    """→ ``gate(params, target_params, opt_state, buffer, draws=None)``
    running ``num_updates`` TD steps behind the learn-start gate (nothing
    at all until the buffer holds ``learn_start`` rows), Polyak-averaging
    the target after every step; params, targets and optimizer state are
    updated in place.

    ``sample_fn(buffer, draw) -> (batch, idx)`` (``draw`` is
    ``draws[k]`` for the k-th step, or None); ``loss_fn(params,
    target_params, batch) -> scalar loss``.  → the last step's loss, or 0
    below the gate."""

    def gate(params, target_params, opt_state, buffer,
             draws: Optional[Sequence] = None) -> torch.Tensor:
        if buffer["size"] < learn_start:
            return torch.zeros((), device=tree_leaves(params)[0].device)
        loss = None
        for k in range(num_updates):
            batch, _ = sample_fn(buffer, None if draws is None else draws[k])
            loss, _, grads = value_and_grad(
                lambda p, b: (loss_fn(p, target_params, b), None),
                params, batch)
            optimizer.update(grads, opt_state, params)
            polyak(target_params, params, tau)
        return loss

    return gate
