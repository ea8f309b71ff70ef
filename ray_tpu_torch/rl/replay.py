"""Device-resident replay buffer (counterpart of ``ray_tpu/rl/replay.py``).

The buffer is a fixed-capacity dict of tensors on the card with a circular
write cursor, written in place.  In the JAX package ``cursor`` and ``size``
are device scalars because the buffer rides a ``lax.scan`` carry; here
they are host ints: every insert has a fixed size, so both are known on
the host without reading the device, and what depends on them (the
learn-start gate, the filled region, the n-step window's fallback side)
is decided in Python.  The prioritized variant's ``priority`` array and
running ``max_priority`` stay on the card.

Sampling takes its draws as an argument or from a `torch.Generator`:
uniform sampling the indices (``{"idx": ...}``); prioritized sampling the
indices, the Gumbel noise ``jax.random.categorical`` adds to the logits
(``{"gumbel": [B, capacity]}``, what tests pass to match the JAX package),
or uniforms for an inverse-CDF draw (``{"u": [B]}``, the default: a
cumulative sum of ``priority^alpha`` over the filled region in float64 and
a binary search, no [B, capacity] noise and no read of the device).  The
importance weights keep the JAX package's buffer-wide normalisation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

BufferState = Dict[str, Any]   # {"data": {k: [capacity, ...]}, "cursor",
#                                 "size", "capacity"} (+ "priority",
#                                 "max_priority" when prioritized)
Draw = Optional[Dict[str, torch.Tensor]]


def init(capacity: int, example: Dict[str, torch.Tensor]) -> BufferState:
    """Storage shaped like one transition (``example``: a tensor per key,
    its shape, dtype and device), times capacity, zeroed."""
    data = {k: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device) for k, x in example.items()}
    return {"data": data, "cursor": 0, "size": 0, "capacity": capacity}


def _slots(state: BufferState, n: int):
    """The circular slot ranges the next ``n`` inserts land in, as at most
    two ``(buffer start, buffer end, batch start)`` slices — one definition
    for the uniform and prioritized writers."""
    cap, cur = state["capacity"], state["cursor"]
    if n > cap:
        raise ValueError(f"an insert of {n} rows exceeds the buffer's "
                         f"capacity {cap}")
    first = min(n, cap - cur)
    parts = [(cur, cur + first, 0)]
    if first < n:
        parts.append((0, n - first, first))
    return parts


def add_batch(state: BufferState, batch: Dict[str, torch.Tensor],
              batch_size: int) -> BufferState:
    """Insert ``[batch_size, ...]`` rows at the cursor, wrapping around, in
    place; → the state with cursor and size advanced."""
    for lo, hi, at in _slots(state, batch_size):
        for k, buf in state["data"].items():
            buf[lo:hi] = batch[k][at:at + hi - lo]
    cap = state["capacity"]
    state["cursor"] = (state["cursor"] + batch_size) % cap
    state["size"] = min(state["size"] + batch_size, cap)
    return state


def _gather(state: BufferState, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: buf[idx] for k, buf in state["data"].items()}


def sample(state: BufferState, batch_size: int,
           gen: Optional[torch.Generator] = None, draw: Draw = None
           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """A uniform sample from the filled region; → (batch, idx), the
    indices for n-step lookups and priority updates."""
    if draw is not None:
        idx = draw["idx"]
    else:
        idx = torch.randint(max(state["size"], 1), (batch_size,),
                            generator=gen, device=gen.device)
    return _gather(state, idx), idx


# -- prioritized variant -------------------------------------------------------

def init_prioritized(capacity: int,
                     example: Dict[str, torch.Tensor]) -> BufferState:
    state = init(capacity, example)
    device = next(iter(state["data"].values())).device
    state["priority"] = torch.zeros(capacity, device=device)
    state["max_priority"] = torch.ones((), device=device)
    return state


def add_batch_prioritized(state: BufferState,
                          batch: Dict[str, torch.Tensor],
                          batch_size: int) -> BufferState:
    """Insert at the running max priority (new transitions are sampled
    eagerly until their TD error is known)."""
    for lo, hi, _ in _slots(state, batch_size):
        state["priority"][lo:hi] = state["max_priority"]
    return add_batch(state, batch, batch_size)


def sample_prioritized(state: BufferState, batch_size: int, *,
                       alpha: float = 0.6, beta: float = 0.4,
                       gen: Optional[torch.Generator] = None,
                       draw: Draw = None):
    """Sample ∝ priority^alpha over the filled region; → (batch, idx,
    importance weights).

    Weights are ``(N * P(i))^-beta`` over the buffer-wide max weight, the
    weight of the least likely filled slot (normalising by the batch's max
    would make the step size follow the batch's make-up)."""
    n = max(state["size"], 1)
    pri = state["priority"][:n]
    logits = alpha * torch.log(pri + 1e-6)
    if draw is not None and "idx" in draw:
        idx = draw["idx"]
    elif draw is not None and "gumbel" in draw:
        idx = torch.argmax(draw["gumbel"][:, :n] + logits, dim=-1)
    else:
        u = (draw["u"] if draw is not None
             else torch.rand(batch_size, generator=gen, device=gen.device))
        cdf = torch.cumsum((pri.double() + 1e-6) ** alpha, 0)
        idx = torch.searchsorted(cdf, u.double() * cdf[-1],
                                 right=True).clamp_(max=n - 1)
    probs_all = torch.softmax(logits, dim=0)
    probs = probs_all[idx]
    max_weight = (n * probs_all.min().clamp_min(1e-12)) ** (-beta)
    weights = (n * probs) ** (-beta) / max_weight.clamp_min(1e-12)
    return _gather(state, idx), idx, weights


def update_priorities(state: BufferState, idx: torch.Tensor,
                      td_abs: torch.Tensor, eps: float = 1e-3
                      ) -> BufferState:
    """Priorities ``|td| + eps`` at the sampled slots, and the running max,
    in place.  A slot sampled twice gets the same value twice (the same
    transition gives the same TD error), so the write order is moot."""
    new_p = td_abs + eps
    state["priority"].index_put_((idx,), new_p)
    torch.maximum(state["max_priority"], new_p.max(),
                  out=state["max_priority"])
    return state


def nstep_window(state: BufferState, idx: torch.Tensor, n: int,
                 gamma: float, stride: int = 1, one_step=None):
    """n-step lookahead from sampled slots.

    Writes are sequential, so the transition after slot ``s`` is at ``s +
    stride`` (``stride`` = the insert size: a vectorized collect writes one
    slot per env a step).  Windows that would cross the write cursor into
    older data, or into unwritten slots while filling, fall back to their
    1-step values; an episode end inside the window stops the sum, and the
    target bootstraps from the last live step's ``next_obs``.

    → (reward_n [B], bootstrap_obs [B, ...], done_n [B], gamma_n [B]):
    ``target = reward_n + gamma_n * (1 - done_n) * maxQ(bootstrap_obs)``."""
    data, cap = state["data"], state["capacity"]
    ar = torch.arange(n, device=idx.device)
    widx = (idx[:, None] + ar * stride) % cap                 # [B, n]
    rewards = data["reward"][widx]
    dones = data["done"][widx]
    # alive[k] = 1 while no done at steps < k (the done step itself still
    # contributes its reward)
    alive = torch.cumprod(torch.cat([torch.ones_like(dones[:, :1]),
                                     1.0 - dones[:, :-1]], dim=1), dim=1)
    discount = gamma ** ar
    reward_n = (rewards * alive * discount).sum(dim=1)
    steps = alive.sum(dim=1)                                  # [B] in [1, n]
    done_n = (dones * alive).sum(dim=1)
    gamma_n = gamma ** steps
    last = torch.clamp(steps - 1, 0, n - 1).to(idx.dtype)
    next_obs = data["next_obs"][(idx + last * stride) % cap]
    span = (n - 1) * stride
    if state["size"] < cap:
        window_ok = state["size"] - idx - 1 >= span
    else:
        window_ok = (state["cursor"] - idx - 1) % cap >= span
    os_ = one_step or {k: data[k][idx] for k in ("reward", "done",
                                                  "next_obs")}
    reward_n = torch.where(window_ok, reward_n, os_["reward"])
    done_n = torch.where(window_ok, done_n, os_["done"])
    gamma_n = torch.where(window_ok, gamma_n, torch.full_like(gamma_n,
                                                              gamma))
    mask = window_ok.view((-1,) + (1,) * (next_obs.dim() - 1))
    next_obs = torch.where(mask, next_obs, os_["next_obs"])
    return reward_n, next_obs, done_n, gamma_n


def make_ops(prioritized: bool, *, alpha: float = 0.6, beta: float = 0.4):
    """One (init, add, sample, update_priorities) tuple for both modes, so
    the algorithms carry no per-mode branch: the uniform sample returns
    unit weights and its priority update is the identity.
    ``sample(state, batch_size, gen=None, draw=None, beta_now=None) ->
    (batch, idx, weights)``; ``beta_now`` anneals the importance exponent
    (the PER schedule)."""
    if prioritized:
        def sample_fn(state, batch_size, gen=None, draw=None,
                      beta_now=None):
            return sample_prioritized(
                state, batch_size, alpha=alpha,
                beta=beta if beta_now is None else beta_now, gen=gen,
                draw=draw)
        return (init_prioritized, add_batch_prioritized, sample_fn,
                update_priorities)

    def uniform_fn(state, batch_size, gen=None, draw=None, beta_now=None):
        batch, idx = sample(state, batch_size, gen, draw)
        return batch, idx, torch.ones(batch_size, device=idx.device)

    def identity(state, idx, td_abs, eps=1e-3):
        return state

    return init, add_batch, uniform_fn, identity
