"""Connectors: composable obs / action / reward transforms (counterpart of
``ray_tpu/rl/connectors.py``).

A connector is a pure function pair: ``init_state(device)`` builds its
state, ``__call__(state, x) -> (state, x)`` transforms one stream as the
JAX package's connector does.  The rollout runs every env at once:
``batched(states, xs)`` is the JAX package's ``jax.vmap`` of the call,
each env's state a row of a leading ``[num_envs]`` axis, so the pipeline's
``vmapped`` is the batched call itself.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .policy import tree_map

State = Any


class Connector:
    """One transform.  Stateless connectors return () from init_state.

    ``kind`` says what the transform applies to ("obs", "action" or
    "reward"), so configs can validate placement.  ``reset_on_done`` marks
    state that clears at episode boundaries (FrameStack's ring) rather than
    persisting across them (ObsNormalizer's moments)."""

    kind = "obs"
    reset_on_done = False

    def init_state(self, device: DeviceLike = None) -> State:
        return ()

    def __call__(self, state: State, x: torch.Tensor
                 ) -> Tuple[State, torch.Tensor]:
        raise NotImplementedError

    def batched(self, states: State, xs: torch.Tensor
                ) -> Tuple[State, torch.Tensor]:
        """The call over every env, row by row (stateless connectors are
        elementwise, so the call itself)."""
        return self(states, xs)

    def out_size(self, in_size: int) -> int:
        """Observation size after this transform (for model building)."""
        return in_size


class ObsNormalizer(Connector):
    """Running mean / std normalization with Welford moments, updated by
    the JAX package's formula."""

    def __init__(self, size: int, clip: float = 10.0,
                 epsilon: float = 1e-8):
        self.size = size
        self.clip = clip
        self.epsilon = epsilon

    def init_state(self, device: DeviceLike = None) -> State:
        device = resolve_device(device)
        return {"mean": torch.zeros(self.size, device=device),
                "m2": torch.ones(self.size, device=device),
                "count": torch.ones((), device=device)}

    def _apply(self, state, batch):
        """``batch [..., n, size]`` against moments ``[..., size]`` (count
        ``[...]``): one Welford update per leading index."""
        n = batch.shape[-2]
        b_mean = batch.mean(dim=-2)
        b_var = batch.var(dim=-2, correction=0)
        old = state["count"][..., None]
        count = old + n
        delta = b_mean - state["mean"]
        mean = state["mean"] + delta * n / count
        m2 = state["m2"] + b_var * n + delta ** 2 * old * n / count
        new = {"mean": mean, "m2": m2, "count": count[..., 0]}
        std = torch.sqrt(m2 / count + self.epsilon)
        out = ((batch - mean[..., None, :]) / std[..., None, :]).clamp(
            -self.clip, self.clip)
        return new, out

    def __call__(self, state, x):
        new, out = self._apply(state, x.reshape(-1, self.size))
        return new, out.reshape(x.shape)

    def batched(self, states, xs):
        new, out = self._apply(states, xs.reshape(xs.shape[0], -1,
                                                  self.size))
        return new, out.reshape(xs.shape)


class FrameStack(Connector):
    """Stack the last k observations; the ring lives in the state."""

    reset_on_done = True   # a fresh episode must not see dead frames

    def __init__(self, size: int, k: int = 4):
        self.size = size
        self.k = k

    def init_state(self, device: DeviceLike = None) -> State:
        return torch.zeros(self.k, self.size, device=resolve_device(device))

    def __call__(self, state, x):
        new = torch.cat([state[1:], x[None, :]], dim=0)
        return new, new.reshape(-1)

    def batched(self, states, xs):
        new = torch.cat([states[:, 1:], xs[:, None, :]], dim=1)
        return new, new.reshape(xs.shape[0], -1)

    def out_size(self, in_size: int) -> int:
        return in_size * self.k


class ClipReward(Connector):
    """Reward clipping."""

    kind = "reward"

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, state, x):
        return state, x.clamp(self.low, self.high)


class ClipActions(Connector):
    """Clip continuous actions into the env bound."""

    kind = "action"

    def __init__(self, high: float = 1.0):
        self.high = high

    def __call__(self, state, x):
        return state, x.clamp(-self.high, self.high)


class UnsquashActions(Connector):
    """Map tanh-squashed [-1, 1] policy outputs onto the env's action
    interval."""

    kind = "action"

    def __init__(self, high: float = 1.0):
        self.high = high

    def __call__(self, state, x):
        return state, torch.tanh(x) * self.high


class ConnectorPipeline:
    """Ordered composition; the state is the tuple of member states."""

    def __init__(self, connectors: Sequence[Connector]):
        self.connectors = list(connectors)

    def init_state(self, device: DeviceLike = None) -> Tuple:
        return tuple(c.init_state(device) for c in self.connectors)

    def __call__(self, state: Tuple, x: torch.Tensor
                 ) -> Tuple[Tuple, torch.Tensor]:
        new_states: List[State] = []
        for c, s in zip(self.connectors, state):
            s, x = c(s, x)
            new_states.append(s)
        return tuple(new_states), x

    def batched(self, states: Tuple, xs: torch.Tensor
                ) -> Tuple[Tuple, torch.Tensor]:
        """The pipeline over every env (the JAX package's ``jax.vmap`` of
        the call); states from `init_state_batch`."""
        new_states: List[State] = []
        for c, s in zip(self.connectors, states):
            s, xs = c.batched(s, xs)
            new_states.append(s)
        return tuple(new_states), xs

    def out_size(self, in_size: int) -> int:
        for c in self.connectors:
            in_size = c.out_size(in_size)
        return in_size

    def validate_kind(self, kind: str, where: str) -> "ConnectorPipeline":
        bad = [type(c).__name__ for c in self.connectors
               if c.kind != kind]
        if bad:
            raise ValueError(
                f"{where} accepts only {kind!r} connectors; {bad} "
                f"belong in the "
                f"{'action_connectors' if kind == 'obs' else 'connectors'}"
                " list")
        return self

    def reset_where(self, state: Tuple, done: torch.Tensor) -> Tuple:
        """Reset per-env state rows where ``done``, only for members with
        ``reset_on_done`` (FrameStack rings clear at episode boundaries;
        ObsNormalizer moments persist)."""
        out = []
        for c, s in zip(self.connectors, state):
            if not c.reset_on_done:
                out.append(s)
                continue
            init = c.init_state(done.device)

            def mask(leaf, init_leaf):
                d = done.reshape((-1,) + (1,) * (leaf.dim() - 1))
                return torch.where(d.bool(), init_leaf, leaf)

            out.append(mask(s, init) if torch.is_tensor(s) else
                       {k: mask(s[k], init[k]) for k in s})
        return tuple(out)

    def vmapped(self, num_envs: int):
        """(states, batch_x) -> (states, batch_y) over every env: the
        batched call (the port steps every env at once already)."""
        return self.batched

    def init_state_batch(self, num_envs: int,
                         device: DeviceLike = None) -> Tuple:
        return tree_map(
            lambda s: s.expand((num_envs,) + s.shape).clone(),
            self.init_state(device))
