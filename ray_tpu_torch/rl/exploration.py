"""Exploration strategies (counterpart of ``ray_tpu/rl/exploration.py``).

Each strategy maps ``(state, x, timestep)`` to ``(state, action)`` over a
batch, as the JAX package's does.  The JAX package passes a key; here the
draws come in as an argument (``draws``, the values the JAX package would
draw from its key) or from a `torch.Generator` (`draw`), so tests can give
both packages the same ones.  Schedules are closed-form in the timestep,
which the algorithms keep on the host: they are computed once an
iteration, in float32 as the JAX package computes them, and never read the
device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

State = Any
Draws = Dict[str, torch.Tensor]


def anneal(timestep, start: float, end: float, decay_steps: int) -> float:
    """``start + clip(t / decay_steps, 0, 1) * (end - start)`` in float32,
    the JAX package's arithmetic for a float32 timestep."""
    f32 = np.float32
    frac = np.clip(f32(timestep) / f32(decay_steps), f32(0), f32(1))
    return float(f32(start) + frac * f32(end - start))


class EpsilonGreedy:
    """Annealed epsilon-greedy over Q-values: the greedy action (the first
    of tied maxima) unless a uniform draw falls under epsilon, then a
    uniform random action."""

    def __init__(self, eps_start: float = 1.0, eps_end: float = 0.05,
                 decay_steps: int = 20_000):
        self.eps_start = eps_start
        self.eps_end = eps_end
        self.decay_steps = decay_steps

    def epsilon(self, timestep) -> float:
        return anneal(timestep, self.eps_start, self.eps_end,
                      self.decay_steps)

    def init_state(self) -> State:
        return ()

    def draw(self, qvals: torch.Tensor, gen: torch.Generator) -> Draws:
        """``{"uniform": [B], "random": [B] ints in [0, actions)}``."""
        shape = qvals.shape[:-1]
        return {"uniform": torch.rand(shape, generator=gen,
                                      device=gen.device),
                "random": torch.randint(qvals.shape[-1], shape,
                                        generator=gen, device=gen.device)}

    def __call__(self, state: State, qvals: torch.Tensor, timestep,
                 draws: Optional[Draws] = None,
                 gen: Optional[torch.Generator] = None
                 ) -> Tuple[State, torch.Tensor]:
        """qvals [..., actions] → (state, action [...])."""
        if draws is None:
            draws = self.draw(qvals, gen)
        greedy = torch.argmax(qvals, dim=-1)
        explore = draws["uniform"] < self.epsilon(timestep)
        return state, torch.where(explore, draws["random"].to(greedy.dtype),
                                  greedy)


class GaussianActionNoise:
    """Additive annealed Gaussian noise on continuous actions, clipped to
    ±clip."""

    def __init__(self, scale_start: float = 0.3, scale_end: float = 0.05,
                 decay_steps: int = 20_000, clip: float = 1.0):
        self.scale_start = scale_start
        self.scale_end = scale_end
        self.decay_steps = decay_steps
        self.clip = clip

    def scale(self, timestep) -> float:
        return anneal(timestep, self.scale_start, self.scale_end,
                      self.decay_steps)

    def init_state(self) -> State:
        return ()

    def draw(self, action: torch.Tensor, gen: torch.Generator) -> Draws:
        """``{"normal": standard normal, action's shape}``."""
        return {"normal": torch.randn(action.shape, generator=gen,
                                      device=gen.device)}

    def __call__(self, state, action, timestep, draws=None, gen=None):
        if draws is None:
            draws = self.draw(action, gen)
        noise = draws["normal"] * self.scale(timestep)
        return state, torch.clamp(action + noise, -self.clip, self.clip)


class OrnsteinUhlenbeckNoise:
    """Temporally correlated OU noise for continuous control; the process
    state is carried by the caller.  ``init_state`` is one process of
    ``(action_size,)``, as the JAX package's; a batched caller (TD3 / DDPG)
    carries one per env, ``[num_envs, action_size]``, and each step draws
    a normal of the state's shape."""

    def __init__(self, action_size: int, theta: float = 0.15,
                 sigma: float = 0.2, dt: float = 1e-2, clip: float = 1.0):
        self.action_size = action_size
        self.theta = theta
        self.sigma = sigma
        self.dt = dt
        self.clip = clip

    def init_state(self) -> State:
        return torch.zeros(self.action_size)

    def draw(self, state: torch.Tensor, gen: torch.Generator) -> Draws:
        return {"normal": torch.randn(state.shape, generator=gen,
                                      device=gen.device)}

    def __call__(self, state, action, timestep, draws=None, gen=None):
        if draws is None:
            draws = self.draw(state, gen)
        noise = state + self.theta * (-state) * self.dt + \
            self.sigma * math.sqrt(self.dt) * draws["normal"]
        return noise, torch.clamp(action + noise, -self.clip, self.clip)


class StochasticSampling:
    """Sample from the policy's distribution: ``discrete=True`` takes
    logits and returns a categorical sample (argmax of logits + Gumbel
    noise, what ``jax.random.categorical`` computes); ``discrete=False``
    passes an already-sampled continuous action through.  The space is
    declared, not guessed from the dtype."""

    def __init__(self, discrete: bool = True):
        self.discrete = discrete

    def init_state(self) -> State:
        return ()

    def draw(self, logits: torch.Tensor, gen: torch.Generator) -> Draws:
        tiny = torch.finfo(logits.dtype).tiny
        u = torch.rand(logits.shape, generator=gen, device=gen.device)
        return {"gumbel": -torch.log(-torch.log(u.clamp_min(tiny)))}

    def __call__(self, state, logits_or_action, timestep, draws=None,
                 gen=None):
        if not self.discrete:
            return state, logits_or_action
        if draws is None:
            draws = self.draw(logits_or_action, gen)
        return state, torch.argmax(logits_or_action + draws["gumbel"],
                                   dim=-1)
