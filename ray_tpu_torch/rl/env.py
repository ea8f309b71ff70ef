"""Batched environments (counterpart of ``ray_tpu/rl/env.py``).

The JAX package writes each env for one instance and maps it over a batch;
here the state is a dict of tensors ``[num_envs, ...]`` and one call steps
every env.  Randomness comes from an explicit `torch.Generator`, and each
env also takes its draws as an argument: ``reset_given(draws)`` and
``step_given(state, action, draws)`` compute the reset and the step from
draws in the distribution the JAX package uses (uniform for CartPole and
Pendulum, bernoulli for MemoryCue, randint for GridTarget, PixelPong's
spawn and paddle), so the same draws give the same trajectory in both
packages.  ``reset(n, generator)`` and ``step(state, action, generator)``
make the draws themselves.  A step that ends an episode resets that env
from the step's reset draws (the JAX convention).  Nothing reads the device
back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device

State = Dict[str, torch.Tensor]
Draws = Dict[str, torch.Tensor]


def _uniform(gen: torch.Generator, shape, low: float, high: float
             ) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) \
        * (high - low) + low


def _where(done: torch.Tensor, reset: State, cur: State) -> State:
    """Per env, the reset state where ``done`` and the current one
    elsewhere."""
    out = {}
    for k, r in reset.items():
        d = done.view((-1,) + (1,) * (r.dim() - 1))
        out[k] = torch.where(d, r, cur[k])
    return out


class TorchEnv:
    """Batched env interface (the JAX package's ``JaxEnv``): subclass and
    implement ``reset_draws``, ``reset_given`` and ``step_given``."""

    observation_size: int
    action_size: int          # number of discrete actions, or dim if cont.
    discrete: bool = True
    max_episode_steps: int = 500
    action_high: float = 1.0  # continuous action bound: actions in ±high

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def reset_draws(self, n: int, gen: torch.Generator) -> Draws:
        raise NotImplementedError

    def reset_given(self, draws: Draws) -> Tuple[State, torch.Tensor]:
        """→ (state, obs [n, observation_size])."""
        raise NotImplementedError

    def step_given(self, state: State, action: torch.Tensor, draws: Draws
                   ) -> Tuple[State, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
        """→ (state, obs, reward [n] float32, done [n] bool); ``draws``
        are the reset draws of the envs whose episode ends."""
        raise NotImplementedError

    def reset(self, n: int, gen: torch.Generator
              ) -> Tuple[State, torch.Tensor]:
        return self.reset_given(self.reset_draws(n, gen))

    def step(self, state: State, action: torch.Tensor, gen: torch.Generator):
        return self.step_given(state, action,
                               self.reset_draws(action.shape[0], gen))


class CartPole(TorchEnv):
    """Cart-pole balancing (classic control dynamics)."""

    observation_size = 4
    action_size = 2
    discrete = True
    max_episode_steps = 500

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def reset_draws(self, n, gen):
        return {"obs": _uniform(gen, (n, 4), -0.05, 0.05)}

    def reset_given(self, draws):
        obs = draws["obs"].float()
        t = torch.zeros(obs.shape[0], dtype=torch.int32, device=obs.device)
        return {"obs": obs, "t": t}, obs

    def step_given(self, state, action, draws):
        x, x_dot, theta, theta_dot = state["obs"].unbind(-1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot ** 2 * sintheta) \
            / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta ** 2
                           / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        obs = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        t = state["t"] + 1
        done = (x.abs() > self.x_threshold) | \
            (theta.abs() > self.theta_threshold) | \
            (t >= self.max_episode_steps)
        reward = torch.ones_like(x)
        reset_state, reset_obs = self.reset_given(draws)
        new_state = _where(done, reset_state, {"obs": obs, "t": t})
        return new_state, new_state["obs"], reward, done


class MemoryCue(TorchEnv):
    """Partially observable cue recall: a binary cue is visible only in the
    first observation of an episode; reward 1 for choosing the matching
    action at every step (a memoryless policy cannot solve it)."""

    observation_size = 3   # [cue==0, cue==1, first-step flag]
    action_size = 2
    discrete = True
    max_episode_steps = 8

    def reset_draws(self, n, gen):
        return {"cue": torch.rand(n, generator=gen, device=gen.device) < 0.5}

    def reset_given(self, draws):
        cue = draws["cue"].to(torch.int32)
        state = {"cue": cue, "t": torch.zeros_like(cue)}
        c = cue.float()
        obs = torch.stack([1.0 - c, c, torch.ones_like(c)], dim=-1)
        return state, obs

    def step_given(self, state, action, draws):
        reward = (action == state["cue"]).float()
        t = state["t"] + 1
        done = t >= self.max_episode_steps
        obs = torch.zeros(t.shape[0], 3, device=t.device)  # cue hidden
        reset_state, reset_obs = self.reset_given(draws)
        new_state = _where(done, reset_state, {"cue": state["cue"], "t": t})
        new_obs = torch.where(done[:, None], reset_obs, obs)
        return new_state, new_obs, reward, done


class Pendulum(TorchEnv):
    """Torque-controlled pendulum swing-up (continuous actions)."""

    observation_size = 3
    action_size = 1
    discrete = False
    max_episode_steps = 200
    action_high = 2.0         # == max_torque: policies must span it

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    @staticmethod
    def _obs(th, thdot):
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def reset_draws(self, n, gen):
        return {"th": _uniform(gen, (n,), -math.pi, math.pi),
                "thdot": _uniform(gen, (n,), -1.0, 1.0)}

    def reset_given(self, draws):
        th, thdot = draws["th"].float(), draws["thdot"].float()
        state = {"th": th, "thdot": thdot,
                 "t": torch.zeros(th.shape[0], dtype=torch.int32,
                                  device=th.device)}
        return state, self._obs(th, thdot)

    def step_given(self, state, action, draws):
        th, thdot, t = state["th"], state["thdot"], state["t"]
        u = action.reshape(-1).clamp(-self.max_torque, self.max_torque)
        norm_th = ((th + math.pi) % (2 * math.pi)) - math.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.g / (2 * self.length) * torch.sin(th)
                         + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        thdot = thdot.clamp(-self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        t = t + 1
        done = t >= self.max_episode_steps
        reset_state, _ = self.reset_given(draws)
        new_state = _where(done, reset_state,
                           {"th": th, "thdot": thdot, "t": t})
        obs = self._obs(new_state["th"], new_state["thdot"])
        return new_state, obs, -cost, done


class PixelPong(TorchEnv):
    """Pong against the wall, from pixels.

    A ball bounces off the side walls and the ceiling of a ``SIZE`` x
    ``SIZE`` court; the agent slides a paddle along the bottom (left, stay,
    right) to return it.  A return earns +1 and speeds the ball up by 5%; a
    miss ends the episode at -1.  Observations are rendered frames
    ``(SIZE, SIZE, 3)``, flattened in that (H, W, C) order: ball plane,
    previous-ball plane (velocity shows only across frames), paddle plane.
    """

    SIZE = 24
    PADDLE_W = 6
    observation_shape = (SIZE, SIZE, 3)
    observation_size = SIZE * SIZE * 3
    action_size = 3          # left / stay / right
    discrete = True
    max_episode_steps = 400

    def _pixel(self, v):
        return torch.round(v * (self.SIZE - 1)).to(torch.int32).clamp(
            0, self.SIZE - 1).long()

    def _pad_lo(self, paddle):
        return torch.round(paddle * (self.SIZE - self.PADDLE_W)).to(
            torch.int32)

    def _render(self, ball, prev_ball, paddle):
        """Batched frames: a scatter of the ball and previous-ball pixels
        and the paddle row into zeros."""
        n, size = ball.shape[0], self.SIZE
        img = torch.zeros(n, size, size, 3, device=ball.device)
        rows = torch.arange(n, device=ball.device)
        one = torch.ones((), device=ball.device)
        img.index_put_((rows, self._pixel(ball[:, 1]),
                        self._pixel(ball[:, 0]), rows.new_zeros(())), one)
        img.index_put_((rows, self._pixel(prev_ball[:, 1]),
                        self._pixel(prev_ball[:, 0]), rows.new_ones(())), one)
        cols = torch.arange(size, device=ball.device)
        lo = self._pad_lo(paddle)[:, None]
        img[:, size - 1, :, 2] = ((cols >= lo) & (cols < lo + self.PADDLE_W)
                                  ).float()
        return img.reshape(n, -1)

    def reset_draws(self, n, gen):
        return {"x": _uniform(gen, (n,), 0.2, 0.8),
                "vx": _uniform(gen, (n,), -0.03, 0.03),
                "paddle": torch.rand(n, generator=gen, device=gen.device)}

    def reset_given(self, draws):
        x, vx = draws["x"].float(), draws["vx"].float()
        paddle = draws["paddle"].float()
        ball = torch.stack([x, torch.full_like(x, 0.15)], dim=-1)
        vx = torch.where(vx.abs() < 0.01, torch.sign(vx + 1e-9) * 0.015, vx)
        vel = torch.stack([vx, torch.full_like(vx, 0.04)], dim=-1)
        state = {"ball": ball, "prev_ball": ball, "vel": vel,
                 "paddle": paddle,
                 "t": torch.zeros(x.shape[0], dtype=torch.int32,
                                  device=x.device)}
        return state, self._render(ball, ball, paddle)

    def step_given(self, state, action, draws):
        paddle = (state["paddle"] + (action.float() - 1.0) * 0.07).clamp(
            0.0, 1.0)
        ball = state["ball"] + state["vel"]
        vx, vy = state["vel"].unbind(-1)
        # side walls and ceiling reflect
        vx = torch.where((ball[:, 0] < 0.0) | (ball[:, 0] > 1.0), -vx, vx)
        vy = torch.where(ball[:, 1] < 0.0, -vy, vy)
        ball = ball.clamp(0.0, 1.0)
        # the paddle check is in pixel space, the mapping _render uses
        at_bottom = ball[:, 1] >= 1.0
        ball_col = self._pixel(ball[:, 0])
        pad_lo = self._pad_lo(paddle)
        hit = at_bottom & (ball_col >= pad_lo) \
            & (ball_col < pad_lo + self.PADDLE_W)
        miss = at_bottom & ~hit
        # a return bounces the ball up 5% faster (the difficulty ramp)
        vy = torch.where(hit, -vy.abs() * 1.05, vy)
        vel = torch.stack([vx, vy], dim=-1)
        reward = torch.where(hit, 1.0, torch.where(miss, -1.0, 0.0))
        t = state["t"] + 1
        done = miss | (t >= self.max_episode_steps)
        cur = {"ball": ball, "prev_ball": state["ball"], "vel": vel,
               "paddle": paddle, "t": t}
        reset_state, reset_obs = self.reset_given(draws)
        new_state = _where(done, reset_state, cur)
        obs = self._render(ball, state["ball"], paddle)
        new_obs = torch.where(done[:, None], reset_obs, obs)
        return new_state, new_obs, reward, done


class GridTarget(TorchEnv):
    """An agent on an N x N grid steps toward a target; the observation is
    a flattened 2-channel image (agent plane, target plane)."""

    N = 5
    observation_shape = (N, N, 2)
    observation_size = N * N * 2
    action_size = 4          # up / down / left / right
    discrete = True
    max_episode_steps = 30

    def __init__(self, device: DeviceLike = None):
        super().__init__(device)
        self._moves = torch.tensor([[-1, 0], [1, 0], [0, -1], [0, 1]],
                                   dtype=torch.int32, device=self.device)

    def _obs(self, agent, target):
        n = agent.shape[0]
        img = torch.zeros(n, self.N, self.N, 2, device=agent.device)
        rows = torch.arange(n, device=agent.device)
        one = torch.ones((), device=agent.device)
        a, g = agent.long(), target.long()
        img.index_put_((rows, a[:, 0], a[:, 1], rows.new_zeros(())), one)
        img.index_put_((rows, g[:, 0], g[:, 1], rows.new_ones(())), one)
        return img.reshape(n, -1)

    def reset_draws(self, n, gen):
        return {"agent": torch.randint(0, self.N, (n, 2), generator=gen,
                                       device=gen.device),
                "target": torch.randint(0, self.N, (n, 2), generator=gen,
                                        device=gen.device)}

    def reset_given(self, draws):
        agent = draws["agent"].to(torch.int32)
        target = draws["target"].to(torch.int32)
        state = {"agent": agent, "target": target,
                 "t": torch.zeros(agent.shape[0], dtype=torch.int32,
                                  device=agent.device)}
        return state, self._obs(agent, target)

    def step_given(self, state, action, draws):
        agent = (state["agent"] + self._moves[action.long()]).clamp(
            0, self.N - 1)
        reached = (agent == state["target"]).all(dim=-1)
        t = state["t"] + 1
        done = reached | (t >= self.max_episode_steps)
        reward = torch.where(reached, 1.0, -0.02)
        reset_state, reset_obs = self.reset_given(draws)
        new_state = _where(done, reset_state,
                           {"agent": agent, "target": state["target"],
                            "t": t})
        obs = self._obs(agent, state["target"])
        new_obs = torch.where(done[:, None], reset_obs, obs)
        return new_state, new_obs, reward, done
