"""Multi-agent RL: fixed-population envs and independent PPO learners
(counterpart of ``ray_tpu/rl/multi_agent.py``).

The agent population is a static axis, as in the JAX package: an env's
state, observations and actions are ``[num_envs, n_agents, ...]``, and one
call steps every agent of every env.  Per-agent parameters are stacked
along a leading ``[n_agents]`` axis; where the JAX package ``vmap``s a
policy over that axis, the port runs the ordinary policy code once on
agent-major inputs ``[n_agents, batch, ...]`` through `agent_view`, whose
biases broadcast over the batch, so each layer is one batched product for
all agents (no Python loop over agents).  Gradients of the sum of the
agents' losses are the per-agent gradients, since no parameter is shared;
Adam is elementwise, so one `Adam` over the stacked leaves equals N Adams.

Envs take their draws as arguments like `env.TorchEnv` (``reset_given`` /
``step_given``), in the JAX package's distributions, and auto-reset at the
horizon from the step's reset draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .algorithm import Algorithm
from .env import Draws, State, _uniform, _where
from .learner import value_and_grad
from .policy import MLPPolicy, tree_from_numpy, tree_map, tree_to_numpy
from .ppo import Adam, compute_gae


def stack_trees(trees: List[Any]) -> Any:
    """Per-agent params trees → one tree of [N, ...] leaves (new memory,
    one copy per agent)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def agent_view(stacked: Any) -> Any:
    """A stacked params tree ([N, ...] leaves) as views in which every
    bias ``b`` [N, out] is [N, 1, out], so the single-agent code (``x @ w
    + b``) applied to agent-major inputs [N, M, in] runs each agent's
    layer on its own rows in one batched product."""
    if isinstance(stacked, dict):
        return {k: (v.unsqueeze(-2) if k == "b" and torch.is_tensor(v)
                    else agent_view(v)) for k, v in stacked.items()}
    if isinstance(stacked, (list, tuple)):
        return type(stacked)(agent_view(v) for v in stacked)
    return stacked


def stacked_shapes(shapes: Any, n: int) -> Any:
    """A params tree's shapes with the leading agent axis."""
    if isinstance(shapes, dict):
        return {k: stacked_shapes(v, n) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [stacked_shapes(v, n) for v in shapes]
    return (n,) + tuple(shapes)


class MultiAgentTorchEnv:
    """Protocol (the JAX package's ``MultiAgentJaxEnv``), batched: a fixed
    ``n_agents``; state, observations [B, N, obs] and actions [B, N, ...]
    carry the env and agent axes; rewards are [B, N] and ``done`` [B] (a
    shared episode end).  A step that ends an episode resets that env
    from the step's reset draws."""

    n_agents: int
    observation_size: int
    action_size: int
    discrete: bool = True

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def reset_draws(self, n: int, gen: torch.Generator) -> Draws:
        raise NotImplementedError

    def reset_given(self, draws: Draws) -> Tuple[State, torch.Tensor]:
        raise NotImplementedError

    def step_given(self, state: State, actions: torch.Tensor, draws: Draws
                   ) -> Tuple[State, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
        """→ (state, obs [B, N, obs], rewards [B, N], done [B] bool)."""
        raise NotImplementedError

    def reset(self, n: int, gen: torch.Generator):
        return self.reset_given(self.reset_draws(n, gen))

    def step(self, state: State, actions: torch.Tensor,
             gen: torch.Generator):
        return self.step_given(state, actions,
                               self.reset_draws(actions.shape[0], gen))


class SpreadLine(MultiAgentTorchEnv):
    """N agents on a line spread to their own targets while neighbours
    push them (a small "simple spread": per-agent shaped reward, conflict
    through soft collisions).  Actions left / stay / right.

    The targets are ``torch.linspace(-1, 1, N)``, which differs from
    ``jnp.linspace`` in the last bit of some points (N = 4: 6e-8); they
    enter observations and rewards only, not the dynamics."""

    def __init__(self, n_agents: int = 4, horizon: int = 64,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_agents = n_agents
        self.horizon = horizon
        self.observation_size = 3   # (pos, own target, nearest-other dist)
        self.action_size = 3
        self.discrete = True
        self._targets = torch.linspace(-1.0, 1.0, n_agents,
                                       device=self.device)
        self._eye = torch.eye(n_agents, dtype=torch.bool,
                              device=self.device)

    def reset_draws(self, n, gen):
        """``{"pos": [n, N]}`` uniform in [-1, 1)."""
        return {"pos": _uniform(gen, (n, self.n_agents), -1.0, 1.0)}

    def reset_given(self, draws):
        pos = draws["pos"].float()
        n = pos.shape[0]
        state = {"pos": pos,
                 "targets": self._targets.expand(n, -1).clone(),
                 "t": torch.zeros(n, dtype=torch.int32, device=pos.device)}
        return state, self._obs(state)

    def _obs(self, state):
        pos = state["pos"]
        diff = (pos[:, :, None] - pos[:, None, :]).abs() \
            + self._eye.float() * 1e9
        nearest = diff.min(dim=-1).values
        return torch.stack([pos, state["targets"], nearest], dim=-1)

    def _delta(self, actions):
        return (actions.float() - 1.0) * 0.1

    def step_given(self, state, actions, draws):
        pos = torch.clamp(state["pos"] + self._delta(actions), -1.5, 1.5)
        # soft collision: agents within 0.1 push each other apart
        diff = pos[:, :, None] - pos[:, None, :]
        close = (diff.abs() < 0.1) & ~self._eye
        push = (torch.sign(diff) * close * 0.05).sum(dim=-1)
        pos = torch.clamp(pos + push, -1.5, 1.5)
        t = state["t"] + 1
        cur = {"pos": pos, "targets": state["targets"], "t": t}
        rewards = -(pos - state["targets"]).abs() \
            - 0.25 * close.sum(dim=-1)
        done = t >= self.horizon
        reset_state, _ = self.reset_given(draws)
        state = _where(done, reset_state, cur)
        return state, self._obs(state), rewards, done


@dataclasses.dataclass
class IndependentPPOConfig:
    # env factory, called as env(device=...)
    env: Optional[Callable[..., MultiAgentTorchEnv]] = None
    num_envs: int = 32
    rollout_length: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    lr: float = 3e-4
    num_sgd_epochs: int = 2
    hidden: tuple = (64, 64)
    share_parameters: bool = False
    seed: int = 0
    # where the envs, the policies and the updates run (None: the card)
    device: Any = None

    def build(self) -> "IndependentPPO":
        return IndependentPPO(self)


class IndependentPPO(Algorithm):
    """One PPO learner per agent, all run at once: stacked parameters,
    one batched forward for all agents, per-agent GAE, and per agent
    ``num_sgd_epochs`` full-batch steps, each on its own permutation of
    the agent's batch.  With ``share_parameters`` every agent starts from
    one init (copied, not aliased) and then trains on its own."""

    _config_cls = IndependentPPOConfig

    def __init__(self, config: IndependentPPOConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("IndependentPPOConfig.env required")
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        self.n_agents = N = self.env.n_agents
        self.policy = MLPPolicy(self.env.observation_size,
                                self.env.action_size,
                                discrete=self.env.discrete,
                                hidden=cfg.hidden, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        if cfg.share_parameters:
            # repeat, not expand: the in-place Adam step must write N
            # copies, not one tensor N times
            shared = self.policy.init(self.generator)
            self.params = tree_map(
                lambda x: x.unsqueeze(0).repeat((N,) + (1,) * x.dim()),
                shared)
        else:
            self.params = stack_trees([self.policy.init(self.generator)
                                       for _ in range(N)])
        self.optimizer = Adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self._ep_rewards: list = []

    def param_shapes(self):
        """The stacked params' shapes (`convert.policy_params_from_numpy`
        takes the JAX package's stacked tree)."""
        return stacked_shapes(self.policy.param_shapes(), self.n_agents)

    # -- the iteration ------------------------------------------------------
    def _draw_noise(self, gen):
        """Sampling noise per env and agent, [B, N, A]."""
        return self.policy.draw_noise(
            self.config.num_envs * self.n_agents, gen).view(
                self.config.num_envs, self.n_agents, -1)

    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """``rollout_length`` steps of every agent in every env and GAE per
        agent.  ``draws``: a list over steps of ``{"noise": [B, N, A],
        "reset": ...}``.  → the trajectory [T, B, N, ...] with ``adv`` and
        ``ret``."""
        cfg, env, policy = self.config, self.env, self.policy
        view = agent_view(self.params)
        obs, frames = self.obs, []
        for t in range(cfg.rollout_length):
            d = draws[t] if draws is not None else None
            noise = d["noise"] if d is not None else self._draw_noise(
                self.generator)
            actions, logps, values = policy.sample_action(
                view, obs.transpose(0, 1), noise=noise.transpose(0, 1))
            actions = actions.transpose(0, 1)
            reset = (d["reset"] if d is not None
                     else env.reset_draws(cfg.num_envs, self.generator))
            self.env_states, next_obs, rewards, done = env.step_given(
                self.env_states, actions, reset)
            frames.append({"obs": obs, "action": actions,
                           "logp": logps.transpose(0, 1),
                           "value": values.transpose(0, 1),
                           "reward": rewards,
                           "done": done[:, None].expand(-1, self.n_agents)})
            obs = next_obs
        self.obs = obs
        traj = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
        _, last_value = policy.forward(view, obs.transpose(0, 1))
        traj["adv"], traj["ret"] = compute_gae(
            traj, last_value.transpose(0, 1), cfg.gamma, cfg.gae_lambda)
        return traj

    def _loss(self, params, mb):
        """Each agent's PPO loss on its own minibatch ([N, n, ...]), summed
        (the gradients of the sum are each agent's own); → (sum, the
        per-agent losses [N])."""
        cfg = self.config
        logp, entropy, value = self.policy.log_prob(
            agent_view(params), mb["obs"], mb["action"])
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        adv = (adv - adv.mean(-1, keepdim=True)) / (
            adv.std(-1, correction=0, keepdim=True) + 1e-8)
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
        pi_loss = -torch.minimum(ratio * adv, clipped * adv).mean(-1)
        vf_loss = 0.5 * ((value - mb["ret"]) ** 2).mean(-1)
        losses = pi_loss + cfg.vf_coeff * vf_loss \
            - cfg.entropy_coeff * entropy.mean(-1)
        return losses.sum(), losses

    def learn(self, traj, perms=None) -> torch.Tensor:
        """``num_sgd_epochs`` full-batch steps per agent, each on the
        agent's own permutation (``perms[epoch]`` [N, T·B], else drawn
        from the generator).  → the last epoch's per-agent losses [N]."""
        cfg, N = self.config, self.n_agents
        n = cfg.rollout_length * cfg.num_envs

        def agent_major(x):          # [T, B, N, ...] -> [N, T·B, ...]
            return x.movedim(2, 0).reshape((N, n) + x.shape[3:])

        batch = {k: agent_major(traj[k]) for k in ("obs", "action", "logp",
                                                   "adv", "ret")}
        rows = torch.arange(N, device=self.device)[:, None]
        losses = None
        for epoch in range(cfg.num_sgd_epochs):
            perm = (perms[epoch] if perms is not None else torch.argsort(
                torch.rand(N, n, generator=self.generator,
                           device=self.device), dim=-1))
            mb = {k: v[rows, perm] for k, v in batch.items()}
            _, losses, grads = value_and_grad(self._loss, self.params, mb)
            self.optimizer.update(grads, self.opt_state, self.params)
        return losses

    def training_step(self, draws=None, perms=None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(draws)
        losses = self.learn(traj, perms)
        mean_reward = traj["reward"].mean(dim=(0, 1))      # per agent
        # the iteration's one read of the device
        losses, mean_reward = torch.stack([losses, mean_reward]).tolist()
        reward_mean = sum(mean_reward) / len(mean_reward)
        self._ep_rewards.append(reward_mean)
        env_steps = cfg.num_envs * cfg.rollout_length * self.n_agents
        return {"loss_per_agent": losses,
                "reward_mean_per_agent": mean_reward,
                "reward_mean": reward_mean,
                "env_steps_this_iter": env_steps,
                "env_steps_per_s": env_steps / (time.perf_counter() - t0)}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.iteration = state.get("iteration", 0)

