"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing
(counterpart of ``ray_tpu/rl/qmix.py``).

Per-agent Q-networks (one set of parameters shared by the agents) give
each agent's chosen value; a mixing network whose weights come from
hypernetworks of the global state turns them into the team value, and TD
runs on that.  ``abs`` on the hypernetworks' weight outputs keeps
``dQ_tot / dQ_a >= 0``.  The global state is ``env.global_state(state)``
where the env has one, else the agents' observations concatenated.

The JAX package compiles collect → replay insert → the gated TD updates
into one program; here `QMIX.collect` loops over the env steps (the
agents' Q forward, epsilon-greedy over [B, N, A], the env step, one
insert) and `QMIX.learn` runs `learner.make_update_gate`, whose gate reads
the buffer's host-side size.  Epsilon is computed once an iteration, from
the env steps before it, as in the JAX package.  Draws come from the
algorithm's `torch.Generator` or as arguments (``collect(draws)``: per
step the explorer's ``uniform`` / ``random`` [B, N] and the envs'
``reset``; ``learn(draws)``: per update the sample's ``{"idx"}``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import replay
from .algorithm import Algorithm
from .exploration import EpsilonGreedy
from .learner import make_update_gate
from .multi_agent import MultiAgentTorchEnv
from .policy import (mlp_apply, mlp_init, mlp_shapes, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import Adam


def _mixer_sizes(state_size: int, n_agents: int, embed: int):
    return {"hw1": (state_size, n_agents * embed),
            "hb1": (state_size, embed),
            "hw2": (state_size, embed),
            # the final bias through a small MLP (the paper's V(s))
            "hv": (state_size, embed, 1)}


def mixer_init(gen: torch.Generator, state_size: int, n_agents: int,
               embed: int):
    """Hypernetworks mapping the global state to the mixer's weights."""
    return {k: mlp_init(gen, sizes) for k, sizes in
            _mixer_sizes(state_size, n_agents, embed).items()}


def mixer_shapes(state_size: int, n_agents: int, embed: int):
    return {k: mlp_shapes(sizes) for k, sizes in
            _mixer_sizes(state_size, n_agents, embed).items()}


def mixer_apply(params, q_agents: torch.Tensor,
                state: torch.Tensor) -> torch.Tensor:
    """[.., N] chosen per-agent Qs and the [.., S] global state → [..]
    Q_tot, monotonic in every agent's Q (the weights pass through
    ``abs``)."""
    n = q_agents.shape[-1]
    w1 = torch.abs(mlp_apply(params["hw1"], state))
    w1 = w1.reshape(state.shape[:-1] + (n, -1))          # [.., N, E]
    b1 = mlp_apply(params["hb1"], state)                 # [.., E]
    hidden = F.elu(torch.einsum("...n,...ne->...e", q_agents, w1) + b1)
    w2 = torch.abs(mlp_apply(params["hw2"], state))      # [.., E]
    v = mlp_apply(params["hv"], state)[..., 0]           # [..]
    return (hidden * w2).sum(-1) + v


@dataclasses.dataclass
class QMIXConfig:
    # env factory, called as env(device=...) (a MultiAgentTorchEnv)
    env: Optional[Callable[..., MultiAgentTorchEnv]] = None
    num_envs: int = 16
    rollout_steps: int = 32        # env steps per iteration
    buffer_capacity: int = 50_000
    batch_size: int = 128
    num_updates: int = 16
    mixing_embed: int = 32
    gamma: float = 0.99
    lr: float = 1e-3
    tau: float = 0.01              # Polyak target-average rate
    double_q: bool = True
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 20_000
    learn_start: int = 1_000
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the envs, the buffer and the networks live (None: the card)
    device: Any = None

    def build(self) -> "QMIX":
        return QMIX(self)


class QMIX(Algorithm):
    _config_cls = QMIXConfig

    def __init__(self, config: QMIXConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("QMIXConfig.env required (a MultiAgentJaxEnv "
                             "factory)")
        self.device = dev = resolve_device(cfg.device)
        self.env = cfg.env(device=dev)
        if not self.env.discrete:
            raise ValueError("QMIX is value-based: discrete actions only")
        self.n_agents = N = self.env.n_agents
        obs_dim, n_act = self.env.observation_size, self.env.action_size
        self._state_fn = getattr(self.env, "global_state", None)
        self.state_size = (N * obs_dim if self._state_fn is None
                           else self.env.global_state_size)
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self._q_sizes = (obs_dim,) + tuple(cfg.hidden) + (n_act,)
        self.params = {
            "q": mlp_init(self.generator, self._q_sizes),
            "mix": mixer_init(self.generator, self.state_size, N,
                              cfg.mixing_embed)}
        self.target_params = tree_map(torch.clone, self.params)
        self.optimizer = Adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.buffer = replay.init(cfg.buffer_capacity, {
            "obs": torch.zeros(N, obs_dim, device=dev),
            "state": torch.zeros(self.state_size, device=dev),
            "action": torch.zeros(N, dtype=torch.long, device=dev),
            "reward": torch.zeros((), device=dev),
            "next_obs": torch.zeros(N, obs_dim, device=dev),
            "next_state": torch.zeros(self.state_size, device=dev),
            "done": torch.zeros((), device=dev),
        })
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self._explorer = EpsilonGreedy(cfg.eps_start, cfg.eps_end,
                                       cfg.eps_decay_steps)
        self._gate = make_update_gate(
            self.optimizer, tau=cfg.tau, learn_start=cfg.learn_start,
            num_updates=cfg.num_updates,
            sample_fn=lambda buf, d: replay.sample(
                buf, cfg.batch_size, self.generator, d),
            loss_fn=self.td_loss)
        self._init_episode_tracking(cfg.num_envs)

    def param_shapes(self):
        """The params tree's shapes (`convert.policy_params_from_numpy`)."""
        return {"q": mlp_shapes(self._q_sizes),
                "mix": mixer_shapes(self.state_size, self.n_agents,
                                    self.config.mixing_embed)}

    def _global_state(self, env_state, obs):
        """The [B] batch's global mixer state."""
        if self._state_fn is not None:
            return self._state_fn(env_state)
        return obs.reshape(obs.shape[0], -1)

    # -- the iteration ------------------------------------------------------
    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """``rollout_steps`` epsilon-greedy steps of every env into the
        buffer, epsilon from the env steps before this iteration.
        ``draws``: a list over steps of ``{"uniform", "random", "reset"}``.
        → the trajectory's team ``reward`` and ``done`` [T, B]."""
        cfg, n = self.config, self.config.num_envs
        steps = self._total_env_steps
        obs, rewards, dones = self.obs, [], []
        for t in range(cfg.rollout_steps):
            d = draws[t] if draws is not None else None
            state_g = self._global_state(self.env_states, obs)
            qvals = mlp_apply(self.params["q"], obs)          # [B, N, A]
            _, action = self._explorer((), qvals, steps, draws=d,
                                       gen=self.generator)
            reset = (d["reset"] if d is not None
                     else self.env.reset_draws(n, self.generator))
            self.env_states, next_obs, reward, done = self.env.step_given(
                self.env_states, action, reset)
            team_r = reward.sum(-1)
            replay.add_batch(self.buffer, {
                "obs": obs, "state": state_g, "action": action,
                "reward": team_r, "next_obs": next_obs,
                "next_state": self._global_state(self.env_states, next_obs),
                "done": done.float()}, n)
            rewards.append(team_r)
            dones.append(done)
            obs = next_obs
        self.obs = obs
        return {"reward": torch.stack(rewards), "done": torch.stack(dones)}

    def q_tot(self, params, batch) -> torch.Tensor:
        """The mixed value of the batch's joint actions, [B]."""
        q_sa = mlp_apply(params["q"], batch["obs"]).gather(
            -1, batch["action"].long()[..., None])[..., 0]   # [B, N]
        return mixer_apply(params["mix"], q_sa, batch["state"])

    def td_loss(self, params, target_params, batch) -> torch.Tensor:
        """The team TD loss: double-Q selection per agent, the target
        mixer on the next state."""
        cfg = self.config
        with torch.no_grad():
            q_next_t = mlp_apply(target_params["q"], batch["next_obs"])
            sel = torch.argmax(mlp_apply(params["q"], batch["next_obs"])
                               if cfg.double_q else q_next_t, dim=-1)
            q_next = q_next_t.gather(-1, sel[..., None])[..., 0]
            q_tot_next = mixer_apply(target_params["mix"], q_next,
                                     batch["next_state"])
            target = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) \
                * q_tot_next
        return torch.mean((self.q_tot(params, batch) - target) ** 2)

    def learn(self, draws=None) -> torch.Tensor:
        """``num_updates`` TD steps behind the learn-start gate (nothing
        below it); ``draws``: a list over updates of the sample's draw.
        → the last step's loss (0 below the gate)."""
        return self._gate(self.params, self.target_params, self.opt_state,
                          self.buffer, draws)

    def training_step(self, draws=None) -> Dict[str, Any]:
        """`collect` then `learn`; ``draws``: ``{"collect": [...],
        "updates": [...]}`` (tests), else the generator."""
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(None if draws is None else draws["collect"])
        loss = self.learn(None if draws is None else draws["updates"])
        # the iteration's one read of the device
        td_loss = float(loss)
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        steps = cfg.num_envs * cfg.rollout_steps
        return {"td_loss": td_loss,
                "epsilon": self._explorer.epsilon(self._total_env_steps),
                "buffer_size": self.buffer["size"],
                "episode_reward_mean": self.episode_reward_mean(),
                "env_steps_this_iter": steps,
                "env_steps_per_s": steps / dt}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "target_params": tree_to_numpy(self.target_params),
                "iteration": self.iteration,
                # epsilon anneals on env_steps_total
                "env_steps_total": self._total_env_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.target_params = tree_from_numpy(state["target_params"],
                                             self.device)
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("env_steps_total", 0)
