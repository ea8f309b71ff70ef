"""MADDPG: multi-agent DDPG with centralized critics (counterpart of
``ray_tpu/rl/maddpg.py``).

Decentralized deterministic actors (``tanh`` of a ReLU MLP on the agent's
own observation) and per-agent critics that see every agent's observation
and action.  Actor and critic parameters are stacked along a leading agent
axis and run for all agents at once (`multi_agent.agent_view`).  Actor
i's gradient reaches it only through its own action: in critic i's joint
action, slot i is the fresh ``mu_i(o_i)`` and the other slots stay as
sampled (``(1 - eye) * a + eye * mu(o)``).  Each update takes the critic
step first, then the actor step on the updated critics, then Polyak over
both, as the JAX update does.

`MADDPG.collect` loops over the env steps (actors, Gaussian exploration
noise, the env step, one insert), `MADDPG.learn` over the updates behind
the learn-start gate (a host int).  Draws come from the algorithm's
`torch.Generator` or as arguments (``collect(draws)``: per step
``{"normal": [B, N, act], "reset"}``; ``learn(draws)``: per update the
sample's ``{"idx"}``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..device import resolve_device
from . import replay
from .algorithm import Algorithm
from .learner import polyak, value_and_grad
from .multi_agent import (MultiAgentTorchEnv, SpreadLine, agent_view,
                          stack_trees, stacked_shapes)
from .policy import (mlp_init, mlp_shapes, tree_from_numpy, tree_map,
                     tree_to_numpy)
from .ppo import Adam
from .td3 import _relu_mlp


class SpreadLineContinuous(SpreadLine):
    """SpreadLine with velocity actions in [-1, 1] ([B, N, 1]): the
    continuous testbed MADDPG needs."""

    def __init__(self, n_agents: int = 3, horizon: int = 64, device=None):
        super().__init__(n_agents, horizon, device)
        self.action_size = 1
        self.discrete = False

    def _delta(self, actions):
        return torch.clamp(actions[..., 0], -1.0, 1.0) * 0.1


@dataclasses.dataclass
class MADDPGConfig:
    # env factory, called as env(device=...) (a MultiAgentTorchEnv)
    env: Optional[Callable[..., MultiAgentTorchEnv]] = None
    num_envs: int = 16
    rollout_steps: int = 16
    buffer_capacity: int = 100_000
    batch_size: int = 256
    num_updates: int = 16
    gamma: float = 0.95            # the MADDPG paper's default
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    tau: float = 0.01
    expl_noise: float = 0.1        # Gaussian exploration stddev
    learn_start: int = 1_000
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the envs, the buffer and the networks live (None: the card)
    device: Any = None

    def build(self) -> "MADDPG":
        return MADDPG(self)


class MADDPG(Algorithm):
    _config_cls = MADDPGConfig

    def __init__(self, config: MADDPGConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("MADDPGConfig.env required (a "
                             "MultiAgentJaxEnv factory)")
        self.device = dev = resolve_device(cfg.device)
        self.env = cfg.env(device=dev)
        if self.env.discrete:
            raise ValueError(
                "MADDPG is deterministic-gradient continuous control; "
                "use QMIX or IndependentPPO for discrete multi-agent "
                "envs (the reference's discrete mode relies on "
                "Gumbel-softmax relaxation)")
        self.n_agents = N = self.env.n_agents
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        self.act_dim = act_dim
        h = tuple(cfg.hidden)
        # the centralized critic's input: every agent's obs and action
        self._sizes = {"actor": (obs_dim,) + h + (act_dim,),
                       "critic": (N * (obs_dim + act_dim),) + h + (1,)}
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.params = {
            name: stack_trees([mlp_init(self.generator, sizes)
                               for _ in range(N)])
            for name, sizes in self._sizes.items()}
        self.targets = tree_map(torch.clone, self.params)
        self.actor_opt = Adam(cfg.actor_lr)
        self.critic_opt = Adam(cfg.critic_lr)
        self.aopt_state = self.actor_opt.init(self.params["actor"])
        self.copt_state = self.critic_opt.init(self.params["critic"])
        self.buffer = replay.init(cfg.buffer_capacity, {
            "obs": torch.zeros(N, obs_dim, device=dev),
            "action": torch.zeros(N, act_dim, device=dev),
            "reward": torch.zeros(N, device=dev),
            "next_obs": torch.zeros(N, obs_dim, device=dev),
            "done": torch.zeros((), device=dev),
        })
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self._init_episode_tracking(cfg.num_envs)

    def param_shapes(self):
        """The stacked params' shapes (`convert.policy_params_from_numpy`
        takes the JAX package's tree)."""
        return {name: stacked_shapes(mlp_shapes(sizes), self.n_agents)
                for name, sizes in self._sizes.items()}

    # -- the stacked evaluations ------------------------------------------
    def act(self, actor_params, obs: torch.Tensor) -> torch.Tensor:
        """[B, N, obs] → [B, N, act] in [-1, 1], each agent's own
        actor."""
        out = _relu_mlp(agent_view(actor_params), obs.transpose(0, 1))
        return torch.tanh(out).transpose(0, 1)

    def _critics(self, critic_params, obs_flat, joint_flat):
        """Critic i on row block i: [N, B, N·obs] and [N, B, N·act] →
        [N, B]."""
        x = torch.cat([obs_flat, joint_flat], dim=-1)
        return _relu_mlp(agent_view(critic_params), x)[..., 0]

    def q_all(self, critic_params, obs, actions) -> torch.Tensor:
        """Centralized critics: [B, N, obs] and [B, N, act] → [B, N];
        critic i sees every agent's obs and action."""
        B, N = obs.shape[:2]
        q = self._critics(critic_params,
                          obs.reshape(B, -1).expand(N, -1, -1),
                          actions.reshape(B, -1).expand(N, -1, -1))
        return q.transpose(0, 1)

    # -- the iteration ------------------------------------------------------
    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """``rollout_steps`` steps of every env with Gaussian exploration
        noise into the buffer.  ``draws``: a list over steps of
        ``{"normal": [B, N, act], "reset": ...}``.  → the trajectory's
        team ``reward`` and ``done`` [T, B]."""
        cfg, n = self.config, self.config.num_envs
        obs, rewards, dones = self.obs, [], []
        for t in range(cfg.rollout_steps):
            d = draws[t] if draws is not None else None
            action = self.act(self.params["actor"], obs)
            normal = (d["normal"] if d is not None else torch.randn(
                action.shape, generator=self.generator, device=self.device))
            action = torch.clamp(action + cfg.expl_noise * normal, -1.0, 1.0)
            reset = (d["reset"] if d is not None
                     else self.env.reset_draws(n, self.generator))
            self.env_states, next_obs, reward, done = self.env.step_given(
                self.env_states, action, reset)
            replay.add_batch(self.buffer, {
                "obs": obs, "action": action, "reward": reward,
                "next_obs": next_obs, "done": done.float()}, n)
            rewards.append(reward.sum(-1))
            dones.append(done)
            obs = next_obs
        self.obs = obs
        return {"reward": torch.stack(rewards), "done": torch.stack(dones)}

    def critic_loss(self, critic_params, batch):
        cfg = self.config
        with torch.no_grad():
            next_act = self.act(self.targets["actor"], batch["next_obs"])
            q_next = self.q_all(self.targets["critic"], batch["next_obs"],
                                next_act)                      # [B, N]
            target = batch["reward"] + cfg.gamma \
                * (1.0 - batch["done"])[:, None] * q_next
        q = self.q_all(critic_params, batch["obs"], batch["action"])
        return torch.mean((q - target) ** 2), None

    def actor_loss(self, actor_params, critic_params, batch):
        """Critic i scores the joint action whose slot i is actor i's fresh
        action and whose other slots are as sampled."""
        B, N = batch["obs"].shape[:2]
        my_act = self.act(actor_params, batch["obs"])          # [B, N, act]
        eye = torch.eye(N, device=my_act.device)[:, None, :, None]
        joint = batch["action"][None] * (1 - eye) \
            + my_act[None] * eye                               # [N, B, N, act]
        q = self._critics(critic_params,
                          batch["obs"].reshape(B, -1).expand(N, -1, -1),
                          joint.reshape(N, B, -1))             # [N, B]
        return -torch.mean(q), None

    def learn(self, draws=None) -> Dict[str, torch.Tensor]:
        """``num_updates`` updates behind the learn-start gate: the critic
        step, the actor step on the updated critics, Polyak over both.
        ``draws``: a list over updates of the sample's draw.  → the last
        update's ``critic_loss`` and ``actor_loss`` (0 below the gate)."""
        cfg = self.config
        zero = torch.zeros((), device=self.device)
        out = {"critic_loss": zero, "actor_loss": zero}
        if self.buffer["size"] < cfg.learn_start:
            return out
        for k in range(cfg.num_updates):
            batch, _ = replay.sample(self.buffer, cfg.batch_size,
                                     self.generator,
                                     None if draws is None else draws[k])
            out["critic_loss"], _, grads = value_and_grad(
                self.critic_loss, self.params["critic"], batch)
            self.critic_opt.update(grads, self.copt_state,
                                   self.params["critic"])
            out["actor_loss"], _, grads = value_and_grad(
                self.actor_loss, self.params["actor"],
                self.params["critic"], batch)
            self.actor_opt.update(grads, self.aopt_state,
                                  self.params["actor"])
            polyak(self.targets, self.params, cfg.tau)
        return out

    def training_step(self, draws=None) -> Dict[str, Any]:
        """`collect` then `learn`; ``draws``: ``{"collect": [...],
        "updates": [...]}`` (tests), else the generator."""
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(None if draws is None else draws["collect"])
        losses = self.learn(None if draws is None else draws["updates"])
        # the iteration's one read of the device
        c_loss, a_loss = torch.stack(list(losses.values())).tolist()
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        steps = cfg.num_envs * cfg.rollout_steps
        return {"critic_loss": c_loss, "actor_loss": a_loss,
                "buffer_size": self.buffer["size"],
                "episode_reward_mean": self.episode_reward_mean(),
                "env_steps_this_iter": steps,
                "env_steps_per_s": steps / dt}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "targets": tree_to_numpy(self.targets),
                "iteration": self.iteration,
                "env_steps_total": self._total_env_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.targets = tree_from_numpy(state["targets"], self.device)
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("env_steps_total", 0)
