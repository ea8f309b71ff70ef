"""TD3 and DDPG: deterministic-policy continuous control (counterpart of
``ray_tpu/rl/td3.py``): a ``high * tanh`` actor, twin critics, clipped
target-policy smoothing and delayed actor and target updates, with a
replay buffer on the card (`replay`).

The JAX package gates the delayed update with a ``lax.cond`` on a device
update counter; here the counter is a host int, kept in checkpoints so a
restore keeps the delay's phase.  ``DDPGConfig`` is TD3 with the three
tricks off (one critic, no smoothing, an actor step every update) and OU
exploration.  Draws come from the algorithm's `torch.Generator` or as
arguments: ``collect(draws)`` takes per step the exploration ``noise``
and the envs' ``reset`` draws, ``learn(draws)`` per update the sample's
draw and the smoothing noise (``smooth``, [B, A]).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..device import resolve_device
from . import replay
from .algorithm import Algorithm
from .env import TorchEnv
from .exploration import GaussianActionNoise, OrnsteinUhlenbeckNoise
from .learner import polyak, value_and_grad
from .policy import (mlp_apply, mlp_init, mlp_shapes, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import Adam


def _relu_mlp(params, x):
    return mlp_apply(params, x, activation=torch.relu)


@dataclasses.dataclass
class TD3Config:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_envs: int = 16
    rollout_steps: int = 16
    buffer_capacity: int = 100_000
    batch_size: int = 256
    num_updates: int = 16
    gamma: float = 0.99
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    tau: float = 0.005             # Polyak target-average rate
    policy_delay: int = 2          # critic updates per actor update
    smooth_target_policy: bool = True
    target_noise: float = 0.2      # smoothing noise stddev
    noise_clip: float = 0.5        # smoothing noise clip
    twin_q: bool = True
    ou_noise: bool = False         # exploration: OU instead of Gaussian
    expl_noise_scale: float = 0.1  # Gaussian exploration stddev (start)
    expl_noise_final: float = 0.05
    expl_decay_steps: int = 50_000
    prioritized_replay: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    learn_start: int = 1_000
    hidden: tuple = (128, 128)
    seed: int = 0
    # where the env, the buffer and the networks live (None: the card)
    device: Any = None

    def build(self) -> "TD3":
        return TD3(self)


@dataclasses.dataclass
class DDPGConfig(TD3Config):
    """Vanilla DDPG: the TD3 tricks off, OU exploration on."""
    policy_delay: int = 1
    smooth_target_policy: bool = False
    twin_q: bool = False
    ou_noise: bool = True


class TD3(Algorithm):
    _config_cls = TD3Config

    def __init__(self, config: TD3Config):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("TD3Config.env required (an env factory)")
        self.device = dev = resolve_device(cfg.device)
        self.env = cfg.env(device=dev)
        if self.env.discrete:
            raise ValueError("TD3/DDPG requires a continuous-action env")
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        self.act_dim = act_dim
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        # q2 exists even with twin_q=False (the JAX package's one params
        # layout a config); it never enters the loss there, so its
        # gradients are zero and it stays at its init
        self.params = {name: mlp_init(self.generator, sizes)
                       for name, sizes in self._sizes().items()}
        self.targets = tree_map(torch.clone, self.params)
        self.actor_opt = Adam(cfg.actor_lr)
        self.critic_opt = Adam(cfg.critic_lr)
        self.actor_opt_state = self.actor_opt.init(self.params["actor"])
        self.critic_opt_state = self.critic_opt.init(self._critics(
            self.params))
        if cfg.ou_noise:
            self.noise = OrnsteinUhlenbeckNoise(
                act_dim, clip=self.env.action_high)
            self.noise_state = torch.zeros(cfg.num_envs, act_dim, device=dev)
        else:
            self.noise = GaussianActionNoise(
                cfg.expl_noise_scale * self.env.action_high,
                cfg.expl_noise_final * self.env.action_high,
                cfg.expl_decay_steps, clip=self.env.action_high)
            self.noise_state = ()
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self._replay_ops = replay.make_ops(
            cfg.prioritized_replay, alpha=cfg.per_alpha, beta=cfg.per_beta)
        self.buffer = self._replay_ops[0](cfg.buffer_capacity, {
            "obs": torch.zeros(obs_dim, device=dev),
            "action": torch.zeros(act_dim, device=dev),
            "reward": torch.zeros((), device=dev),
            "next_obs": torch.zeros(obs_dim, device=dev),
            "done": torch.zeros((), device=dev),
        })
        self._update_count = 0
        self._init_episode_tracking(cfg.num_envs)

    def _sizes(self):
        obs_dim, act_dim = self.env.observation_size, self.act_dim
        h = tuple(self.config.hidden)
        return {"actor": (obs_dim,) + h + (act_dim,),
                "q1": (obs_dim + act_dim,) + h + (1,),
                "q2": (obs_dim + act_dim,) + h + (1,)}

    def param_shapes(self):
        """The params tree's shapes (`convert.policy_params_from_numpy`)."""
        return {name: mlp_shapes(s) for name, s in self._sizes().items()}

    @staticmethod
    def _critics(params):
        return {"q1": params["q1"], "q2": params["q2"]}

    # -- policy -------------------------------------------------------------
    def _act(self, actor_params, obs):
        return self.env.action_high * torch.tanh(_relu_mlp(actor_params, obs))

    def _q(self, q_params, obs, act):
        return _relu_mlp(q_params, torch.cat([obs, act], dim=-1))[..., 0]

    # -- the iteration ------------------------------------------------------
    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """``rollout_steps`` steps of every env with exploration noise
        into the buffer.  ``draws``: a list over steps of ``{"normal":
        [N, A], "reset": ...}``.  → the trajectory's ``reward`` and
        ``done`` [T, N]."""
        cfg, n = self.config, self.config.num_envs
        add_fn = self._replay_ops[1]
        steps = self._total_env_steps
        obs, rewards, dones = self.obs, [], []
        for t in range(cfg.rollout_steps):
            d = draws[t] if draws is not None else None
            action = self._act(self.params["actor"], obs)
            self.noise_state, action = self.noise(
                self.noise_state, action, steps, draws=d, gen=self.generator)
            reset = (d["reset"] if d is not None
                     else self.env.reset_draws(n, self.generator))
            self.env_states, next_obs, reward, done = self.env.step_given(
                self.env_states, action, reset)
            add_fn(self.buffer, {"obs": obs, "action": action,
                                 "reward": reward, "next_obs": next_obs,
                                 "done": done.float()}, n)
            rewards.append(reward)
            dones.append(done)
            obs = next_obs
        self.obs = obs
        return {"reward": torch.stack(rewards), "done": torch.stack(dones)}

    def _critic_loss(self, qp, batch, weights, smooth):
        cfg, high = self.config, self.env.action_high
        with torch.no_grad():
            next_a = self._act(self.targets["actor"], batch["next_obs"])
            if cfg.smooth_target_policy:
                eps = torch.clamp(cfg.target_noise * smooth,
                                  -cfg.noise_clip, cfg.noise_clip)
                next_a = torch.clamp(next_a + eps, -high, high)
            tq = self._q(self.targets["q1"], batch["next_obs"], next_a)
            if cfg.twin_q:
                tq = torch.minimum(tq, self._q(self.targets["q2"],
                                               batch["next_obs"], next_a))
            target = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * tq
        td1 = self._q(qp["q1"], batch["obs"], batch["action"]) - target
        loss = torch.mean(weights * td1 ** 2)
        td_abs = torch.abs(td1)
        if cfg.twin_q:
            td2 = self._q(qp["q2"], batch["obs"], batch["action"]) - target
            loss = loss + torch.mean(weights * td2 ** 2)
            td_abs = 0.5 * (td_abs + torch.abs(td2))
        return loss, td_abs

    def _actor_loss(self, ap, batch):
        a = self._act(ap, batch["obs"])
        return -torch.mean(self._q(self.params["q1"], batch["obs"], a)), None

    def learn(self, draws=None) -> torch.Tensor:
        """``num_updates`` updates behind the learn-start gate: the
        critics every update, the actor and the Polyak targets when the
        update counter is a multiple of ``policy_delay``.  ``draws``: a list
        over updates of the sample's draw with ``{"smooth": [B, A]}``.
        → the last update's mean |TD| (0 below the gate)."""
        cfg = self.config
        if self.buffer["size"] < cfg.learn_start:
            return torch.zeros((), device=self.device)
        sample_fn, update_pri = self._replay_ops[2], self._replay_ops[3]
        td_mean = None
        for k in range(cfg.num_updates):
            d = draws[k] if draws is not None else None
            batch, idx, weights = sample_fn(self.buffer, cfg.batch_size,
                                            self.generator, d)
            smooth = (d["smooth"] if d is not None else torch.randn(
                cfg.batch_size, self.act_dim, generator=self.generator,
                device=self.device))
            qp = self._critics(self.params)
            _, td_abs, grads = value_and_grad(self._critic_loss, qp, batch,
                                              weights, smooth)
            update_pri(self.buffer, idx, td_abs)
            self.critic_opt.update(grads, self.critic_opt_state, qp)
            if self._update_count % cfg.policy_delay == 0:
                _, _, agrads = value_and_grad(self._actor_loss,
                                              self.params["actor"], batch)
                self.actor_opt.update(agrads, self.actor_opt_state,
                                      self.params["actor"])
                # targets track only on actor-update steps (TD3's delayed
                # target rule; delay 1 makes it every step)
                polyak(self.targets, self.params, cfg.tau)
            self._update_count += 1
            td_mean = td_abs.mean()
        return td_mean

    def training_step(self, draws=None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(None if draws is None else draws["collect"])
        td = self.learn(None if draws is None else draws["updates"])
        # the iteration's one read of the device
        td_abs, step_reward = torch.stack(
            [td, traj["reward"].mean()]).tolist()
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        env_steps = cfg.num_envs * cfg.rollout_steps
        return {"td_abs": td_abs, "buffer_size": float(self.buffer["size"]),
                "step_reward_mean": step_reward,
                "env_steps_this_iter": env_steps,
                "env_steps_per_s": env_steps / dt,
                "episode_reward_mean": self.episode_reward_mean()}

    def action_fn(self):
        """The deterministic policy for deployment and evaluation:
        ``policy(obs, gen=None) -> action``."""
        act, params = self._act, self.params

        def policy(obs, gen=None):
            with torch.no_grad():
                return act(params["actor"], obs)
        return policy

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "targets": tree_to_numpy(self.targets),
                "iteration": self.iteration,
                # exploration anneals on env_steps_total and the delay's
                # phase rides the update counter: a restored run keeps both
                "env_steps_total": self._total_env_steps,
                "update_count": self._update_count}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.targets = tree_from_numpy(state["targets"], self.device)
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("env_steps_total", 0)
        self._update_count = int(state.get("update_count", 0))


class DDPG(TD3):
    _config_cls = DDPGConfig
