"""SAC: maximum-entropy continuous control (counterpart of
``ray_tpu/rl/sac.py``): a squashed-Gaussian actor, twin Q critics, Polyak
targets and a temperature ``log_alpha`` tuned toward the target entropy
``-act_dim``, with a replay buffer on the card (`replay`).

One Adam (`ppo.Adam`) steps the whole params tree (actor, critics and
``log_alpha``) on the sum of the three losses, as the JAX package's
single optax state does; each loss reaches only its own leaves.  Draws
come from the algorithm's `torch.Generator` or as arguments:
``collect(draws)`` takes per step the action ``noise`` [N, A] and the
envs' ``reset`` draws; ``learn(draws)`` per update the sample's draw, the
critic target's action noise ``next_noise`` [B, A] and the actor loss's
``pi_noise`` [B, A].
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import replay
from .algorithm import Algorithm
from .env import TorchEnv
from .learner import polyak, value_and_grad
from .policy import (mlp_apply, mlp_init, mlp_shapes, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import Adam

_LOG_STD_MIN, _LOG_STD_MAX = -10.0, 2.0
_LOG_2PI = math.log(2 * math.pi)


def _mlp_apply(params, x):
    # relu torso (tanh saturates under the large unnormalized Q targets of
    # cost-shaped envs)
    return mlp_apply(params, x, activation=torch.relu)


@dataclasses.dataclass
class SACConfig:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_envs: int = 16
    rollout_steps: int = 16
    buffer_capacity: int = 100_000
    batch_size: int = 256
    num_updates: int = 16
    gamma: float = 0.99
    lr: float = 3e-4
    tau: float = 0.005             # Polyak target-average rate
    init_alpha: float = 0.2
    autotune_alpha: bool = True    # gradient-tune log(alpha) to target entropy
    prioritized_replay: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    learn_start: int = 1_000
    hidden: tuple = (128, 128)
    seed: int = 0
    # where the env, the buffer and the networks live (None: the card)
    device: Any = None

    def build(self) -> "SAC":
        return SAC(self)


class SAC(Algorithm):
    _config_cls = SACConfig

    def __init__(self, config: SACConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("SACConfig.env required (an env factory)")
        self.device = dev = resolve_device(cfg.device)
        self.env = cfg.env(device=dev)
        if self.env.discrete:
            raise ValueError("SAC requires a continuous-action env")
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        self.act_dim = act_dim
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.params = {name: mlp_init(self.generator, sizes)
                       for name, sizes in self._sizes().items()}
        self.params["log_alpha"] = torch.tensor(math.log(cfg.init_alpha),
                                                device=dev)
        self.target_q = tree_map(torch.clone, self._critics(self.params))
        self.optimizer = Adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
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
        self.target_entropy = -float(act_dim)
        self._init_episode_tracking(cfg.num_envs)

    def _sizes(self):
        obs_dim, act_dim = self.env.observation_size, self.act_dim
        h = tuple(self.config.hidden)
        # actor: obs → (mean, log_std); twin critics: [obs, act] → q
        return {"actor": (obs_dim,) + h + (2 * act_dim,),
                "q1": (obs_dim + act_dim,) + h + (1,),
                "q2": (obs_dim + act_dim,) + h + (1,)}

    def param_shapes(self):
        """The params tree's shapes (`convert.policy_params_from_numpy`);
        ``log_alpha`` is 0-d."""
        shapes = {name: mlp_shapes(s) for name, s in self._sizes().items()}
        shapes["log_alpha"] = ()
        return shapes

    @staticmethod
    def _critics(params):
        return {"q1": params["q1"], "q2": params["q2"]}

    # -- policy -------------------------------------------------------------
    def _sample_action(self, actor_params, obs, noise):
        """Squashed Gaussian, ``a = high * tanh(u)``, ``u = mean + std *
        noise``; → (action, logp) with the whole log-det-Jacobian of
        ``high * tanh``, the ``log|high|`` constant included (it does not
        cancel in the temperature loss, whose fixed point is mean(logp) =
        -target_entropy).  ``log(1 - tanh(u)^2)`` in its softplus form,
        finite at any ``|u|``."""
        high = self.env.action_high
        mean, log_std = _mlp_apply(actor_params, obs).chunk(2, dim=-1)
        log_std = torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)
        std = torch.exp(log_std)
        u = mean + std * noise
        a = high * torch.tanh(u)
        gauss_logp = torch.sum(-((u - mean) ** 2) / (2 * std ** 2) - log_std
                               - 0.5 * _LOG_2PI, dim=-1)
        squash = torch.sum(2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u)),
                           dim=-1) + self.act_dim * math.log(high)
        return a, gauss_logp - squash

    def _q(self, q_params, obs, act):
        return _mlp_apply(q_params, torch.cat([obs, act], dim=-1))[..., 0]

    # -- the iteration ------------------------------------------------------
    def _noise(self, n: int) -> torch.Tensor:
        return torch.randn(n, self.act_dim, generator=self.generator,
                           device=self.device)

    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """``rollout_steps`` steps of every env, actions sampled from the
        squashed Gaussian, into the buffer.  ``draws``: a list over steps
        of ``{"noise": [N, A], "reset": ...}``.  → the trajectory's
        ``reward`` and ``done`` [T, N]."""
        cfg, n = self.config, self.config.num_envs
        add_fn = self._replay_ops[1]
        obs, rewards, dones = self.obs, [], []
        for t in range(cfg.rollout_steps):
            d = draws[t] if draws is not None else None
            noise = d["noise"] if d is not None else self._noise(n)
            action, _ = self._sample_action(self.params["actor"], obs, noise)
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

    def _loss(self, p, batch, weights, next_noise, pi_noise):
        cfg = self.config
        alpha = torch.exp(p["log_alpha"])
        with torch.no_grad():
            # the critic target from the current actor and the target Qs
            next_a, next_logp = self._sample_action(
                p["actor"], batch["next_obs"], next_noise)
            tq = torch.minimum(
                self._q(self.target_q["q1"], batch["next_obs"], next_a),
                self._q(self.target_q["q2"], batch["next_obs"], next_a))
            target = batch["reward"] + cfg.gamma * \
                (1.0 - batch["done"]) * (tq - alpha * next_logp)
        q1 = self._q(p["q1"], batch["obs"], batch["action"])
        q2 = self._q(p["q2"], batch["obs"], batch["action"])
        td1, td2 = q1 - target, q2 - target
        critic_loss = torch.mean(weights * td1 ** 2) \
            + torch.mean(weights * td2 ** 2)
        # actor: maximize E[min Q - alpha * logp] through fresh actions,
        # the critics held fixed
        a, logp = self._sample_action(p["actor"], batch["obs"], pi_noise)
        fixed = tree_map(lambda x: x.detach(), self._critics(p))
        q_pi = torch.minimum(self._q(fixed["q1"], batch["obs"], a),
                             self._q(fixed["q2"], batch["obs"], a))
        actor_loss = torch.mean(alpha.detach() * logp - q_pi)
        # temperature: match the target entropy
        if cfg.autotune_alpha:
            alpha_loss = -torch.mean(p["log_alpha"] * (
                logp + self.target_entropy).detach())
        else:
            alpha_loss = 0.0
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": -torch.mean(logp),
                       "td_abs": 0.5 * (torch.abs(td1) + torch.abs(td2))}

    def learn(self, draws=None) -> Dict[str, torch.Tensor]:
        """``num_updates`` updates behind the learn-start gate.  ``draws``:
        a list over updates of the sample's draw with ``{"next_noise",
        "pi_noise"}`` [B, A].  → the last update's critic_loss,
        actor_loss, alpha and entropy (below the gate: zeros and the
        current alpha)."""
        cfg = self.config
        if self.buffer["size"] < cfg.learn_start:
            zero = torch.zeros((), device=self.device)
            return {"critic_loss": zero, "actor_loss": zero,
                    "alpha": torch.exp(self.params["log_alpha"]),
                    "entropy": zero}
        sample_fn, update_pri = self._replay_ops[2], self._replay_ops[3]
        aux = None
        for k in range(cfg.num_updates):
            d = draws[k] if draws is not None else None
            batch, idx, weights = sample_fn(self.buffer, cfg.batch_size,
                                            self.generator, d)
            b = cfg.batch_size
            next_noise = d["next_noise"] if d is not None else self._noise(b)
            pi_noise = d["pi_noise"] if d is not None else self._noise(b)
            _, aux, grads = value_and_grad(self._loss, self.params, batch,
                                           weights, next_noise, pi_noise)
            update_pri(self.buffer, idx, aux.pop("td_abs"))
            self.optimizer.update(grads, self.opt_state, self.params)
            polyak(self.target_q, self._critics(self.params), cfg.tau)
        return aux

    def training_step(self, draws=None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(None if draws is None else draws["collect"])
        metrics = self.learn(None if draws is None else draws["updates"])
        metrics["step_reward_mean"] = traj["reward"].mean()
        # the iteration's one read of the device
        out = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        env_steps = cfg.num_envs * cfg.rollout_steps
        out.update({"buffer_size": float(self.buffer["size"]),
                    "env_steps_this_iter": env_steps,
                    "env_steps_per_s": env_steps / dt,
                    "episode_reward_mean": self.episode_reward_mean()})
        return out

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "target_q": tree_to_numpy(self.target_q),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.target_q = tree_from_numpy(state["target_q"], self.device)
        self.iteration = state.get("iteration", 0)
