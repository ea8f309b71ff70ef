"""IMPALA and APPO with V-trace (counterpart of ``ray_tpu/rl/impala.py``),
in the inline mode: the learner samples with its own policy (behaviour ==
target, so every rho is 1 up to rounding), then takes one clipped-Adam
step on the V-trace loss.

The JAX package runs V-trace as a reverse ``lax.scan`` inside the jitted
update; here it is a loop over T in reverse on [T, B] tensors, with the
same rho and c clips and no gradient through its targets.  The rollout is
PPO's (`ppo.make_rollout_fn`), so it takes the same draws (per step the
policy's sampling noise and the envs' reset draws) from the algorithm's
`torch.Generator` or as an argument.  The asynchronous actors
(``num_workers > 0``, `TrajectoryWorker` processes in the JAX package)
need the runtime's remote actors, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..device import resolve_device
from .algorithm import Algorithm
from .env import TorchEnv
from .learner import value_and_grad
from .policy import MLPPolicy
from .ppo import ClippedAdam, make_rollout_fn


@dataclasses.dataclass
class ImpalaConfig:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_envs: int = 64
    rollout_length: int = 64
    num_workers: int = 0          # async actors; 0 = inline sampling
    gamma: float = 0.99
    rho_bar: float = 1.0          # V-trace importance clip (rho)
    c_bar: float = 1.0            # V-trace trace-cutting clip (c)
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    lr: float = 5e-4
    max_grad_norm: float = 40.0
    hidden: tuple = (64, 64)
    # bound each policy forward of the rollout to this many envs
    env_chunk: Optional[int] = None
    seed: int = 0
    # None = the V-trace policy gradient (IMPALA); a float = PPO's clipped
    # surrogate on the V-trace advantages (APPO)
    clip_eps: Optional[float] = None
    # where the envs, the policy and the update run (None: the card)
    device: Any = None

    def build(self) -> "Impala":
        return Impala(self)


@dataclasses.dataclass
class APPOConfig(ImpalaConfig):
    """Asynchronous PPO: IMPALA with the PPO clip on the importance-ratio
    surrogate (``build()`` is inherited: APPO is an Impala
    configuration)."""
    clip_eps: Optional[float] = 0.2
    lr: float = 3e-4


@torch.no_grad()
def vtrace(behavior_logp, target_logp, values, last_value, rewards, dones,
           *, gamma: float, rho_bar: float, c_bar: float):
    """V-trace targets and policy-gradient advantages over [T, B] tensors,
    without gradient.  → (vs, pg_adv): ``vs`` the corrected value targets,
    ``pg_adv = rho_t * (r_t + gamma * vs_{t+1} - V_t)``."""
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_bar)
    c = torch.clamp(ratio, max=c_bar)
    nonterminal = 1.0 - dones.float()
    next_values = torch.cat([values[1:], last_value[None]])
    deltas = rho * (rewards + gamma * next_values * nonterminal - values)
    vs_minus_v = torch.empty_like(values)
    acc = torch.zeros_like(last_value)
    for t in reversed(range(values.shape[0])):
        acc = deltas[t] + gamma * nonterminal[t] * c[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    next_vs = torch.cat([vs[1:], last_value[None]])
    pg_adv = rho * (rewards + gamma * next_vs * nonterminal - values)
    return vs, pg_adv


_WORKERS = ("ImpalaConfig.num_workers > 0 needs the runtime's remote "
            "actors (TrajectoryWorker), which the port does not have yet "
            "(ROADMAP queue 1 item 10)")


class Impala(Algorithm):
    _config_cls = ImpalaConfig

    def __init__(self, config: ImpalaConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("ImpalaConfig.env required (an env factory)")
        if cfg.num_workers > 0:
            raise NotImplementedError(_WORKERS)
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        self.policy = MLPPolicy(self.env.observation_size,
                                self.env.action_size,
                                discrete=self.env.discrete,
                                hidden=cfg.hidden, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.params = self.policy.init(self.generator)
        self.optimizer = ClippedAdam(cfg.max_grad_norm, cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self._rollout = make_rollout_fn(self.env, self.policy, cfg.num_envs,
                                        cfg.rollout_length,
                                        env_chunk=cfg.env_chunk)
        self._init_episode_tracking(cfg.num_envs)

    # -- the iteration ------------------------------------------------------
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """The rollout with the behaviour log-probs; advances the envs.
        ``draws``: a list over steps of ``{"noise", "reset"}``.  → the
        [T, B, ...] batch with ``last_value`` [B]."""
        traj, self.env_states, self.obs, _, last_value = self._rollout(
            self.params, self.env_states, self.obs, (), self.generator,
            draws)
        return {"obs": traj["obs"], "action": traj["action"],
                "logp": traj["logp"], "reward": traj["reward"],
                "done": traj["done"], "last_value": last_value}

    def loss(self, params, batch):
        """The V-trace loss of a `collect` batch and its parts (with
        ``mean_rho``, ``vs`` and ``pg_adv``)."""
        cfg = self.config
        T, B = batch["reward"].shape
        logp, entropy, value = self.policy.log_prob(
            params, batch["obs"].reshape(T * B, -1),
            batch["action"].reshape((T * B,) if self.env.discrete
                                    else (T * B, -1)))
        logp, value = logp.reshape(T, B), value.reshape(T, B)
        vs, pg_adv = vtrace(batch["logp"], logp, value, batch["last_value"],
                            batch["reward"], batch["done"], gamma=cfg.gamma,
                            rho_bar=cfg.rho_bar, c_bar=cfg.c_bar)
        ratio = torch.exp(logp - batch["logp"])
        if cfg.clip_eps is not None:
            # APPO: the clipped surrogate, ratio against the behaviour
            # policy
            clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps,
                                  1.0 + cfg.clip_eps) * pg_adv
            pi_loss = -torch.mean(torch.minimum(ratio * pg_adv, clipped))
        else:
            pi_loss = -torch.mean(logp * pg_adv)
        vf_loss = 0.5 * torch.mean((vs - value) ** 2)
        ent = torch.mean(entropy)
        total = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * ent
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent, "mean_rho": ratio.mean(),
                       "vs": vs, "pg_adv": pg_adv}

    def learn(self, batch) -> Dict[str, torch.Tensor]:
        """One clipped-Adam step on the V-trace loss; → its scalar parts
        (tensors, not yet read)."""
        _, aux, grads = value_and_grad(self.loss, self.params, batch)
        self.optimizer.update(grads, self.opt_state, self.params)
        return {k: aux[k] for k in ("pi_loss", "vf_loss", "entropy",
                                    "mean_rho")}

    def training_step(self, draws=None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        batch = self.collect(draws)
        metrics = self.learn(batch)
        # the iteration's one read of the device
        values = torch.stack(list(metrics.values())).tolist()
        self._track_episodes(batch["reward"].cpu().numpy(),
                             batch["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        env_steps = cfg.num_envs * cfg.rollout_length
        out = dict(zip(metrics, values))
        out.update({"env_steps_this_iter": env_steps,
                    "env_steps_per_s": env_steps / dt,
                    "episode_reward_mean": self.episode_reward_mean()})
        return out

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": self.policy.get_weights(self.params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = self.policy.set_weights(self.params, state["params"])
        self.iteration = state.get("iteration", 0)
