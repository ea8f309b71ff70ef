"""Decentralized-DP PPO: every rank is a learner, no central SGD
(counterpart of ``ray_tpu/rl/ddppo.py``).

Each rank of a ``dp`` mesh rolls out its own ``num_envs`` envs, computes
GAE and runs PPO's epoch / minibatch SGD with its gradients averaged over
the learners before every apply, so the params stay the same on every
rank.  The metrics are averaged over the learners and ``reward_sum``
summed; every rank tracks the episodes of all learners' envs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..parallel.collectives import axis_index
from ..parallel.mesh import MeshSpec, axis_size, create_mesh
from .algorithm import Algorithm
from .policy import MLPPolicy
from .ppo import (ClippedAdam, PPOConfig, compute_gae, make_rollout_fn,
                  make_update_fn)


@dataclasses.dataclass
class DDPPOConfig(PPOConfig):
    num_learners: Optional[int] = None  # None → every rank of the group

    def build(self) -> "DDPPO":
        return DDPPO(self)


class DDPPO(Algorithm):
    """num_envs is PER LEARNER; global batch = learners*num_envs*rollout.

    The learners are the ranks of the process group (a one-rank group
    starts when there is none), or the ``dp`` axis of ``mesh`` when one is
    given: ranks that share a dp coordinate then run the same learner.
    The params come from ``seed`` and are the same on every rank; each
    learner's envs and draws come from its own generator."""

    _config_cls = DDPPOConfig

    def __init__(self, config: DDPPOConfig,
                 mesh: Optional[DeviceMesh] = None):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("DDPPOConfig.env required (an env factory)")
        if cfg.num_workers:
            raise ValueError(
                "DDPPO has no rollout-worker actors: every mesh device is "
                "a learner+sampler (set num_learners, not num_workers)")
        if (cfg.model or {}).get("use_lstm"):
            raise ValueError("use_lstm is not supported by DDPPO: its "
                             "per-device learners are feedforward-only "
                             "(use PPO's local path for recurrence)")
        self.device = resolve_device(cfg.device)
        if mesh is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = create_mesh(
                MeshSpec(dp=cfg.num_learners or world, fsdp=1),
                drop_trivial_axes=True,
                device="cuda" if self.device.type == "cuda" else "cpu")
        n = axis_size("dp", mesh)
        if cfg.num_learners not in (None, n):
            raise ValueError(f"num_learners={cfg.num_learners}: the mesh "
                             f"has {n} dp ranks")
        self.num_learners = n
        self.mesh = mesh
        self.rank = axis_index("dp", mesh)
        self.group = mesh.get_group("dp") if n > 1 else None

        self.env = cfg.env(device=self.device)
        self.policy = MLPPolicy(self.env.observation_size,
                                self.env.action_size,
                                discrete=self.env.discrete,
                                hidden=cfg.hidden, device=self.device)
        self.params = self.policy.init(
            torch.Generator(device=self.device).manual_seed(cfg.seed))
        # the learner's own stream of draws: envs, actions, shuffles
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(np.random.SeedSequence([cfg.seed, self.rank])
                .generate_state(1)[0]))
        self.optimizer = ClippedAdam(cfg.max_grad_norm, cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self._rollout = make_rollout_fn(self.env, self.policy, cfg.num_envs,
                                        cfg.rollout_length,
                                        env_chunk=cfg.env_chunk)
        self._update = make_update_fn(self.policy, self.optimizer, cfg,
                                      cfg.num_envs * cfg.rollout_length,
                                      group=self.group)
        self._init_episode_tracking(n * cfg.num_envs)

    def _gather_envs(self, x: torch.Tensor) -> torch.Tensor:
        """[T, num_envs] of every learner → [T, learners·num_envs], the
        learners' blocks in rank order."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.num_learners)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    # -- Trainable interface ------------------------------------------------
    def training_step(self, draws=None, perms=None) -> Dict[str, Any]:
        """One iteration on every learner.  ``draws`` / ``perms`` are this
        learner's, as PPO's `training_step` takes them."""
        cfg = self.config
        t0 = time.perf_counter()
        traj, self.env_states, self.obs, _, last_value = self._rollout(
            self.params, self.env_states, self.obs, None, self.generator,
            draws)
        adv, ret = compute_gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
        n = cfg.num_envs * cfg.rollout_length
        flat = {"obs": traj["obs"].reshape(n, -1),
                "action": traj["action"].reshape(
                    (n,) if self.env.discrete else (n, -1)),
                "logp": traj["logp"].reshape(n),
                "adv": adv.reshape(n), "ret": ret.reshape(n)}
        _, _, metrics = self._update(self.params, self.opt_state, flat,
                                     self.generator, perms)
        keys = list(metrics)
        values = torch.stack([metrics[k].float() for k in keys]
                             + [traj["reward"].sum().float()])
        if self.group is not None:
            dist.all_reduce(values, group=self.group)
            values[:-1] /= self.num_learners
        # the iteration's one read of the device
        values = values.tolist()
        rewards = self._gather_envs(traj["reward"].float())
        dones = self._gather_envs(traj["done"].to(torch.uint8))
        self._track_episodes(rewards.cpu().numpy(), dones.cpu().numpy())
        dt = time.perf_counter() - t0
        env_steps = self.num_learners * n
        out = dict(zip(keys + ["reward_sum"], values))
        out.update({
            "env_steps_this_iter": env_steps,
            "env_steps_per_s": env_steps / dt,
            "episode_reward_mean": self.episode_reward_mean(),
            "num_learners": self.num_learners,
        })
        return out

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": self.policy.get_weights(self.params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = self.policy.set_weights(self.params, state["params"])
        self.iteration = state.get("iteration", 0)
