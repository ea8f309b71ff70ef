"""Vanilla policy gradient, REINFORCE (counterpart of ``ray_tpu/rl/pg.py``):
the loss is ``-logp * discounted return``, no critic in the loss, no
clipping, one gradient step on the whole batch an iteration.  It shares
PPO's rollout, connectors and optimizer (optax's global-norm clip and
Adam, `ppo.ClippedAdam`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .learner import value_and_grad
from .ppo import PPO, PPOConfig


@dataclasses.dataclass
class PGConfig(PPOConfig):
    lr: float = 4e-3
    entropy_coeff: float = 0.0
    normalize_advantages: bool = True

    def build(self) -> "PG":       # type: ignore[override]
        return PG(self)


def _returns_to_go(rewards: torch.Tensor, dones: torch.Tensor,
                   gamma: float) -> torch.Tensor:
    """[T, B] rewards and dones → [T, B] discounted returns, zero-
    bootstrapped at episode ends and at the rollout's truncation (no
    critic exists to bootstrap with)."""
    rets = torch.empty_like(rewards)
    ret = torch.zeros_like(rewards[0])
    not_done = 1.0 - dones.to(rewards.dtype)
    for t in reversed(range(rewards.shape[0])):
        ret = rewards[t] + gamma * ret * not_done[t]
        rets[t] = ret
    return rets


class PG(PPO):
    _config_cls = PGConfig

    def __init__(self, config: PGConfig):
        if (config.model or {}).get("use_lstm"):
            raise ValueError("PG does not support use_lstm; use PPO")
        if config.num_workers > 0:
            # rollout workers ship GAE advantages computed against the
            # value head, which PG's loss never trains
            raise ValueError("PG does not support num_workers > 0: "
                             "rollout workers compute critic-based GAE "
                             "advantages and PG trains no critic; use "
                             "the inline path (num_workers=0) or PPO")
        super().__init__(config)
        if self._recurrent:
            raise ValueError("PG does not support use_lstm; use PPO")

    def collect(self, draws=None) -> Dict[str, Any]:
        """The rollout and the returns-to-go; → the flat batch (``obs``,
        ``action``, ``adv`` = the return) with the trajectory's ``reward``
        and ``done`` [T, N]."""
        cfg = self.config
        (traj, self.env_states, self.obs, self.conn_state,
         _last_value) = self._rollout(self.params, self.env_states, self.obs,
                                      self.conn_state, self.generator, draws)
        ret = _returns_to_go(traj["reward"], traj["done"], cfg.gamma)
        n = cfg.num_envs * cfg.rollout_length
        batch = {"obs": traj["obs"].reshape(n, -1),
                 "action": traj["action"].reshape(
                     (n,) if self.env.discrete else (n, -1)),
                 "adv": ret.reshape(n)}
        return {"batch": batch, "reward": traj["reward"],
                "done": traj["done"]}

    def _loss(self, params, batch):
        cfg = self.config
        logp, entropy, _value = self.policy.log_prob(params, batch["obs"],
                                                     batch["action"])
        adv = batch["adv"]
        if cfg.normalize_advantages:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg_loss = -(logp * adv).mean()
        ent = entropy.mean()
        return pg_loss - cfg.entropy_coeff * ent, {"pg_loss": pg_loss,
                                                   "entropy": ent}

    def learn(self, collected: Dict[str, Any], perms=None
              ) -> Dict[str, torch.Tensor]:
        """One step on the whole batch; → pg_loss, entropy, total_loss
        (tensors).  ``perms`` is unused: PG does not shuffle."""
        loss, metrics, grads = value_and_grad(self._loss, self.params,
                                              collected["batch"])
        self.optimizer.update(grads, self.opt_state, self.params)
        metrics["total_loss"] = loss
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["algo"] = "PG"
        return state
