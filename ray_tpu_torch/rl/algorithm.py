"""Algorithm: the Trainable-style RL entry point (counterpart of
``ray_tpu/rl/algorithm.py``): `train()` drives `training_step`, results
carry the standard keys, checkpoints go through `air.Checkpoint`."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from ..air.checkpoint import Checkpoint


def track_episode_returns(ep_returns: np.ndarray, done_returns: list,
                          rewards: np.ndarray,
                          dones: np.ndarray) -> None:
    """The reward / done episode bookkeeping: accumulate per-env returns
    over a [T, B] trajectory, bank each finished episode, zero its
    accumulator."""
    for t in range(rewards.shape[0]):
        ep_returns += rewards[t]
        finished = dones[t].astype(bool)
        if finished.any():
            done_returns.extend(ep_returns[finished].tolist())
            ep_returns[finished] = 0.0


class Algorithm:
    _config_cls = None

    def __init__(self, config):
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0

    # -- episode accounting (host side, once an iteration) -------------------
    def _init_episode_tracking(self, num_envs: int) -> None:
        self._ep_returns = np.zeros(num_envs)
        self._ep_done_returns: list = []

    def _track_episodes(self, rewards: np.ndarray, dones: np.ndarray):
        """Accumulate per-env returns from a [T, B] reward/done trajectory,
        banking each finished episode's return."""
        track_episode_returns(self._ep_returns, self._ep_done_returns,
                              rewards, dones)

    def episode_reward_mean(self) -> float:
        """Mean return of the last 100 finished episodes (NaN before any)."""
        if not getattr(self, "_ep_done_returns", None):
            return float("nan")
        return float(np.mean(self._ep_done_returns[-100:]))

    # -- Trainable protocol -------------------------------------------------
    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        result = self.training_step()
        self._total_env_steps += result.get("env_steps_this_iter", 0)
        result.setdefault("training_iteration", self.iteration)
        result["env_steps_total"] = self._total_env_steps
        return result

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def stop(self) -> None:
        """Release what the algorithm holds (rollout workers, once the
        port has them)."""

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def save(self) -> Checkpoint:
        return Checkpoint.from_dict(self.get_state())

    def restore(self, checkpoint: Checkpoint) -> None:
        self.set_state(checkpoint.to_dict())

    # -- Tune integration ---------------------------------------------------
    @classmethod
    def to_trainable(cls, base_config) -> Callable:
        """A Tune function-trainable: needs ``air.session`` and Tune, which
        come with the distributed pieces (ROADMAP queue 1 item 10)."""
        raise NotImplementedError(
            "Algorithm.to_trainable needs air.session and Tune, which the "
            "port does not have yet (ROADMAP queue 1 item 10)")
