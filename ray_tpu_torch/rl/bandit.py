"""Contextual bandits: LinUCB and linear Thompson sampling (counterpart
of ``ray_tpu/rl/bandit.py``).

Per-arm ridge posteriors live as one stacked pair on the device, the Gram
matrices ``A`` [K, d, d] and the responses ``b`` [K, d].  An iteration is
``steps_per_iter`` sequential interactions (select an arm, observe its
reward, a rank-1 update of that arm's posterior in place); the JAX package
compiles them into one ``lax.scan``, here they are a loop of small batched
ops.  Nothing in the loop reads the device: the solves and the Cholesky
factorization use the ``_ex`` forms without their error check (which
would synchronize on every call), the chosen arm stays a device tensor
that indexes the update, and the rewards and regrets are written into
preallocated [T] tensors read once at the end.

Every random value of an iteration is drawn up front, in bulk, from the
algorithm's `torch.Generator`, or given as ``draws`` (``{"context": [T,
d], "noise": [T], "z": [T, K, d]}``, standard normal; ``z`` for Thompson
sampling only), so tests can give both packages the same ones.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .algorithm import Algorithm
from .policy import tree_to_numpy


class ContextBandit:
    """Contextual-bandit interface: contexts in, one-step rewards out,
    each from its standard normal draws (bandit episodes are single steps,
    so this is narrower than `env.TorchEnv`)."""

    context_size: int
    num_arms: int

    def context(self, z: torch.Tensor) -> torch.Tensor:
        """A context [d] from a standard normal draw [d]."""
        raise NotImplementedError

    def reward(self, context: torch.Tensor, arm: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def best_expected(self, context: torch.Tensor) -> torch.Tensor:
        """The optimal arm's expected reward (for regret accounting)."""
        raise NotImplementedError


class LinearContextBandit(ContextBandit):
    """Rewards linear in the context, per-arm unit weight vectors, plus
    Gaussian noise: the standard LinUCB testbed.  The weights are drawn
    from a `torch.Generator` seeded with ``seed`` (the JAX package draws
    them from ``PRNGKey(seed)``, another stream), or given as
    ``weights`` [K, d]."""

    def __init__(self, context_size: int = 8, num_arms: int = 4,
                 noise: float = 0.1, seed: int = 0, weights=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.context_size = context_size
        self.num_arms = num_arms
        self.noise = noise
        if weights is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            w = torch.randn(num_arms, context_size, generator=gen,
                            device=self.device)
            self.weights = w / torch.linalg.vector_norm(w, dim=1,
                                                        keepdim=True)
        else:
            self.weights = torch.tensor(np.asarray(weights),
                                        dtype=torch.float32,
                                        device=self.device)

    def context(self, z):
        return z / torch.linalg.vector_norm(z)

    def reward(self, context, arm, noise):
        return self.arm_weights(arm) @ context + self.noise * noise

    def arm_weights(self, arm: torch.Tensor) -> torch.Tensor:
        """The weights [d] of ``arm`` (a 0-d tensor), gathered on the
        device: a 0-d index tensor would be read back to the host."""
        return self.weights[arm.view(1)][0]

    def best_expected(self, context):
        return (self.weights @ context).max()


@dataclasses.dataclass
class LinUCBConfig:
    # bandit factory, called as env(device=...)
    env: Optional[Callable[..., ContextBandit]] = None
    alpha: float = 1.0             # exploration bonus scale
    lam: float = 1.0               # ridge prior on A
    steps_per_iter: int = 512
    seed: int = 0
    # where the posteriors live (None: the card)
    device: Any = None

    def build(self) -> "LinUCB":
        return LinUCB(self)


@dataclasses.dataclass
class LinTSConfig(LinUCBConfig):
    sigma: float = 0.5             # posterior sample scale

    def build(self) -> "LinTS":    # type: ignore[override]
        return LinTS(self)


def _select_ucb(A, b, x, alpha, z):
    """The UCB arm: argmax_k theta_k·x + alpha * sqrt(x' A_k^-1 x), both
    solves in one call (x and b_k as two right-hand sides)."""
    rhs = torch.stack([x.expand_as(b), b], dim=-1)         # [K, d, 2]
    sol, _ = torch.linalg.solve_ex(A, rhs)
    ainv_x, theta = sol[..., 0], sol[..., 1]               # [K, d] each
    ucb = theta @ x + alpha * torch.sqrt(ainv_x @ x)
    return torch.argmax(ucb)


def _select_ts(A, b, x, sigma, z):
    """The Thompson arm: theta_k ~ N(A_k^-1 b_k, sigma^2 A_k^-1) through
    the Cholesky factor of A_k (L L' = A, so solve(L', z) is a N(0, A^-1)
    draw), then the argmax payoff."""
    theta, _ = torch.linalg.solve_ex(A, b[..., None])
    L, _ = torch.linalg.cholesky_ex(A)
    pert = torch.linalg.solve_triangular(L.mT, z[..., None], upper=True)
    return torch.argmax((theta + sigma * pert)[..., 0] @ x)


class LinUCB(Algorithm):
    """Closed-form contextual bandit; ``train()`` runs ``steps_per_iter``
    interactions."""

    _config_cls = LinUCBConfig
    _select = staticmethod(_select_ucb)

    def __init__(self, config):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError(f"{type(cfg).__name__}.env required "
                             "(a ContextBandit factory)")
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        K, d = self.env.num_arms, self.env.context_size
        self.A = torch.eye(d, device=self.device).repeat(K, 1, 1) * cfg.lam
        self.b = torch.zeros(K, d, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def _explore_param(self) -> float:
        return self.config.alpha

    def draw(self) -> Dict[str, torch.Tensor]:
        """An iteration's draws, in bulk."""
        T, K = self.config.steps_per_iter, self.env.num_arms
        d = self.env.context_size

        def normal(*shape):
            return torch.randn(shape, generator=self.generator,
                               device=self.device)
        draws = {"context": normal(T, d), "noise": normal(T)}
        if self._select is _select_ts:
            draws["z"] = normal(T, K, d)
        return draws

    @torch.no_grad()
    def run(self, draws=None):
        """``steps_per_iter`` interactions, updating ``A`` and ``b`` in
        place; → (rewards [T], regrets [T], arms [T]) on the device."""
        env, T = self.env, self.config.steps_per_iter
        draws = self.draw() if draws is None else draws
        param = self._explore_param()
        rewards = torch.empty(T, device=self.device)
        regrets = torch.empty(T, device=self.device)
        arms = torch.empty(T, dtype=torch.long, device=self.device)
        weights = getattr(env, "weights", None)
        for t in range(T):
            x = env.context(draws["context"][t])
            arm = type(self)._select(self.A, self.b, x, param,
                                     draws["z"][t] if "z" in draws
                                     else None)
            r = env.reward(x, arm, draws["noise"][t])
            # the rank-1 posterior update of the chosen arm only
            at = arm.view(1)
            self.A.index_add_(0, at, torch.outer(x, x)[None])
            self.b.index_add_(0, at, (r * x)[None])
            rewards[t] = r
            regrets[t] = env.best_expected(x) - (
                env.arm_weights(arm) @ x if weights is not None else r)
            arms[t] = arm
        return rewards, regrets, arms

    def training_step(self, draws=None) -> Dict[str, Any]:
        t0 = time.perf_counter()
        rewards, regrets, _ = self.run(draws)
        # the iteration's one read of the device
        mean_r, mean_regret = torch.stack([rewards.mean(),
                                           regrets.mean()]).tolist()
        dt = time.perf_counter() - t0
        n = self.config.steps_per_iter
        return {"episode_reward_mean": mean_r,
                "mean_regret": mean_regret,
                "env_steps_this_iter": n,
                "env_steps_per_s": n / dt}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {**tree_to_numpy({"A": self.A, "b": self.b}),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.A = torch.tensor(np.asarray(state["A"]), device=self.device)
        self.b = torch.tensor(np.asarray(state["b"]), device=self.device)
        self.iteration = state.get("iteration", 0)


class LinTS(LinUCB):
    _config_cls = LinTSConfig
    _select = staticmethod(_select_ts)

    def _explore_param(self) -> float:
        return self.config.sigma
