"""Evolution strategies, ES and ARS (counterpart of ``ray_tpu/rl/es.py``):
perturb the policy, evaluate each perturbation's episodes, step along the
returns-weighted noise.

The JAX package evaluates each antithetic pair as a task (on the driver,
or across the cluster's workers), two jitted 200-step episode batches a
pair, one after the other.  Here an iteration evaluates all 2n perturbed
policies at once: their flat vectors stacked [2n, params], each layer one
batched product over the policies (`multi_agent.agent_view`), so the
rollout takes ``horizon`` steps however many pairs there are.

The noise is numpy's, as in the JAX package: pair ``i`` of iteration ``k``
draws ``standard_normal`` from ``SeedSequence([seed, k, i])``, so given the
same returns the update is bitwise the JAX package's.  Both members of a
pair see the same episodes: their draws (the envs' reset draws, at the
start and at every step) come from one `torch.Generator` seeded with the
integer the JAX package turns into that pair's ``PRNGKey``
(``seq.generate_state(1)[0]``), or as an argument.  The cluster fan-out
(``num_workers > 0``) needs the runtime's remote tasks, which the port
does not have yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .algorithm import Algorithm
from .env import TorchEnv
from .multi_agent import agent_view
from .policy import mlp_init, mlp_shapes, tree_leaves

_WORKERS = ("ESConfig.num_workers > 0 evaluates the perturbations as "
            "cluster tasks (ray_tpu.remote), which the port does not have "
            "yet (ROADMAP queue 1 item 10)")


def _unflatten(flat: torch.Tensor, shapes: List[Dict[str, tuple]]):
    """Stacked flat vectors [M, n] → an mlp stack with a leading policy axis
    on every leaf (``[M, in, out]`` weights, ``[M, 1, out]`` biases), the
    leaves in the JAX package's flatten order (per layer ``b``, ``w``)."""
    out, off = [], 0
    for layer in shapes:
        leaf = {}
        for k in sorted(layer):
            size = math.prod(layer[k])
            leaf[k] = flat[:, off:off + size].reshape(
                (flat.shape[0],) + layer[k])
            off += size
        out.append(leaf)
    return agent_view(out)


def eval_draws(env: TorchEnv, n_episodes: int, horizon: int,
               gen: torch.Generator) -> Dict[str, Any]:
    """One evaluation's draws: ``{"reset": the env's reset draws for
    n_episodes, "steps": its reset draws for each step, [horizon,
    n_episodes, ...]}``."""
    steps = env.reset_draws(horizon * n_episodes, gen)
    return {"reset": env.reset_draws(n_episodes, gen),
            "steps": {k: v.reshape((horizon, n_episodes) + v.shape[1:])
                      for k, v in steps.items()}}


def make_eval_fn(env: TorchEnv, n_episodes: int, horizon: int):
    """→ ``evaluate(params, draws) -> [M] mean undiscounted returns`` of M
    policies under the DETERMINISTIC policy (argmax, or ``action_high *
    tanh`` for a continuous env), each over ``n_episodes`` episodes of
    ``horizon`` steps.  ``params`` is an mlp stack with a leading policy
    axis (`_unflatten`); ``draws`` the `eval_draws` of each policy,
    stacked on a leading [M] axis."""

    @torch.no_grad()
    def evaluate(params, draws):
        m = params[0]["w"].shape[0]
        n = m * n_episodes

        def rows(d, lead=()):
            return {k: v.reshape(lead + (n,) + v.shape[len(lead) + 2:])
                    for k, v in d.items()}

        steps = rows({k: v.transpose(0, 1) for k, v in
                      draws["steps"].items()}, (horizon,))
        states, obs = env.reset_given(rows(draws["reset"]))
        ret = torch.zeros(n, device=obs.device)
        done = torch.zeros(n, device=obs.device)
        for t in range(horizon):
            x = obs.reshape(m, n_episodes, -1)
            for layer in params[:-1]:
                x = torch.tanh(x @ layer["w"] + layer["b"])
            out = (x @ params[-1]["w"] + params[-1]["b"]).reshape(n, -1)
            action = (torch.argmax(out, dim=-1) if env.discrete
                      else env.action_high * torch.tanh(out))
            states, obs, reward, step_done = env.step_given(
                states, action, {k: v[t] for k, v in steps.items()})
            ret = ret + reward * (1.0 - done)
            done = torch.maximum(done, step_done.float())
        return ret.reshape(m, n_episodes).mean(-1)

    return evaluate


@dataclasses.dataclass
class ESConfig:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_perturbations: int = 16    # antithetic PAIRS per iteration
    sigma: float = 0.1             # perturbation stddev
    lr: float = 0.05
    episodes_per_eval: int = 4
    horizon: int = 200
    num_workers: int = 0           # 0 = evaluate inline
    hidden: tuple = (32, 32)
    seed: int = 0
    # where the envs and the policies run (None: the card)
    device: Any = None

    def build(self) -> "ES":
        return ES(self)


def _pair_seed(seed: List[int]) -> int:
    """The integer the JAX package makes pair ``seed``'s PRNGKey from."""
    return int(np.random.SeedSequence(seed).generate_state(1)[0])


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory without
    blocking, so the copy is not a sync."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _noise(seed: List[int], n: int) -> np.ndarray:
    return np.random.default_rng(np.random.SeedSequence(seed)) \
        .standard_normal(n, dtype=np.float32)


class ES(Algorithm):
    _config_cls = ESConfig

    def __init__(self, config: ESConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("ESConfig.env required (an env factory)")
        if cfg.num_workers > 0:
            raise NotImplementedError(_WORKERS)
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        sizes = ((self.env.observation_size,) + tuple(cfg.hidden)
                 + (self.env.action_size,))
        self._shapes = mlp_shapes(sizes)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.flat = torch.cat([x.reshape(-1) for x in
                               tree_leaves(mlp_init(gen, sizes))])
        self._eval = make_eval_fn(self.env, cfg.episodes_per_eval,
                                  cfg.horizon)
        self._iter_seed = cfg.seed

    def param_shapes(self):
        """The flat vector's shape (`convert.policy_params_from_numpy`)."""
        return tuple(self.flat.shape)

    def _draws(self, seed: int) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return eval_draws(self.env, self.config.episodes_per_eval,
                          self.config.horizon, gen)

    def evaluate_flat(self, flats: torch.Tensor, draws: List[Dict[str, Any]]
                      ) -> torch.Tensor:
        """Mean returns [M] of the flat vectors ``flats`` [M, n], policy
        ``m`` over the episodes of ``draws[m]``."""
        stacked = {part: {k: torch.stack([d[part][k] for d in draws])
                          for k in draws[0][part]}
                   for part in ("reset", "steps")}
        return self._eval(_unflatten(flats, self._shapes), stacked)

    # -- shared perturbation fan-out (ES and ARS) ---------------------------
    def _evaluate_directions(self, draws=None):
        """Advance the noise stream one iteration and evaluate every
        antithetic pair, all 2n policies in one batch.  ``draws``: a list
        over pairs of `eval_draws` (else each pair's generator).
        → (seeds, noise [n, params] numpy, r_pos, r_neg)."""
        cfg = self.config
        self._iter_seed += 1
        seeds = [[cfg.seed, self._iter_seed, i]
                 for i in range(cfg.num_perturbations)]
        eps_np = np.stack([_noise(s, self.flat.shape[0]) for s in seeds])
        eps = _upload(eps_np, self.device)
        if draws is None:
            draws = [self._draws(_pair_seed(s)) for s in seeds]
        flats = torch.cat([self.flat + cfg.sigma * eps,
                           self.flat - cfg.sigma * eps])
        # float64 on the host, as the JAX package's per-pair floats: the
        # ranks and ARS's return std are taken from these
        returns = self.evaluate_flat(flats, draws + draws).cpu().numpy() \
            .astype(np.float64)
        n = len(seeds)
        return seeds, eps_np, returns[:n], returns[n:]

    def _mean_return(self, draws=None) -> float:
        """The updated policy's mean return over the episodes of the
        iteration's seed (the JAX package's ``PRNGKey(iteration seed)``)."""
        if draws is None:
            draws = self._draws(self._iter_seed)
        return float(self.evaluate_flat(self.flat[None], [draws])[0])

    # -- one ES iteration ---------------------------------------------------
    def training_step(self, draws=None) -> Dict[str, Any]:
        """``draws``: ``{"pairs": [...], "final": ...}`` (tests), else the
        generators."""
        cfg = self.config
        t0 = time.perf_counter()
        seeds, eps, r_pos, r_neg = self._evaluate_directions(
            None if draws is None else draws["pairs"])
        # centered-rank normalization over the 2n evaluations (the
        # public ES recipe: robust to return scale)
        all_r = np.concatenate([r_pos, r_neg])
        ranks = np.empty_like(all_r)
        ranks[np.argsort(all_r)] = np.arange(all_r.size)
        ranks = ranks / (all_r.size - 1) - 0.5
        w = ranks[:len(r_pos)] - ranks[len(r_pos):]

        grad = np.zeros(self.flat.shape[0], dtype=np.float32)
        for wi, e in zip(w, eps):
            grad += wi * e
        grad /= (len(seeds) * cfg.sigma)
        self.flat = self.flat + cfg.lr * _upload(grad, self.device)

        dt = time.perf_counter() - t0
        episodes = 2 * len(seeds) * cfg.episodes_per_eval
        return {"episode_reward_mean": self._mean_return(
                    None if draws is None else draws["final"]),
                "perturbations": len(seeds),
                "env_steps_this_iter": episodes * cfg.horizon,
                "env_steps_per_s": episodes * cfg.horizon / dt}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"flat": self.flat.cpu().numpy().copy(),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.flat = torch.tensor(np.asarray(state["flat"], np.float32),
                                 device=self.device)
        self.iteration = state.get("iteration", 0)
        # resume the noise stream where it left off: replaying seeds
        # already trained on would break the gradient estimate's
        # independence assumption
        self._iter_seed = self.config.seed + self.iteration


# ---------------------------------------------------------------------------
# ARS: Augmented Random Search (the same perturbations as ES with three
# changes from the public ARS recipe: only the top-k directions by
# max(r+, r-) contribute, the step is normalized by the std of the selected
# returns, and the returns are not rank-normalized).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ARSConfig(ESConfig):
    top_k: int = 0                 # 0 → use all directions (vanilla BRS)
    sigma: float = 0.05
    lr: float = 0.02

    def build(self) -> "ARS":      # type: ignore[override]
        return ARS(self)


class ARS(ES):
    _config_cls = ARSConfig

    def training_step(self, draws=None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        seeds, eps, r_pos, r_neg = self._evaluate_directions(
            None if draws is None else draws["pairs"])
        # top-k directions by best-of-pair return (ARS v1-t / v2-t)
        k = cfg.top_k or len(seeds)
        k = min(k, len(seeds))
        order = np.argsort(-np.maximum(r_pos, r_neg))[:k]
        used = np.concatenate([r_pos[order], r_neg[order]])
        sigma_r = float(used.std()) or 1.0

        grad = np.zeros(self.flat.shape[0], dtype=np.float32)
        for i in order:
            grad += (r_pos[i] - r_neg[i]) * eps[i]
        self.flat = self.flat + (cfg.lr / (k * sigma_r)) * _upload(
            grad, self.device)

        dt = time.perf_counter() - t0
        episodes = 2 * len(seeds) * cfg.episodes_per_eval
        return {"episode_reward_mean": self._mean_return(
                    None if draws is None else draws["final"]),
                "perturbations": len(seeds), "top_k": k,
                "return_std": sigma_r,
                "env_steps_this_iter": episodes * cfg.horizon,
                "env_steps_per_s": episodes * cfg.horizon / dt}
