"""PPO: rollout, GAE and the clipped-surrogate update (counterpart of
``ray_tpu/rl/ppo.py``).

The JAX package compiles the whole iteration into one program (a scan over
env steps, a reverse scan for GAE, a nested scan for the epochs and
minibatches).  Here the same steps run as PyTorch ops on the card, every
env at once: the rollout loops over T with no read of the device inside a
step, GAE loops over T in reverse, and the update loops over epochs and
minibatches.  The iteration reads the device once, for its metrics and the
episode bookkeeping.

Randomness comes from the algorithm's `torch.Generator`.  The rollout also
takes its draws (the policy's sampling noise and the envs' reset draws, per
step) and the update its permutations as arguments, so tests can give both
packages the same ones.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(lr))`` written out (`ClippedAdam`): optax scales the gradients by
``max_norm / norm`` only where ``norm >= max_norm``, and
`torch.nn.utils.clip_grad_norm_` divides by ``norm + 1e-6``, so the torch
utility would not give the same steps.  Advantages are normalized with the
population std, as ``jnp.std`` computes it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .algorithm import Algorithm
from .catalog import build_policy
from .connectors import ConnectorPipeline
from .env import TorchEnv
from .learner import value_and_grad
from .policy import tree_leaves, tree_map


@dataclasses.dataclass
class PPOConfig:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_envs: int = 64            # vectorized envs
    rollout_length: int = 128     # steps per env per iteration
    # bound each policy forward of the rollout to this many envs; None =
    # all at once.  Must divide num_envs when smaller than it.
    env_chunk: Optional[int] = None
    num_workers: int = 0          # 0 = rollouts inline
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    lr: float = 3e-4
    num_sgd_epochs: int = 4
    num_minibatches: int = 4
    max_grad_norm: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0
    # model config dict for rl.catalog; None -> {"hidden": hidden}
    model: Optional[dict] = None
    # obs connectors, applied to observations inside the rollout
    connectors: Optional[list] = None
    # action connectors: transform what the env receives; the stored
    # action stays the policy's output
    action_connectors: Optional[list] = None
    # reward connectors: transform the stored rewards
    reward_connectors: Optional[list] = None
    # where the envs, the policy and the update run (None: the card)
    device: Any = None

    def build(self) -> "PPO":
        return PPO(self)


@dataclasses.dataclass
class A2CConfig(PPOConfig):
    """Synchronous advantage actor-critic: single-epoch unclipped PPO over
    the whole rollout (the surrogate with ratio ≈ 1 is the policy
    gradient), so the preset reuses the PPO iteration."""
    num_sgd_epochs: int = 1
    num_minibatches: int = 1
    clip_eps: float = 10.0        # effectively unclipped


class Adam:
    """``optax.adam(lr)`` (optax's b1, b2, eps and eps_root 0) over a
    params tree, updating params and state in place.  The state mirrors
    optax's: ``count`` and the trees ``mu`` and ``nu``.  The bias
    corrections divide the moments before the square root, as optax does
    (`torch.optim.Adam` orders them otherwise).  One multi-tensor op per
    stage for the whole tree."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params) -> Dict[str, Any]:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def _step(self, grads: List[torch.Tensor], state: Dict[str, Any]
              ) -> List[torch.Tensor]:
        """Advance the moments by ``grads`` → the step m̂ / (√v̂ + eps), in
        `tree_leaves` order."""
        b1, b2 = self.b1, self.b2
        grads = list(grads)
        state["count"] += 1
        c1 = 1 - b1 ** state["count"]
        c2 = 1 - b2 ** state["count"]
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        step = torch._foreach_div(mu, c1)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(step, denom)
        return step

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params) -> None:
        """One step; ``grads`` in `tree_leaves` order of ``params``."""
        torch._foreach_add_(tree_leaves(params), self._step(grads, state),
                            alpha=-self.lr)


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients scaled by ``max_norm /
    norm`` where their global norm reaches ``max_norm``, unchanged below
    it; no read of the device."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    unclipped = norm < max_norm
    return [torch.where(unclipped, g, g / norm * max_norm) for g in grads]


class ClippedAdam(Adam):
    """``optax.chain(optax.clip_by_global_norm(max_norm),
    optax.adam(lr))``: `clip_by_global_norm`, then `Adam`."""

    def __init__(self, max_norm: float, lr: float):
        super().__init__(lr)
        self.max_norm = max_norm

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params) -> None:
        super().update(clip_by_global_norm(grads, self.max_norm), state,
                       params)


class AdamW(Adam):
    """``optax.adamw(lr, weight_decay=wd)``: Adam's step plus ``wd *
    param`` on every leaf (biases and norm scales too, optax's default
    mask), the sum scaled by ``-lr``: ``p -= lr * (m̂ / (√v̂ + eps) + wd *
    p)`` with the param before the step.  `torch.optim.AdamW` decays the
    param by ``lr * wd`` apart from the Adam step, another rounding."""

    def __init__(self, lr: float, weight_decay: float = 1e-4):
        super().__init__(lr)
        self.weight_decay = weight_decay

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params) -> None:
        step, leaves = self._step(grads, state), tree_leaves(params)
        torch._foreach_add_(step, leaves, alpha=self.weight_decay)
        torch._foreach_add_(leaves, step, alpha=-self.lr)


def _make_elementwise_apply(pipe):
    """Stateless elementwise connector application (action / reward
    pipelines)."""
    if pipe is None or not getattr(pipe, "connectors", None):
        return lambda x: x

    def apply(x):
        for c in pipe.connectors:
            _, x = c((), x)
        return x

    return apply


def _chunked(fn, chunk: int, *xs):
    """``fn`` over row blocks of ``chunk`` (all rows at once when chunk
    covers them); its outputs concatenated."""
    n = xs[0].shape[0]
    if chunk >= n:
        return fn(*xs)
    outs = [fn(*(x[i:i + chunk] for x in xs)) for i in range(0, n, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _record(traj, t: int, frame: Dict[str, torch.Tensor], steps: int):
    """Write one step's frame into the [T, N, ...] trajectory."""
    if traj is None:
        traj = {k: v.new_empty((steps,) + v.shape) for k, v in frame.items()}
    for k, v in frame.items():
        traj[k][t] = v
    return traj


def make_rollout_fn(env: TorchEnv, policy, num_envs: int,
                    rollout_length: int, pipeline=None,
                    action_pipeline=None, reward_pipeline=None,
                    env_chunk: Optional[int] = None):
    """Rollout: ``(params, env_states, obs, conn_state, gen, draws=None) ->
    (traj, env_states, last_obs, conn_state, last_value)``, ``traj`` a dict
    of [T, N, ...] tensors.

    Obs connectors run every step (the trajectory stores the processed
    observations the policy saw) and reset per env at episode boundaries
    for members marked ``reset_on_done``; action connectors transform what
    the env receives while the stored action stays the policy's; reward
    connectors transform the stored rewards.

    ``draws``, when given, is a list over T of ``{"noise": [N, A],
    "reset": the env's reset draws}``; otherwise each step draws from
    ``gen``.  ``env_chunk`` bounds how many envs one policy forward takes
    (the JAX package bounds its compiled program the same way); the result
    does not depend on it."""
    if getattr(policy, "is_recurrent", False):
        raise ValueError(
            "recurrent policies (use_lstm) are supported by PPO's local "
            "path only (make_recurrent_rollout_fn); this code path does "
            "not carry policy state")
    if env_chunk is not None and env_chunk <= 0:
        raise ValueError(f"env_chunk={env_chunk} must be positive")
    if env_chunk and env_chunk < num_envs and num_envs % env_chunk:
        raise ValueError(
            f"env_chunk={env_chunk} must divide num_envs={num_envs}")
    chunk = min(env_chunk or num_envs, num_envs)
    has_conn = pipeline is not None and pipeline.connectors
    to_env_action = _make_elementwise_apply(action_pipeline)
    to_stored_reward = _make_elementwise_apply(reward_pipeline)

    def apply_conn(state, x):
        return pipeline.batched(state, x) if has_conn else (state, x)

    @torch.no_grad()
    def rollout(params, env_states, obs, conn_state, gen, draws=None):
        traj = None
        for t in range(rollout_length):
            conn_state, pobs = apply_conn(conn_state, obs)
            noise = (draws[t]["noise"] if draws is not None
                     else policy.draw_noise(num_envs, gen))
            actions, logps, values = _chunked(
                lambda o, z: policy.sample_action(params, o, noise=z),
                chunk, pobs, noise)
            reset = (draws[t]["reset"] if draws is not None
                     else env.reset_draws(num_envs, gen))
            env_states, obs, rewards, dones = env.step_given(
                env_states, to_env_action(actions), reset)
            if has_conn:
                conn_state = pipeline.reset_where(conn_state, dones)
            traj = _record(traj, t, {
                "obs": pobs, "action": actions, "logp": logps,
                "value": values, "reward": to_stored_reward(rewards),
                "done": dones}, rollout_length)
        # the bootstrap value on the processed view, without advancing the
        # connector state a second time for the same frame
        _, plast = apply_conn(conn_state, obs)
        last_value = _chunked(lambda o: policy.forward(params, o)[1], chunk,
                              plast)
        return traj, env_states, obs, conn_state, last_value

    return rollout


def make_recurrent_rollout_fn(env: TorchEnv, policy, num_envs: int,
                              rollout_length: int, pipeline=None,
                              action_pipeline=None, reward_pipeline=None):
    """Rollout for a recurrent policy: the LSTM state is carried and zeroed
    per env at episode boundaries.  Returns the segment-initial state with
    the trajectory, for the sequence update to replay from.

    → ``(params, env_states, obs, conn_state, pstate, gen, draws=None) ->
    (traj, env_states, last_obs, conn_state, pstate, init_pstate,
    last_value)``"""
    has_conn = pipeline is not None and pipeline.connectors
    to_env_action = _make_elementwise_apply(action_pipeline)
    to_stored_reward = _make_elementwise_apply(reward_pipeline)

    def apply_conn(state, x):
        return pipeline.batched(state, x) if has_conn else (state, x)

    @torch.no_grad()
    def rollout(params, env_states, obs, conn_state, pstate, gen,
                draws=None):
        init_pstate = pstate
        traj = None
        for t in range(rollout_length):
            conn_state, pobs = apply_conn(conn_state, obs)
            noise = (draws[t]["noise"] if draws is not None
                     else policy.draw_noise(num_envs, gen))
            actions, logps, values, pstate = \
                policy.sample_action_recurrent(params, pobs, pstate,
                                               noise=noise)
            reset = (draws[t]["reset"] if draws is not None
                     else env.reset_draws(num_envs, gen))
            env_states, obs, rewards, dones = env.step_given(
                env_states, to_env_action(actions), reset)
            if has_conn:
                conn_state = pipeline.reset_where(conn_state, dones)
            keep = (1.0 - dones.float())[..., None]
            pstate = (pstate[0] * keep, pstate[1] * keep)
            traj = _record(traj, t, {
                "obs": pobs, "action": actions, "logp": logps,
                "value": values, "reward": to_stored_reward(rewards),
                "done": dones}, rollout_length)
        _, plast = apply_conn(conn_state, obs)
        _, last_value, _ = policy.step_recurrent(params, plast, pstate)
        return (traj, env_states, obs, conn_state, pstate, init_pstate,
                last_value)

    return rollout


def compute_gae(traj, last_value: torch.Tensor, gamma: float, lam: float):
    """GAE over a [T, B] trajectory, a loop over T in reverse.
    → (advantages, returns)."""
    values, rewards = traj["value"], traj["reward"]
    adv = torch.empty_like(values)
    next_adv = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(values.shape[0])):
        nonterminal = 1.0 - traj["done"][t].float()
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        next_adv = delta + gamma * lam * nonterminal * next_adv
        adv[t] = next_adv
        next_value = values[t]
    return adv, adv + values


def _ppo_loss(cfg, logp, entropy, value, batch):
    """The clipped surrogate + value loss - entropy bonus, and its parts."""
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
    vf_loss = 0.5 * torch.mean((value - batch["ret"]) ** 2)
    ent = torch.mean(entropy)
    total = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * ent
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": ent}


def pmean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``jax.lax.pmean`` over a process group: each tensor averaged over
    the group's ranks, in one all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _sgd_step(optimizer: ClippedAdam, params, opt_state, loss_fn, *args,
              group=None):
    """One minibatch: the loss's gradients (averaged over ``group``'s ranks
    when given), then the optimizer's step on ``params`` in place.  → the
    loss's parts, detached."""
    _, aux, grads = value_and_grad(loss_fn, params, *args)
    if group is not None:
        grads = pmean(grads, group)
    optimizer.update(grads, opt_state, params)
    return aux


def _perm(perms, epoch: int, n: int, gen: torch.Generator) -> torch.Tensor:
    if perms is not None:
        return perms[epoch]
    return torch.randperm(n, generator=gen, device=gen.device)


def make_update_fn(policy, optimizer: ClippedAdam, cfg, batch_size: int,
                   group=None):
    """Epoch / minibatch clipped-surrogate SGD: ``(params, opt_state, flat,
    gen, perms=None) -> (params, opt_state, metrics)``, params and
    optimizer state updated in place.  Each epoch shuffles the batch with a
    permutation from ``gen``, or ``perms[epoch]`` when given; the metrics
    are the last minibatch's loss parts (tensors, not yet read).

    With a process ``group`` the gradients are averaged over its ranks
    before every apply (the JAX package's ``axis_name`` pmean): the DD-PPO
    learner, each rank on its own batch with the same params."""
    mb_size = batch_size // cfg.num_minibatches

    def loss_fn(params, batch):
        logp, entropy, value = policy.log_prob(params, batch["obs"],
                                               batch["action"])
        return _ppo_loss(cfg, logp, entropy, value, batch)

    def update(params, opt_state, flat, gen, perms=None):
        aux = None
        for epoch in range(cfg.num_sgd_epochs):
            perm = _perm(perms, epoch, batch_size, gen)
            idxs = perm[:cfg.num_minibatches * mb_size].view(
                cfg.num_minibatches, mb_size)
            for idx in idxs:
                mb = {k: v[idx] for k, v in flat.items()}
                aux = _sgd_step(optimizer, params, opt_state, loss_fn, mb,
                                group=group)
        return params, opt_state, aux

    return update


def make_recurrent_update_fn(policy, optimizer: ClippedAdam, cfg,
                             num_envs: int):
    """Sequence-aware PPO update: minibatches are whole-env sequences
    (shuffling the env axis, never time), and log-probs are recomputed by
    replaying the LSTM from the segment's initial state.  ``(params,
    opt_state, batch, init_state, gen, perms=None) -> (params, opt_state,
    metrics)``."""
    if cfg.num_minibatches < 1:
        raise ValueError(f"num_minibatches={cfg.num_minibatches}: "
                         f"must be >= 1")
    # the largest divisor of num_envs not above num_minibatches: every env
    # sequence lands in exactly one minibatch
    n_mb = next(d for d in range(min(cfg.num_minibatches, num_envs),
                                 0, -1) if num_envs % d == 0)
    mb_envs = num_envs // n_mb

    def loss_fn(params, batch, init_state):
        logp, entropy, value = policy.log_prob_seq(
            params, batch["obs"], batch["action"], batch["done"],
            init_state)
        return _ppo_loss(cfg, logp, entropy, value, batch)

    def update(params, opt_state, batch, init_state, gen, perms=None):
        aux = None
        for epoch in range(cfg.num_sgd_epochs):
            perm = _perm(perms, epoch, num_envs, gen)
            idxs = perm[:n_mb * mb_envs].view(n_mb, mb_envs)
            for idx in idxs:
                mb = {k: v[:, idx] for k, v in batch.items()}
                mb_state = (init_state[0][idx], init_state[1][idx])
                aux = _sgd_step(optimizer, params, opt_state, loss_fn, mb,
                                mb_state)
        return params, opt_state, aux

    return update


class PPO(Algorithm):
    _config_cls = PPOConfig

    def __init__(self, config: PPOConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("PPOConfig.env required (an env factory)")
        if cfg.num_workers > 0:
            raise NotImplementedError(
                "PPOConfig.num_workers > 0 needs the runtime's rollout "
                "workers, which the port does not have yet (ROADMAP queue 1 "
                "item 10)")
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        self.pipeline = ConnectorPipeline(cfg.connectors or []) \
            .validate_kind("obs", "PPOConfig.connectors")
        self._action_pipe = ConnectorPipeline(
            cfg.action_connectors or []).validate_kind(
                "action", "PPOConfig.action_connectors")
        self._reward_pipe = ConnectorPipeline(
            cfg.reward_connectors or []).validate_kind(
                "reward", "PPOConfig.reward_connectors")
        self.policy = build_policy(
            self.env, cfg.model or {"hidden": cfg.hidden},
            obs_size_override=self.pipeline.out_size(
                self.env.observation_size), device=self.device)
        self._recurrent = bool(getattr(self.policy, "is_recurrent", False))
        if self._recurrent and cfg.env_chunk:
            raise ValueError("env_chunk requires a feedforward policy (the "
                             "LSTM state is carried over all envs at once)")
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.params = self.policy.init(self.generator)
        self.optimizer = ClippedAdam(cfg.max_grad_norm, cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self.conn_state = self.pipeline.init_state_batch(cfg.num_envs,
                                                         self.device)
        pipes = dict(pipeline=self.pipeline,
                     action_pipeline=self._action_pipe,
                     reward_pipeline=self._reward_pipe)
        if self._recurrent:
            self.pstate = self.policy.initial_state(cfg.num_envs)
            self._rollout = make_recurrent_rollout_fn(
                self.env, self.policy, cfg.num_envs, cfg.rollout_length,
                **pipes)
            self._update = make_recurrent_update_fn(
                self.policy, self.optimizer, cfg, cfg.num_envs)
        else:
            self._rollout = make_rollout_fn(
                self.env, self.policy, cfg.num_envs, cfg.rollout_length,
                env_chunk=cfg.env_chunk, **pipes)
            self._update = make_update_fn(
                self.policy, self.optimizer, cfg,
                cfg.num_envs * cfg.rollout_length)
        self._init_episode_tracking(cfg.num_envs)

    # -- the iteration ------------------------------------------------------
    def collect(self, draws=None) -> Dict[str, Any]:
        """The rollout and GAE; advances the envs.  → the batch the update
        takes (flat [N·T, ...] for a feedforward policy, [T, N, ...] with
        the segment's initial LSTM state for a recurrent one), with the
        trajectory's ``reward`` and ``done`` [T, N]."""
        cfg = self.config
        if self._recurrent:
            (traj, self.env_states, self.obs, self.conn_state, self.pstate,
             init_pstate, last_value) = self._rollout(
                self.params, self.env_states, self.obs, self.conn_state,
                self.pstate, self.generator, draws)
        else:
            (traj, self.env_states, self.obs, self.conn_state,
             last_value) = self._rollout(
                self.params, self.env_states, self.obs, self.conn_state,
                self.generator, draws)
        adv, ret = compute_gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
        if self._recurrent:
            batch = {"obs": traj["obs"], "action": traj["action"],
                     "logp": traj["logp"], "done": traj["done"],
                     "adv": adv, "ret": ret, "init_state": init_pstate}
        else:
            n = cfg.num_envs * cfg.rollout_length
            batch = {"obs": traj["obs"].reshape(n, -1),
                     "action": traj["action"].reshape(
                         (n,) if self.env.discrete else (n, -1)),
                     "logp": traj["logp"].reshape(n),
                     "adv": adv.reshape(n), "ret": ret.reshape(n)}
        return {"batch": batch, "reward": traj["reward"],
                "done": traj["done"]}

    def learn(self, collected: Dict[str, Any], perms=None
              ) -> Dict[str, torch.Tensor]:
        """The epochs of minibatch SGD on a `collect` result; → the last
        minibatch's loss parts (tensors)."""
        batch = dict(collected["batch"])
        if self._recurrent:
            init_state = batch.pop("init_state")
            _, _, metrics = self._update(self.params, self.opt_state, batch,
                                         init_state, self.generator, perms)
        else:
            _, _, metrics = self._update(self.params, self.opt_state, batch,
                                         self.generator, perms)
        return metrics

    def training_step(self, draws=None, perms=None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        collected = self.collect(draws)
        metrics = self.learn(collected, perms)
        metrics["reward_sum"] = collected["reward"].sum()
        # the iteration's one read of the device
        values = torch.stack(list(metrics.values())).tolist()
        self._track_episodes(collected["reward"].cpu().numpy(),
                             collected["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        env_steps = cfg.num_envs * cfg.rollout_length
        out = dict(zip(metrics, values))
        out.update({
            "env_steps_this_iter": env_steps,
            "env_steps_per_s": env_steps / dt,
            "episode_reward_mean": self.episode_reward_mean(),
        })
        return out

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        # connector state ships with the policy: a restored ObsNormalizer
        # without its moments would feed the policy unnormalized obs
        return {"params": self.policy.get_weights(self.params),
                "conn_state": tree_map(
                    lambda x: x.to("cpu", copy=True).numpy(),
                    self.conn_state),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = self.policy.set_weights(self.params, state["params"])
        if state.get("conn_state") is not None:
            self.conn_state = tree_map(
                lambda x: torch.tensor(np.asarray(x), device=self.device),
                state["conn_state"])
        self.iteration = state.get("iteration", 0)
