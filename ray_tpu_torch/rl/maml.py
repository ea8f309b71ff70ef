"""MAML: model-agnostic meta-learning over a task distribution
(counterpart of ``ray_tpu/rl/maml.py``): meta-learn a policy
initialization whose one-gradient-step adaptation solves each sampled task.

The JAX package writes the meta-iteration as ``jax.value_and_grad`` of a
``vmap`` over tasks: per task an inner rollout, an inner policy-gradient
step, a post-adaptation rollout and the outer loss.  Its meta-gradient is
second order, and it also runs THROUGH the rollouts: a continuous action
is ``mean + exp(log_std) * noise``, the reward ``task * clip(action)``, the
next observation moves with the action, so actions, rewards, returns and
observations all carry the params' derivative.  Only the inner gradient
holds the trajectory constant (``jax.grad(pg_loss)(p, traj)`` takes the
derivative in ``p`` alone).

Here the tasks are a batch axis: the params are expanded to [M, ...] per
task and every layer is one batched product (`multi_agent.agent_view`).
The rollout is written without ``no_grad`` and without detaching, so the
outer `torch.autograd.grad` sees through it.  The inner gradient is taken
with respect to a copy of the per-task params (``clone``) that only the
loss reads: the trajectory was computed from the params themselves, so the
copy's gradient holds it constant, as ``jax.grad`` does, while
``create_graph=True`` keeps it differentiable in the params, through the
copy and through the trajectory.  The normalization statistics of the
returns are detached, as the JAX package stops their gradient.

The draws (the tasks, each rollout's reset draws, sampling noise and
auto-reset draws) come from the algorithm's `torch.Generator` or as an
argument.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from .algorithm import Algorithm
from .multi_agent import agent_view
from .policy import MLPPolicy, tree_from_numpy, tree_leaves, tree_map, \
    tree_to_numpy
from .ppo import ClippedAdam

Draws = Dict[str, Any]


class MetaTaskEnv:
    """Batched env whose dynamics and reward depend on a task vector
    (``task`` [..., task_size], broadcast to the state's batch)."""

    observation_size: int
    action_size: int
    discrete: bool = False
    task_size: int
    max_episode_steps: int

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def sample_tasks(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """→ [n, task_size] task parameters."""
        raise NotImplementedError

    def reset_draws(self, shape, gen: torch.Generator) -> Draws:
        raise NotImplementedError

    def reset_given(self, draws: Draws, task: torch.Tensor):
        raise NotImplementedError

    def step_given(self, state, action, draws: Draws, task: torch.Tensor):
        """→ (state, obs, reward, done); ``draws`` are the reset draws of
        the envs whose episode ends."""
        raise NotImplementedError


class GoalDirection(MetaTaskEnv):
    """Point mass on a line; the task is a HIDDEN direction ±1 and the
    reward is ``direction · action`` (the classic MAML-RL sanity task:
    the direction is unobservable, so only a task-adapted policy can push
    the right way)."""

    observation_size = 1
    action_size = 1
    discrete = False
    task_size = 1
    max_episode_steps = 16

    def sample_tasks(self, n, gen):
        heads = torch.rand((n, 1), generator=gen, device=gen.device) < 0.5
        return torch.where(heads, 1.0, -1.0)

    def reset_draws(self, shape, gen):
        """``{"x": standard normal}`` (the JAX package's ``normal(key)``
        per env), scaled by 0.05 in `reset_given`."""
        return {"x": torch.randn(shape, generator=gen, device=gen.device)}

    def reset_given(self, draws, task):
        x = 0.05 * draws["x"]
        return ({"x": x, "t": torch.zeros_like(x, dtype=torch.int32)},
                x[..., None])

    def step_given(self, state, action, draws, task):
        a = torch.clamp(action[..., 0], -1.0, 1.0)
        x = torch.clamp(state["x"] + 0.2 * a, -2.0, 2.0)
        t = state["t"] + 1
        reward = task[..., 0] * a
        done = t >= self.max_episode_steps
        # auto-reset
        x = torch.where(done, 0.05 * draws["x"], x)
        t = torch.where(done, 0, t)
        return {"x": x, "t": t}, x[..., None], reward, done


@dataclasses.dataclass
class MAMLConfig:
    # task-env factory, called as env(device=...); None = GoalDirection
    env: Optional[Callable[..., MetaTaskEnv]] = None
    meta_batch_size: int = 16      # tasks per meta-iteration
    num_envs: int = 8              # vectorized envs per task rollout
    rollout_length: int = 16
    inner_lr: float = 0.1          # adaptation step size (alpha)
    inner_steps: int = 1
    outer_lr: float = 1e-2         # meta step size (beta)
    max_grad_norm: float = 1.0     # meta-gradient clip (second-order
    #   REINFORCE explodes when the adapted sigma collapses)
    gamma: float = 0.99
    entropy_coeff: float = 1e-3    # keeps exploration sigma alive
    hidden: tuple = (32, 32)
    seed: int = 0
    # where the envs, the policy and the update run (None: the card)
    device: Any = None

    def build(self) -> "MAML":
        return MAML(self)


class MAML(Algorithm):
    _config_cls = MAMLConfig

    def __init__(self, config: MAMLConfig):
        super().__init__(config)
        cfg = config
        self.device = resolve_device(cfg.device)
        self.env = (cfg.env or GoalDirection)(device=self.device)
        self.policy = MLPPolicy(self.env.observation_size,
                                self.env.action_size,
                                discrete=self.env.discrete,
                                hidden=tuple(cfg.hidden), device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.params = self.policy.init(self.generator)
        self.optimizer = ClippedAdam(cfg.max_grad_norm, cfg.outer_lr)
        self.opt_state = self.optimizer.init(self.params)

    def param_shapes(self):
        """The policy's params tree (`convert.policy_params_from_numpy`)."""
        return self.policy.param_shapes()

    # -- draws --------------------------------------------------------------
    def rollout_draws(self, m: int) -> Draws:
        """One rollout's draws for ``m`` tasks: ``{"reset": [m, E],
        "noise": [T, m, E, action_size], "steps": [T, m, E]}`` (the reset
        draws as the env takes them)."""
        cfg, gen = self.config, self.generator
        T, E = cfg.rollout_length, cfg.num_envs
        return {"reset": self.env.reset_draws((m, E), gen),
                "noise": torch.randn((T, m, E, self.env.action_size),
                                     generator=gen, device=gen.device),
                "steps": self.env.reset_draws((T, m, E), gen)}

    def meta_draws(self) -> Draws:
        """One meta-step's draws: ``{"tasks": [M, task_size], "inner": a
        rollout's draws per inner step, "post": the post-adaptation
        rollout's}``."""
        cfg = self.config
        m = cfg.meta_batch_size
        return {"tasks": self.env.sample_tasks(m, self.generator),
                "inner": [self.rollout_draws(m)
                          for _ in range(cfg.inner_steps)],
                "post": self.rollout_draws(m)}

    # -- one rollout and the REINFORCE loss, per task on a batch axis -------
    def _rollout(self, p, tasks: torch.Tensor, draws: Draws
                 ) -> Dict[str, torch.Tensor]:
        """``p``: per-task params ([M, ...] leaves); ``tasks`` [M, task].
        → the [T, M, E, ...] trajectory, differentiable in ``p``."""
        cfg, env = self.config, self.env
        E = cfg.num_envs
        pv = agent_view(p)
        task = tasks[:, None, :].expand(-1, E, -1)
        states, obs = env.reset_given(draws["reset"], task)
        frames = {"obs": [], "action": [], "reward": [], "done": []}
        for t in range(cfg.rollout_length):
            action, _, _ = self.policy.sample_action(pv, obs,
                                                     noise=draws["noise"][t])
            step_reset = {k: v[t] for k, v in draws["steps"].items()}
            states, obs2, reward, done = env.step_given(states, action,
                                                        step_reset, task)
            for k, v in (("obs", obs), ("action", action),
                         ("reward", reward), ("done", done)):
                frames[k].append(v)
            obs = obs2
        return {k: torch.stack(v) for k, v in frames.items()}

    def _pg_loss(self, p, traj) -> torch.Tensor:
        """REINFORCE with returns-to-go on the log-probs, identical inner
        and outer → the loss of each task [M]."""
        cfg = self.config
        reward, done = traj["reward"], traj["done"].float()
        T, M, E = reward.shape
        rets = [None] * T
        nxt = torch.zeros_like(reward[0])
        for t in reversed(range(T)):
            nxt = reward[t] + cfg.gamma * nxt * (1.0 - done[t])
            rets[t] = nxt

        def per_task(x):            # [T, M, E, ...] -> [M, T·E, ...]
            return x.transpose(0, 1).reshape((M, T * E) + x.shape[3:])

        logp, entropy, _ = self.policy.log_prob(
            agent_view(p), per_task(traj["obs"]), per_task(traj["action"]))
        adv = per_task(torch.stack(rets))
        # normalization statistics are constants under the gradient (the
        # JAX package's stop_gradient): the derivative of std() blows up as
        # post-adaptation rewards become uniform
        mu = adv.mean(-1, keepdim=True).detach()
        sd = adv.std(-1, correction=0, keepdim=True).detach()
        adv = (adv - mu) / (sd + 1e-8)
        return -(logp * adv).mean(-1) - cfg.entropy_coeff * entropy.mean(-1)

    def _adapt(self, p, tasks, inner: List[Draws], create_graph: bool):
        """The inner loop: collect, then one policy-gradient step, per
        inner step.  → (adapted per-task params, the first inner
        rollout's rewards)."""
        cfg = self.config
        first = None
        for draws in inner:
            traj = self._rollout(p, tasks, draws)
            if first is None:
                first = traj["reward"]
            # the inner gradient holds the trajectory constant: it is taken
            # in a copy of the params that only the loss reads
            q = tree_map(torch.clone, p)
            loss = self._pg_loss(q, traj).sum()
            leaves = tree_leaves(q)
            # the value head takes no part: its gradient is 0, as in JAX
            grads = torch.autograd.grad(loss, leaves,
                                        create_graph=create_graph,
                                        allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads)]
            p = _tree_sub(p, grads, cfg.inner_lr)
        return p, first

    def meta_loss(self, params, draws: Draws):
        """The meta-objective of ``params`` (a shared tree) over the tasks
        of ``draws`` → (loss, pre-adaptation reward mean, post-adaptation
        reward mean), differentiable in ``params``."""
        tasks = draws["tasks"]
        m = tasks.shape[0]
        p = tree_map(lambda x: x.expand((m,) + x.shape), params)
        adapted, pre = self._adapt(p, tasks, draws["inner"],
                                   create_graph=True)
        post_traj = self._rollout(adapted, tasks, draws["post"])
        losses = self._pg_loss(adapted, post_traj)
        return losses.mean(), pre.mean(), post_traj["reward"].mean()

    def meta_gradient(self, draws: Draws):
        """→ (loss, pre, post, the meta-gradient in `tree_leaves` order)."""
        leaves = tree_leaves(self.params)
        for x in leaves:
            x.requires_grad_(True)
        try:
            loss, pre, post = self.meta_loss(self.params, draws)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for x in leaves:
                x.requires_grad_(False)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return loss.detach(), pre.detach(), post.detach(), grads

    def training_step(self, draws: Optional[Draws] = None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        if draws is None:
            draws = self.meta_draws()
        loss, pre_r, post_r, grads = self.meta_gradient(draws)
        self.optimizer.update(grads, self.opt_state, self.params)
        # the iteration's one read of the device
        loss, pre_r, post_r = torch.stack([loss, pre_r, post_r]).tolist()
        dt = time.perf_counter() - t0
        steps = cfg.meta_batch_size * cfg.num_envs \
            * cfg.rollout_length * (cfg.inner_steps + 1)
        return {
            "meta_loss": loss,
            # the MAML success signal: adaptation must lift reward
            "pre_adapt_reward_mean": pre_r,
            "post_adapt_reward_mean": post_r,
            "adaptation_gain": post_r - pre_r,
            "env_steps_this_iter": steps,
            "env_steps_per_s": steps / dt,
        }

    def adapt_to_task(self, task, draws: Optional[List[Draws]] = None):
        """Deploy-time adaptation → task-adapted params (this package's
        tree).  ``draws``: a rollout's draws (for one task) per inner
        step."""
        cfg = self.config
        tasks = torch.as_tensor(task, dtype=torch.float32,
                                device=self.device).reshape(1, -1)
        if draws is None:
            draws = [self.rollout_draws(1) for _ in range(cfg.inner_steps)]
        p = tree_map(lambda x: x[None].clone().requires_grad_(True),
                     self.params)
        adapted, _ = self._adapt(p, tasks, draws, create_graph=False)
        return tree_map(lambda x: x[0].detach(), adapted)

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.iteration = state.get("iteration", 0)


def _tree_sub(p, grads, lr: float):
    """``p - lr * g`` leaf by leaf (grads in `tree_leaves` order)."""
    it = iter(grads)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node - lr * next(it)

    return walk(p)
