"""DQN, SimpleQ and Rainbow (counterpart of ``ray_tpu/rl/dqn.py``): a
replay buffer on the card (`replay`), a Polyak-averaged target network,
double-Q, dueling and distributional (C51) heads, n-step targets and
prioritized replay.

The JAX package compiles an iteration into one program: a scan collecting
``rollout_steps`` vectorized env steps into the buffer, then a scan of
``num_updates`` TD steps behind a ``lax.cond`` learn-start gate.  Here the
same steps run as PyTorch ops on the card: `DQN.collect` loops over the
steps (a Q forward, the explorer, the env step, one insert), `DQN.learn`
over the updates (sample, n-step window, TD gradient, priorities, Adam,
Polyak after every step).  The buffer's size, epsilon and the PER beta are
host values, so the gate and the schedules read nothing from the device;
the iteration reads its metrics once.

Randomness comes from the algorithm's `torch.Generator`, or as arguments:
``collect(draws)`` takes per step the explorer's draws (``uniform``,
``random``) and the envs' ``reset`` draws, ``learn(draws)`` per update the
sample's draw (`replay.sample_prioritized`), so tests can give both
packages the same ones.  The optimizer is optax's Adam written out
(`ppo.Adam`).

The C51 support is ``torch.linspace``, which differs from
``jnp.linspace`` in the last bit of some atoms; the projection is
continuous in the shifted atom position, so that moves the loss by
rounding only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import replay
from .algorithm import Algorithm
from .env import TorchEnv
from .exploration import EpsilonGreedy, anneal
from .learner import polyak, value_and_grad
from .policy import (mlp_apply, mlp_init, mlp_shapes, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import Adam


class QNetwork:
    """MLP state-action value network: obs → Q[action].

    With ``dueling`` the torso (tanh on every layer) feeds separate value
    and advantage heads and Q = V + A - mean(A).  With ``num_atoms > 1``
    the net is distributional (C51): `logits` gives [.., A, atoms] and
    `apply` still gives expected Q-values, so exploration, greedy actions
    and double-Q selection work unchanged."""

    def __init__(self, obs_size: int, n_actions: int, hidden=(64, 64),
                 dueling: bool = False, num_atoms: int = 1,
                 v_min: float = -10.0, v_max: float = 10.0,
                 device=None):
        self.obs_size = obs_size
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        self.dueling = dueling
        self.num_atoms = num_atoms
        self.device = resolve_device(device)
        if num_atoms > 1:
            if not v_min < v_max:
                raise ValueError(
                    f"distributional support needs v_min < v_max "
                    f"(got {v_min} >= {v_max}): a zero-width support "
                    f"divides by zero in the projection")
            self.support = torch.linspace(v_min, v_max, num_atoms,
                                          device=self.device)

    def _sizes(self):
        """(torso or whole-net sizes, value head, advantage head)."""
        if not self.dueling:
            out = self.n_actions * max(self.num_atoms, 1)
            return (self.obs_size,) + self.hidden + (out,), None, None
        if not self.hidden:
            raise ValueError("dueling=True needs at least one hidden "
                             "layer (the shared torso the V/A heads read)")
        width = self.hidden[-1]
        return ((self.obs_size,) + self.hidden, (width, self.num_atoms),
                (width, self.n_actions * self.num_atoms))

    def param_shapes(self):
        torso, v, a = self._sizes()
        if v is None:
            return mlp_shapes(torso)
        return {"torso": mlp_shapes(torso), "v": mlp_shapes(v),
                "a": mlp_shapes(a)}

    def init(self, gen: torch.Generator):
        torso, v, a = self._sizes()
        if v is None:
            return mlp_init(gen, torso)
        return {"torso": mlp_init(gen, torso), "v": mlp_init(gen, v),
                "a": mlp_init(gen, a)}

    def _torso(self, params, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for layer in params["torso"]:      # tanh on every torso layer
            x = torch.tanh(x @ layer["w"] + layer["b"])
        return x

    def logits(self, params, obs: torch.Tensor) -> torch.Tensor:
        """[.., A, atoms] distribution logits (num_atoms > 1 only)."""
        if self.dueling:
            x = self._torso(params, obs)
            v = mlp_apply(params["v"], x)[..., None, :]     # [.., 1, atoms]
            a = mlp_apply(params["a"], x).reshape(
                x.shape[:-1] + (self.n_actions, self.num_atoms))
            return v + a - a.mean(dim=-2, keepdim=True)
        out = mlp_apply(params, obs)
        return out.reshape(out.shape[:-1] + (self.n_actions, self.num_atoms))

    def apply(self, params, obs: torch.Tensor) -> torch.Tensor:
        if self.num_atoms > 1:
            probs = torch.softmax(self.logits(params, obs), dim=-1)
            return (probs * self.support).sum(dim=-1)
        if not self.dueling:
            return mlp_apply(params, obs)
        x = self._torso(params, obs)
        v = mlp_apply(params["v"], x)                        # [..., 1]
        a = mlp_apply(params["a"], x)                        # [..., A]
        return v + a - a.mean(dim=-1, keepdim=True)


def _pick(x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``x[b, action[b]]`` over the action axis (dim 1), of [B, A, ...]."""
    index = action.long().view((-1, 1) + (1,) * (x.dim() - 2))
    return x.gather(1, index.expand((-1, 1) + x.shape[2:]))[:, 0]


@torch.no_grad()
def categorical_projection(q: QNetwork, params, target_params, batch,
                           double_q: bool) -> torch.Tensor:
    """The C51 target: the Bellman-shifted next-state distribution at the
    selected action, clamped to the support and split between its two
    neighbouring atoms; [B, atoms], no gradient.  Handles per-sample gamma
    (n-step)."""
    z = q.support
    atoms = q.num_atoms
    dz = (z[-1] - z[0]) / (atoms - 1)
    next_logits = q.logits(target_params, batch["next_obs"])
    if double_q:
        next_a = torch.argmax(q.apply(params, batch["next_obs"]), dim=-1)
    else:
        next_probs_all = torch.softmax(next_logits, dim=-1)
        next_a = torch.argmax((next_probs_all * z).sum(-1), dim=-1)
    next_p = torch.softmax(_pick(next_logits, next_a), dim=-1)
    tz = torch.clamp(batch["reward"][:, None]
                     + batch["gamma_n"][:, None]
                     * (1.0 - batch["done"][:, None]) * z[None, :],
                     z[0], z[-1])
    b = (tz - z[0]) / dz
    low = torch.clamp(torch.floor(b), 0, atoms - 1)
    up = torch.clamp(torch.ceil(b), 0, atoms - 1)
    # when low == up (b integral) all mass goes to that atom
    w_up = torch.where(up == low, 1.0, b - low)
    w_low = 1.0 - w_up
    proj = torch.zeros_like(next_p)
    proj.scatter_add_(1, low.long(), next_p * w_low)
    proj.scatter_add_(1, up.long(), next_p * w_up)
    return proj


def categorical_td_loss(q: QNetwork, params, target_params, batch, weights,
                        double_q: bool):
    """C51: cross-entropy of the predicted distribution at the taken
    action against the projected target.  → (loss, per-sample CE); the CE
    is the PER priority (the distributional convention)."""
    proj = categorical_projection(q, params, target_params, batch, double_q)
    pred_logits = _pick(q.logits(params, batch["obs"]), batch["action"])
    log_p = torch.log_softmax(pred_logits, dim=-1)
    ce = -(proj * log_p).sum(dim=-1)
    return torch.mean(weights * ce), ce


@torch.no_grad()
def dqn_target(q_apply, params, target_params, reward, next_obs, done,
               gamma, double_q: bool) -> torch.Tensor:
    """The (double-)DQN TD target, without gradient; ``gamma`` a scalar or
    a per-sample vector (n-step)."""
    next_qt = q_apply(target_params, next_obs)
    if double_q:
        # double-DQN: the online net selects, the target net evaluates
        next_a = torch.argmax(q_apply(params, next_obs), dim=-1)
        next_q = next_qt.gather(-1, next_a[:, None])[:, 0]
    else:
        next_q = next_qt.max(dim=-1).values
    return reward + gamma * next_q * (1.0 - done)


@dataclasses.dataclass
class DQNConfig:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_envs: int = 16
    rollout_steps: int = 32        # env steps per env per iteration
    buffer_capacity: int = 50_000
    batch_size: int = 128
    num_updates: int = 32          # SGD steps per iteration
    gamma: float = 0.99
    lr: float = 1e-3
    tau: float = 0.01              # Polyak target-average rate
    double_q: bool = True
    dueling: bool = False          # V + A - mean(A) heads
    num_atoms: int = 1             # >1: distributional C51 over
    v_min: float = -10.0           #   linspace(v_min, v_max, atoms)
    v_max: float = 10.0
    n_step: int = 1                # n-step targets (window gathered at
    #   sample time from buffer adjacency; cursor-crossing windows fall
    #   back to 1-step)
    prioritized_replay: bool = False
    per_alpha: float = 0.6         # priority exponent
    per_beta: float = 0.4          # initial importance-weight exponent
    per_beta_final: float = 1.0    # annealed to over eps_decay_steps
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 20_000  # env steps to anneal epsilon over
    learn_start: int = 1_000       # env steps before updates begin
    hidden: tuple = (64, 64)
    seed: int = 0
    # external input (transitions from out-of-process simulators through
    # rl/external.py): not in the port yet, see DQN.__init__
    external_input: bool = False
    observation_size: Optional[int] = None
    num_actions: Optional[int] = None
    ingest_chunk: int = 64
    # where the env, the buffer and the networks live (None: the card)
    device: Any = None

    def build(self) -> "DQN":
        return DQN(self)


_EXTERNAL = ("needs rl/external.py (PolicyServerInput), which the port "
             "does not have yet (ROADMAP queue 1 item 10, external.py)")


class DQN(Algorithm):
    _config_cls = DQNConfig

    def __init__(self, config: DQNConfig):
        super().__init__(config)
        cfg = config
        if cfg.external_input:
            raise NotImplementedError(f"DQNConfig.external_input {_EXTERNAL}")
        if cfg.env is None:
            raise ValueError("DQNConfig.env required (an env factory)")
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        if not self.env.discrete:
            raise ValueError("DQN requires a discrete-action env")
        obs_dim, n_act = self.env.observation_size, self.env.action_size
        if cfg.n_step > 1 and (cfg.n_step - 1) * cfg.num_envs >= \
                cfg.buffer_capacity:
            raise ValueError(
                f"n_step={cfg.n_step} with num_envs={cfg.num_envs} needs "
                f"a window of {(cfg.n_step - 1) * cfg.num_envs} slots, "
                f">= buffer_capacity={cfg.buffer_capacity}: every sample "
                f"would silently fall back to 1-step targets")
        self.n_actions = n_act
        self.q = QNetwork(obs_dim, n_act, hidden=cfg.hidden,
                          dueling=cfg.dueling, num_atoms=cfg.num_atoms,
                          v_min=cfg.v_min, v_max=cfg.v_max,
                          device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.params = self.q.init(self.generator)
        self.target_params = tree_map(torch.clone, self.params)
        self.optimizer = Adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._replay_ops = replay.make_ops(
            cfg.prioritized_replay, alpha=cfg.per_alpha, beta=cfg.per_beta)
        dev = self.device
        self.buffer = self._replay_ops[0](cfg.buffer_capacity, {
            "obs": torch.zeros(obs_dim, device=dev),
            "action": torch.zeros((), dtype=torch.long, device=dev),
            "reward": torch.zeros((), device=dev),
            "next_obs": torch.zeros(obs_dim, device=dev),
            "done": torch.zeros((), device=dev),
        })
        self._explorer = EpsilonGreedy(cfg.eps_start, cfg.eps_end,
                                       cfg.eps_decay_steps)
        self._np_rng = np.random.default_rng(cfg.seed)
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self._init_episode_tracking(cfg.num_envs)

    # -- the iteration ------------------------------------------------------
    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """``rollout_steps`` epsilon-greedy steps of every env into the
        buffer (one insert of ``num_envs`` rows a step), epsilon from the
        env steps before this iteration.  ``draws``: a list over steps of
        ``{"uniform", "random", "reset"}``.  → the trajectory's ``reward``
        and ``done`` [T, N]."""
        cfg, n = self.config, self.config.num_envs
        add_fn = self._replay_ops[1]
        steps = self._total_env_steps
        obs, rewards, dones = self.obs, [], []
        for t in range(cfg.rollout_steps):
            d = draws[t] if draws is not None else None
            qvals = self.q.apply(self.params, obs)
            _, action = self._explorer((), qvals, steps, draws=d,
                                       gen=self.generator)
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

    def _td_loss(self, params, target_params, batch, weights):
        cfg, q = self.config, self.q
        if cfg.num_atoms > 1:
            return categorical_td_loss(q, params, target_params, batch,
                                       weights, cfg.double_q)
        q_sa = q.apply(params, batch["obs"]).gather(
            -1, batch["action"].long()[:, None])[:, 0]
        target = dqn_target(q.apply, params, target_params, batch["reward"],
                            batch["next_obs"], batch["done"],
                            batch["gamma_n"], cfg.double_q)
        td = q_sa - target
        return torch.mean(weights * td ** 2), torch.abs(td)

    def _targets_batch(self, batch, idx):
        """The sampled batch with its n-step reward, bootstrap obs, done
        and per-sample gamma (1-step: gamma itself).  The collect writes
        one row per env a step, so a transition's successor is
        ``num_envs`` rows on."""
        cfg = self.config
        if cfg.n_step > 1:
            reward_n, next_obs_n, done_n, gamma_n = replay.nstep_window(
                self.buffer, idx, cfg.n_step, cfg.gamma,
                stride=cfg.num_envs, one_step=batch)
            return {**batch, "reward": reward_n, "next_obs": next_obs_n,
                    "done": done_n, "gamma_n": gamma_n}
        return {**batch, "gamma_n": torch.full((cfg.batch_size,), cfg.gamma,
                                               device=idx.device)}

    def learn(self, draws=None) -> Dict[str, Any]:
        """``num_updates`` TD steps behind the learn-start gate (nothing
        below it), each: sample, n-step window, TD gradient, priority
        update, Adam, Polyak.  ``draws``: a list over updates of the
        sample's draw.  → ``{"td_loss": the last step's loss (0 below the
        gate), "indices": each step's sampled slots}``."""
        cfg = self.config
        if self.buffer["size"] < cfg.learn_start:
            return {"td_loss": torch.zeros((), device=self.device),
                    "indices": []}
        # the PER bias-correction exponent anneals on epsilon's horizon
        beta_now = anneal(self._total_env_steps, cfg.per_beta,
                          cfg.per_beta_final, cfg.eps_decay_steps)
        sample_fn, update_pri = self._replay_ops[2], self._replay_ops[3]
        loss, indices = None, []
        for k in range(cfg.num_updates):
            batch, idx, weights = sample_fn(
                self.buffer, cfg.batch_size, self.generator,
                None if draws is None else draws[k], beta_now=beta_now)
            batch = self._targets_batch(batch, idx)
            loss, td_abs, grads = value_and_grad(
                self._td_loss, self.params, self.target_params, batch,
                weights)
            update_pri(self.buffer, idx, td_abs)
            self.optimizer.update(grads, self.opt_state, self.params)
            polyak(self.target_params, self.params, cfg.tau)
            indices.append(idx)
        return {"td_loss": loss, "indices": indices}

    def set_input_reader(self, reader: Any) -> None:
        raise NotImplementedError(f"DQN.set_input_reader {_EXTERNAL}")

    def compute_single_action(self, obs, explore: bool = True) -> int:
        """Epsilon-greedy action for one observation (the policy-serving
        entry point); epsilon anneals on the env steps seen, the same
        schedule the collect loop uses."""
        if explore:
            eps = self._explorer.epsilon(self._total_env_steps)
            if self._np_rng.random() < eps:
                return int(self._np_rng.integers(self.n_actions))
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None]
        with torch.no_grad():
            return int(torch.argmax(self.q.apply(self.params, x), dim=-1)[0])

    def training_step(self, draws=None) -> Dict[str, Any]:
        """`collect` then `learn`; ``draws``: ``{"collect": [...],
        "updates": [...]}`` (tests), else the generator."""
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(None if draws is None else draws["collect"])
        out = self.learn(None if draws is None else draws["updates"])
        # the iteration's one read of the device
        td_loss, step_reward = torch.stack(
            [out["td_loss"], traj["reward"].mean()]).tolist()
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        env_steps = cfg.num_envs * cfg.rollout_steps
        return {"td_loss": td_loss,
                "epsilon": self._explorer.epsilon(self._total_env_steps),
                "buffer_size": self.buffer["size"],
                "step_reward_mean": step_reward,
                "env_steps_this_iter": env_steps,
                "env_steps_per_s": env_steps / dt,
                "episode_reward_mean": self.episode_reward_mean()}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "target_params": tree_to_numpy(self.target_params),
                "iteration": self.iteration,
                # epsilon anneals on env_steps_total: a restored run must
                # not restart exploration from eps_start
                "env_steps_total": self._total_env_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.target_params = tree_from_numpy(state["target_params"],
                                             self.device)
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("env_steps_total", 0)


@dataclasses.dataclass
class SimpleQConfig(DQNConfig):
    """SimpleQ: DQN without double-Q, dueling heads, n-step or prioritized
    replay (a preset of the one DQN iteration)."""
    double_q: bool = False
    dueling: bool = False
    n_step: int = 1
    prioritized_replay: bool = False
    num_atoms: int = 1

    def build(self) -> "SimpleQ":  # type: ignore[override]
        return SimpleQ(self)


class SimpleQ(DQN):
    _config_cls = SimpleQConfig


@dataclasses.dataclass
class RainbowConfig(DQNConfig):
    """Every DQN improvement at once: double-Q + dueling + 3-step +
    prioritized replay + C51 heads."""
    double_q: bool = True
    dueling: bool = True
    n_step: int = 3
    prioritized_replay: bool = True
    num_atoms: int = 51
    v_min: float = -10.0
    v_max: float = 10.0

    def build(self) -> "Rainbow":  # type: ignore[override]
        return Rainbow(self)


class Rainbow(DQN):
    _config_cls = RainbowConfig
