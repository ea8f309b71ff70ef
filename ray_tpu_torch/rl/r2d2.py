"""R2D2: DQN over an LSTM Q-network with sequence replay, stored recurrent
states and burn-in (counterpart of ``ray_tpu/rl/r2d2.py``).

A buffer row is one fixed-length sequence of an env plus the LSTM state at
its start (the paper's "stored state"); an iteration collects one sequence
per env and banks them, then runs the recurrent double-Q update through
`learner.make_update_gate`.  The JAX package compiles this into one
program with ``lax.scan`` unrolls; here the unrolls are loops over time of
batched PyTorch ops on the card.  Draws come from the algorithm's
`torch.Generator` or as arguments, as in `dqn`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..device import resolve_device
from . import replay
from .algorithm import Algorithm
from .env import TorchEnv
from .exploration import EpsilonGreedy
from .learner import make_update_gate
from .policy import (_normal, mlp_init, mlp_shapes, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import Adam


class RecurrentQNetwork:
    """obs → MLP torso (tanh) → LSTM cell → Q[action], with an explicit
    ``(h, c)`` state.  The cell is the JAX package's: one product split as
    ``i, f, g, o`` and a forget gate of ``sigmoid(f + 1)``."""

    def __init__(self, obs_size: int, n_actions: int, hidden=(64,),
                 lstm_size: int = 64, device=None):
        if not hidden:
            raise ValueError("RecurrentQNetwork needs >=1 torso layer")
        self.obs_size = obs_size
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        self.lstm_size = lstm_size
        self.device = resolve_device(device)

    def param_shapes(self):
        in_dim = self.hidden[-1] + self.lstm_size
        return {"torso": mlp_shapes((self.obs_size,) + self.hidden),
                "lstm": {"w": (in_dim, 4 * self.lstm_size),
                         "b": (4 * self.lstm_size,)},
                "q": {"w": (self.lstm_size, self.n_actions),
                      "b": (self.n_actions,)}}

    def init(self, gen: torch.Generator):
        in_dim = self.hidden[-1] + self.lstm_size
        return {
            "torso": mlp_init(gen, (self.obs_size,) + self.hidden),
            "lstm": {"w": _normal(gen, (in_dim, 4 * self.lstm_size),
                                  math.sqrt(1.0 / in_dim)),
                     "b": torch.zeros(4 * self.lstm_size, device=gen.device)},
            "q": {"w": _normal(gen, (self.lstm_size, self.n_actions), 0.01),
                  "b": torch.zeros(self.n_actions, device=gen.device)},
        }

    def initial_state(self, batch_size: Optional[int] = None):
        shape = ((self.lstm_size,) if batch_size is None
                 else (batch_size, self.lstm_size))
        return (torch.zeros(shape, device=self.device),
                torch.zeros(shape, device=self.device))

    def step(self, params, obs: torch.Tensor, state):
        """One timestep: obs [.., obs] + (h, c) → (q [.., A], state')."""
        x = obs
        for layer in params["torso"]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        h, c = state
        z = torch.cat([x, h], dim=-1) @ params["lstm"]["w"] \
            + params["lstm"]["b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h @ params["q"]["w"] + params["q"]["b"], (h, c)

    def unroll(self, params, obs_seq: torch.Tensor, done_seq: torch.Tensor,
               init_state) -> torch.Tensor:
        """[T, B, obs] + done [T, B] (the state resets after a done step,
        as in the collect loop) → q [T, B, A]."""
        state, qs = init_state, []
        for t in range(obs_seq.shape[0]):
            q, (h, c) = self.step(params, obs_seq[t], state)
            keep = (1.0 - done_seq[t].float())[..., None]
            state = (h * keep, c * keep)
            qs.append(q)
        return torch.stack(qs)


@dataclasses.dataclass
class R2D2Config:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_envs: int = 16
    seq_len: int = 20              # stored sequence length (after burn-in)
    burn_in: int = 4               # prefix steps that only warm the state
    buffer_capacity: int = 2048    # capacity in SEQUENCES
    batch_size: int = 32           # sequences per TD update
    num_updates: int = 8           # SGD steps per iteration
    gamma: float = 0.99
    lr: float = 1e-3
    tau: float = 0.01              # Polyak target-average rate
    double_q: bool = True
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 20_000
    learn_start: int = 32          # sequences in buffer before updates
    hidden: tuple = (64,)
    lstm_size: int = 64
    seed: int = 0
    # where the env, the buffer and the networks live (None: the card)
    device: Any = None

    def build(self) -> "R2D2":
        return R2D2(self)


class R2D2(Algorithm):
    _config_cls = R2D2Config

    def __init__(self, config: R2D2Config):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("R2D2Config.env required (an env factory)")
        if cfg.burn_in >= cfg.seq_len:
            raise ValueError(
                f"burn_in={cfg.burn_in} >= seq_len={cfg.seq_len}: no "
                "steps would remain for the TD loss")
        self.device = dev = resolve_device(cfg.device)
        self.env = cfg.env(device=dev)
        if not self.env.discrete:
            raise ValueError("R2D2 is a DQN variant: discrete actions "
                             "only")
        obs_dim, n_act = self.env.observation_size, self.env.action_size
        self.q = RecurrentQNetwork(obs_dim, n_act, hidden=cfg.hidden,
                                   lstm_size=cfg.lstm_size, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.params = self.q.init(self.generator)
        self.target_params = tree_map(torch.clone, self.params)
        self.optimizer = Adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        T = cfg.seq_len
        # one row = one sequence + the LSTM state at its start; obs has
        # T+1 entries so every step's TD target has its next obs in-row
        self.buffer = replay.init(cfg.buffer_capacity, {
            "obs": torch.zeros(T + 1, obs_dim, device=dev),
            "action": torch.zeros(T, dtype=torch.long, device=dev),
            "reward": torch.zeros(T, device=dev),
            "done": torch.zeros(T, device=dev),
            "h0": torch.zeros(cfg.lstm_size, device=dev),
            "c0": torch.zeros(cfg.lstm_size, device=dev),
        })
        self.env_states, self.obs = self.env.reset(cfg.num_envs,
                                                   self.generator)
        self.lstm_state = self.q.initial_state(cfg.num_envs)
        self._explorer = EpsilonGreedy(cfg.eps_start, cfg.eps_end,
                                       cfg.eps_decay_steps)
        self._update_gate = make_update_gate(
            self.optimizer, tau=cfg.tau, learn_start=cfg.learn_start,
            num_updates=cfg.num_updates,
            sample_fn=lambda buf, draw: replay.sample(
                buf, cfg.batch_size, self.generator, draw),
            loss_fn=self._td_loss)
        self._init_episode_tracking(cfg.num_envs)

    def _td_loss(self, params, target_params, batch):
        """Double-Q TD over sequence rows ([B, ...] leaves), the burn-in
        steps masked out of the loss."""
        cfg, q, T = self.config, self.q, self.config.seq_len
        obs = batch["obs"].transpose(0, 1)                  # [T+1, B, obs]
        done = batch["done"].transpose(0, 1)                # [T, B]
        init = (batch["h0"], batch["c0"])
        # the T+1-th unroll step needs a done flag; no TD target reaches
        # past the final obs, so it is padded with zeros
        done_pad = torch.cat([done, torch.zeros_like(done[:1])])
        q_on = q.unroll(params, obs, done_pad, init)        # [T+1, B, A]
        with torch.no_grad():
            q_tg = q.unroll(target_params, obs, done_pad, init)
            sel = torch.argmax((q_on if cfg.double_q else q_tg)[1:], dim=-1)
            q_next = q_tg[1:].gather(-1, sel[..., None])[..., 0]
            target = batch["reward"].transpose(0, 1) + cfg.gamma \
                * (1.0 - done) * q_next
        q_sa = q_on[:T].gather(
            -1, batch["action"].transpose(0, 1)[..., None])[..., 0]
        td = q_sa - target
        # burn-in steps warm the recurrence but carry no loss
        mask = (torch.arange(T, device=td.device) >= cfg.burn_in).float()
        td = td * mask[:, None]
        return (td ** 2).sum() / (mask.sum() * td.shape[1])

    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """One sequence of ``seq_len`` epsilon-greedy steps per env, banked
        as one buffer row each with the LSTM state at its start.
        ``draws``: a list over steps of ``{"uniform", "random",
        "reset"}``.  → the trajectory's ``reward`` and ``done`` [T, N]."""
        cfg, n = self.config, self.config.num_envs
        steps = self._total_env_steps
        h0, c0 = self.lstm_state
        obs, frames = self.obs, []
        for t in range(cfg.seq_len):
            d = draws[t] if draws is not None else None
            qvals, (h, c) = self.q.step(self.params, obs, self.lstm_state)
            _, action = self._explorer((), qvals, steps, draws=d,
                                       gen=self.generator)
            reset = (d["reset"] if d is not None
                     else self.env.reset_draws(n, self.generator))
            self.env_states, next_obs, reward, done = self.env.step_given(
                self.env_states, action, reset)
            keep = (1.0 - done.float())[..., None]
            self.lstm_state = (h * keep, c * keep)
            frames.append((obs, action, reward, done))
            obs = next_obs
        self.obs = obs
        o, a, r, d = (torch.stack(x, dim=1) for x in zip(*frames))
        replay.add_batch(self.buffer, {
            "obs": torch.cat([o, obs[:, None]], dim=1), "action": a,
            "reward": r, "done": d.float(), "h0": h0, "c0": c0}, n)
        return {"reward": r.transpose(0, 1), "done": d.transpose(0, 1)}

    def learn(self, draws=None) -> torch.Tensor:
        """The gated updates; ``draws``: a list over updates of
        ``{"idx": sampled rows}``.  → the last loss (0 below the gate)."""
        return self._update_gate(self.params, self.target_params,
                                 self.opt_state, self.buffer, draws)

    def training_step(self, draws=None) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(None if draws is None else draws["collect"])
        loss = self.learn(None if draws is None else draws["updates"])
        td_loss = float(loss)                 # the iteration's one read
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        steps = cfg.num_envs * cfg.seq_len
        return {"td_loss": td_loss,
                "epsilon": self._explorer.epsilon(self._total_env_steps),
                "buffer_size": self.buffer["size"],
                "episode_reward_mean": self.episode_reward_mean(),
                "env_steps_this_iter": steps,
                "env_steps_per_s": steps / dt}

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "target_params": tree_to_numpy(self.target_params),
                "iteration": self.iteration,
                "env_steps_total": self._total_env_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.target_params = tree_from_numpy(state["target_params"],
                                             self.device)
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("env_steps_total", 0)
