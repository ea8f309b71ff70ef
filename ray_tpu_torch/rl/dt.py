"""Decision Transformer: offline RL as return-conditioned sequence modeling
(counterpart of ``ray_tpu/rl/dt.py``).

A causal transformer over interleaved (return-to-go, state, action) tokens,
trained with the action-prediction cross-entropy on fixed-length windows of
offline episodes and deployed by conditioning on a target return.  The
trunk's attention is the port's `ops.multi_head_attention`: on the card, at
head dims 64 and 128 in fp32 or bf16, the Hopper flash kernels, forward in
both training and evaluation and dQ and dK/dV in the backward; at other
head dims (``DTConfig``'s default 64 / 4 heads gives 16) and on the CPU the
reference attention, as the JAX package's own dispatch does.

The layers are stacked on a leading [L] axis as in the JAX package and
unbound once per forward (`models/transformer.py` does the same).  The
windows are cut on the host once, as the JAX package cuts them.  The
optimizer is ``optax.adamw(lr, weight_decay=1e-4)`` written out
(`ppo.AdamW`).  The evaluation rollout runs every one of the env's
``max_episode_steps`` steps with the live mask, as the JAX scan does; the
context's fill count and slot are host ints (they do not depend on the
data), and the return is read once.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import multi_head_attention
from .algorithm import Algorithm
from .env import TorchEnv
from .learner import value_and_grad
from .policy import tree_from_numpy, tree_map, tree_to_numpy
from .ppo import AdamW

Draws = Dict[str, Any]


def _dense_init(gen: torch.Generator, d_in: int, d_out: int,
                scale: Optional[float] = None, lead: tuple = ()):
    scale = scale if scale is not None else math.sqrt(2.0 / d_in)
    return {"w": torch.randn(lead + (d_in, d_out), generator=gen,
                             device=gen.device) * scale,
            "b": torch.zeros(lead + (d_out,), device=gen.device)}


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _ln_params(d_model: int, lead: tuple, device):
    return {"g": torch.ones(lead + (d_model,), device=device),
            "b": torch.zeros(lead + (d_model,), device=device)}


def trunk_init(gen: torch.Generator, d_model: int, n_layers: int,
               n_heads: int, d_ff: int):
    """The trunk's params, each layer's leaves stacked on a leading [L]
    axis, in the JAX init's distributions."""
    L, dev = (n_layers,), gen.device
    small = 0.02 / math.sqrt(n_layers)
    return {"layers": {
                "ln1": _ln_params(d_model, L, dev),
                "qkv": _dense_init(gen, d_model, 3 * d_model, lead=L),
                "proj": _dense_init(gen, d_model, d_model, small, lead=L),
                "ln2": _ln_params(d_model, L, dev),
                "up": _dense_init(gen, d_model, d_ff, lead=L),
                "down": _dense_init(gen, d_ff, d_model, small, lead=L)},
            "ln_f": _ln_params(d_model, (), dev)}


def _ln(p, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


def _unbind_layers(layers) -> List[Dict[str, Any]]:
    """Stacked [L, ...] layer params → one tree per layer (views)."""
    n = next(iter(next(iter(layers.values())).values())).shape[0]
    return [{k: {kk: vv[i] for kk, vv in v.items()} for k, v in
             layers.items()} for i in range(n)]


def trunk_apply(params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, D] → [B, S, D], causal."""
    b, s, d = x.shape
    hd = d // n_heads
    for lp in _unbind_layers(params["layers"]):
        y = _ln(lp["ln1"], x)
        qkv = _dense(lp["qkv"], y).reshape(b, s, 3, n_heads, hd)
        att = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1],
                                   qkv[:, :, 2], causal=True)
        x = x + _dense(lp["proj"], att.reshape(b, s, d))
        y = _ln(lp["ln2"], x)
        x = x + _dense(lp["down"], F.gelu(_dense(lp["up"], y),
                                          approximate="tanh"))
    return _ln(params["ln_f"], x)


@dataclasses.dataclass
class DTConfig:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    dataset: Optional[Dict[str, np.ndarray]] = None   # EPISODIC columns
    context_len: int = 20          # K triplets of (rtg, obs, act)
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 256
    gamma: float = 1.0             # DT uses undiscounted returns-to-go
    lr: float = 1e-3
    batch_size: int = 64
    steps_per_iter: int = 100      # minibatch updates per train()
    target_return: float = 200.0   # conditioning return at eval time
    rtg_scale: float = 100.0       # return normalization divisor
    seed: int = 0
    # where the model, its updates and the eval env run (None: the card)
    device: Any = None

    def build(self) -> "DT":
        return DT(self)


def _returns_to_go(rewards: np.ndarray, gamma: float) -> np.ndarray:
    """Per-episode (discounted) returns-to-go; gamma=1 (the DT paper's
    convention) is a plain reverse cumsum."""
    if gamma >= 1.0:
        return np.flip(np.cumsum(np.flip(rewards))).copy()
    out = np.empty_like(rewards, dtype=np.float64)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out.astype(rewards.dtype)


def episodes_from_columns(ds: Dict[str, np.ndarray]):
    """Split columnar (obs, action, reward, done) rows into episode
    lists.  Episodes end at ``done`` marks AND at ``env_id`` changes (when
    present): each env's trailing partial episode carries done=0, so
    without the env_id cut it would be spliced onto the next env's first
    episode."""
    done = np.asarray(ds["done"]) > 0.5
    n = len(done)
    last = np.zeros(n, bool)
    if "env_id" in ds:
        env_id = np.asarray(ds["env_id"])
        last[:-1] = env_id[1:] != env_id[:-1]
    last[-1] = True
    ends = np.flatnonzero(done | last)
    episodes = []
    start = 0
    for e in ends:
        sl = slice(start, e + 1)
        episodes.append({k: np.asarray(ds[k][sl]) for k in
                         ("obs", "action", "reward")})
        start = e + 1
    return episodes


def make_windows(episodes, context_len: int, gamma: float):
    """Windows of ``context_len`` steps every ``context_len // 2`` of each
    episode, left-aligned and zero-padded at the end → numpy ``{"obs" [W,
    K, obs], "action" [W, K], "rtg" [W, K] (unscaled), "mask" [W, K]}``."""
    K = context_len
    obs_w, act_w, rtg_w, len_w = [], [], [], []
    for ep in episodes:
        T = len(ep["reward"])
        rtg = _returns_to_go(ep["reward"], gamma)
        for start in range(0, T, max(1, K // 2)):
            end = min(start + K, T)
            n = end - start
            pad = K - n
            obs_w.append(np.pad(ep["obs"][start:end].astype(np.float32),
                                ((0, pad), (0, 0))))
            act_w.append(np.pad(ep["action"][start:end].astype(np.int64),
                                (0, pad)))
            rtg_w.append(np.pad(rtg[start:end].astype(np.float32), (0, pad)))
            len_w.append(n)
    return {"obs": np.stack(obs_w), "action": np.stack(act_w),
            "rtg": np.stack(rtg_w),
            "mask": (np.arange(K)[None, :] < np.asarray(len_w)[:, None]
                     ).astype(np.float32)}


class DT(Algorithm):
    _config_cls = DTConfig

    def __init__(self, config: DTConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None or cfg.dataset is None:
            raise ValueError("DTConfig.env and DTConfig.dataset required")
        if cfg.d_model % cfg.n_heads:
            raise ValueError(f"d_model={cfg.d_model} not divisible by "
                             f"n_heads={cfg.n_heads}")
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        if not self.env.discrete:
            raise ValueError("this DT implementation is discrete-action "
                             "(continuous heads are an MSE swap)")
        obs_dim, n_act = self.env.observation_size, self.env.action_size
        self.n_actions = n_act
        K, D = cfg.context_len, cfg.d_model
        gen = self.generator = torch.Generator(
            device=self.device).manual_seed(cfg.seed)
        self.params = {
            "trunk": trunk_init(gen, D, cfg.n_layers, cfg.n_heads, cfg.d_ff),
            "emb_rtg": _dense_init(gen, 1, D),
            "emb_obs": _dense_init(gen, obs_dim, D),
            "emb_act": _dense_init(gen, n_act, D),
            "emb_t": torch.randn((K, D), generator=gen,
                                 device=self.device) * 0.02,
            "head": _dense_init(gen, D, n_act, scale=0.02),
        }
        self.optimizer = AdamW(cfg.lr, weight_decay=1e-4)
        self.opt_state = self.optimizer.init(self.params)
        # ---- window the offline episodes once, on the host ---------------
        w = make_windows(episodes_from_columns(cfg.dataset), K, cfg.gamma)
        self._windows = {
            "obs": torch.from_numpy(w["obs"]).to(self.device),
            "action": torch.from_numpy(w["action"]).to(self.device),
            "rtg": torch.from_numpy(w["rtg"]).to(self.device)
            / cfg.rtg_scale,
            "mask": torch.from_numpy(w["mask"]).to(self.device)}

    def param_shapes(self):
        """The params tree's shapes (`convert.policy_params_from_numpy`)."""
        return tree_map(lambda x: tuple(x.shape), self.params)

    # -- the model: windows → per-step action logits ------------------------
    def _logits(self, params, rtg, obs, act):
        """[B, K] rtg, [B, K, obs] obs, [B, K] act → [B, K, A] logits
        predicting act_t from (.., rtg_t, s_t)."""
        cfg = self.config
        B, K = rtg.shape
        e_r = _dense(params["emb_rtg"], rtg[..., None])
        e_s = _dense(params["emb_obs"], obs)
        e_a = _dense(params["emb_act"],
                     F.one_hot(act.long(), self.n_actions).float())
        t_emb = params["emb_t"][None, :K]
        # interleave [r_0, s_0, a_0, r_1, s_1, a_1, ...] → [B, 3K, D]
        tokens = torch.stack([e_r + t_emb, e_s + t_emb, e_a + t_emb],
                             dim=2).reshape(B, 3 * K, cfg.d_model)
        h = trunk_apply(params["trunk"], tokens, cfg.n_heads)
        # the state token (position 3t+1) predicts action a_t
        return _dense(params["head"], h[:, 1::3])

    def loss(self, params, batch):
        """The masked action cross-entropy of a window batch → (loss,
        None)."""
        logits = self._logits(params, batch["rtg"], batch["obs"],
                              batch["action"])
        ce = -torch.log_softmax(logits, -1).gather(
            -1, batch["action"].long()[..., None])[..., 0]
        return (ce * batch["mask"]).sum() / batch["mask"].sum(), None

    def batch_draws(self) -> List[torch.Tensor]:
        """An iteration's minibatch indices, [batch_size] a step."""
        cfg, gen = self.config, self.generator
        W = self._windows["obs"].shape[0]
        return [torch.randint(W, (cfg.batch_size,), generator=gen,
                              device=gen.device)
                for _ in range(cfg.steps_per_iter)]

    def step(self, idx: torch.Tensor) -> torch.Tensor:
        """One AdamW step on the windows ``idx`` → its loss (a tensor)."""
        batch = {k: v[idx] for k, v in self._windows.items()}
        loss, _, grads = value_and_grad(self.loss, self.params, batch)
        self.optimizer.update(grads, self.opt_state, self.params)
        return loss

    def training_step(self, draws: Optional[List[torch.Tensor]] = None
                      ) -> Dict[str, Any]:
        """``steps_per_iter`` AdamW steps; ``draws``: a list over steps of
        the minibatch's window indices (tests), else the generator."""
        cfg = self.config
        t0 = time.perf_counter()
        if draws is None:
            draws = self.batch_draws()
        losses = torch.stack([self.step(idx) for idx in draws])
        # the iteration's one read of the device
        loss = float(losses.mean())
        dt_s = time.perf_counter() - t0
        return {"action_ce_loss": loss,
                "windows": int(self._windows["obs"].shape[0]),
                "updates_per_s": cfg.steps_per_iter / dt_s,
                "env_steps_this_iter": 0}

    # -- return-conditioned evaluation --------------------------------------
    def eval_draws(self) -> Draws:
        """One episode's draws: the env's reset draws for one env and
        its (auto-)reset draws for each of ``max_episode_steps`` steps."""
        gen, env = self.generator, self.env
        steps = env.max_episode_steps
        per_step = env.reset_draws(steps, gen)
        return {"reset": env.reset_draws(1, gen),
                "steps": {k: v[:, None] for k, v in per_step.items()}}

    @torch.no_grad()
    def eval_rollout(self, target_return: float,
                     draws: Optional[Draws] = None) -> torch.Tensor:
        """One episode conditioned on ``target_return`` → its achieved
        return (a 0-d tensor, not read)."""
        cfg, env = self.config, self.env
        K = cfg.context_len
        if draws is None:
            draws = self.eval_draws()
        state, obs = env.reset_given(draws["reset"])
        dev = obs.device
        ctx_rtg = torch.zeros((1, K), device=dev)
        ctx_obs = torch.zeros((1, K, obs.shape[-1]), device=dev)
        ctx_act = torch.zeros((1, K), dtype=torch.long, device=dev)
        rtg_now = torch.full((1,), float(target_return), device=dev)
        ret = torch.zeros(1, device=dev)
        done = torch.zeros(1, device=dev)
        n = 0                          # filled positions (a host int)

        def place(buf, x):
            """Left-aligned insert: fill slot n while the window is
            filling, shift once full (the training windows' layout)."""
            if n < K:
                buf = buf.clone()
                buf[:, n] = x
                return buf
            return torch.cat([buf[:, 1:], x[:, None]], 1)

        for t in range(env.max_episode_steps):
            pos = min(n, K - 1)        # the slot holding the current step
            ctx_rtg = place(ctx_rtg, rtg_now / cfg.rtg_scale)
            ctx_obs = place(ctx_obs, obs)
            ctx_act = place(ctx_act, torch.zeros_like(ctx_act[:, 0]))
            logits = self._logits(self.params, ctx_rtg, ctx_obs,
                                  ctx_act)[:, pos]
            action = torch.argmax(logits, -1)
            state, obs, reward, step_done = env.step_given(
                state, action, {k: v[t] for k, v in draws["steps"].items()})
            # write the TAKEN action into the context
            ctx_act[:, pos] = action
            n = min(n + 1, K)
            ret = ret + reward * (1.0 - done)
            rtg_now = rtg_now - reward
            done = torch.maximum(done, step_done.float())
        return ret[0]

    def evaluate(self, n_episodes: int = 8,
                 target_return: Optional[float] = None,
                 draws: Optional[List[Draws]] = None) -> float:
        """Mean achieved return when conditioned on ``target_return``;
        ``draws``: one `eval_draws` per episode (tests)."""
        tr = target_return if target_return is not None \
            else self.config.target_return
        rets = [self.eval_rollout(tr, None if draws is None else draws[i])
                for i in range(n_episodes)]
        return float(torch.stack(rets).mean())

    # -- checkpointing -------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.iteration = state.get("iteration", 0)
