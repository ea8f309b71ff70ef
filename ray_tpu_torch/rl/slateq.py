"""SlateQ: slate recommendation by decomposed Q-learning (counterpart of
``ray_tpu/rl/slateq.py``; Ie et al. 2019).

The value of a slate decomposes over its items under the user's choice
model, ``Q(s, slate) = Σ_i P(click i | s, slate) · Q(s, i)``, so an
item-level Q-network suffices.  `RecSlateEnv` is the RecSim-style
environment of the JAX package, batched: an interest-vector user,
topic-vector documents drawn fresh every step, a multinomial-logit choice
with a no-click option, interest drift toward the clicked topic, and
auto-reset at the session's end.

The greedy slate is the exact argmax of the decomposed value over all
``C choose k`` slates (560 at 16 / 3), one [.., slates, k] gather on the
card.  The update is the JAX package's QL mode over the replay buffer on
the card, behind the learn-start gate (`learner.make_update_gate`: the
buffer's size is a host int, so the gate is a Python ``if``); collection is
epsilon-greedy over slates.  The draws (the choice model's Gumbel noise,
the fresh documents, the reset users, the explorer's uniforms, the
replay's indices) come from the algorithm's `torch.Generator` or as an
argument.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from . import replay
from .algorithm import Algorithm
from .exploration import EpsilonGreedy
from .learner import make_update_gate
from .policy import (gumbel, mlp_apply, mlp_init, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import Adam

State = Dict[str, torch.Tensor]
Draws = Dict[str, Any]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class RecSlateEnv:
    """RecSim-style slate environment over ``n`` users at once.

    State: each user's interest vector u ∈ R^d (unit), and C candidate
    documents (unit topic vectors and a quality each) drawn fresh every
    step.  The agent shows a k-slate; the user picks item i with
    probability ∝ exp(u·topic_i) (beside a no-click logit), the reward is
    the clicked document's quality, and the interest drifts toward the
    clicked topic.  Sessions last ``horizon`` steps."""

    def __init__(self, n_topics: int = 8, n_candidates: int = 16,
                 slate_size: int = 3, horizon: int = 32,
                 no_click_logit: float = 1.0, drift: float = 0.1,
                 device: DeviceLike = None):
        self.n_topics = n_topics
        self.n_candidates = n_candidates
        self.slate_size = slate_size
        self.horizon = horizon
        self.no_click_logit = no_click_logit
        self.drift = drift
        self.device = resolve_device(device)

    # -- draws --------------------------------------------------------------
    def docs_draws(self, n: int, gen: torch.Generator) -> Draws:
        """``{"topics": [n, C, d] standard normal, "quality": [n, C]
        uniform}``."""
        return {"topics": torch.randn((n, self.n_candidates, self.n_topics),
                                      generator=gen, device=gen.device),
                "quality": torch.rand((n, self.n_candidates), generator=gen,
                                      device=gen.device)}

    def reset_draws(self, n: int, gen: torch.Generator) -> Draws:
        return {"u": torch.randn((n, self.n_topics), generator=gen,
                                 device=gen.device),
                **self.docs_draws(n, gen)}

    def step_draws(self, n: int, gen: torch.Generator) -> Draws:
        """``{"choice": [n, k+1] Gumbel noise of the user's pick, "u0":
        [n, d] the next session's user, the fresh documents}``."""
        return {"choice": gumbel((n, self.slate_size + 1), gen),
                "u0": torch.randn((n, self.n_topics), generator=gen,
                                  device=gen.device),
                **self.docs_draws(n, gen)}

    # -- dynamics -----------------------------------------------------------
    def reset_given(self, draws: Draws):
        u = _unit(draws["u"])
        state = {"u": u, "topics": _unit(draws["topics"]),
                 "quality": draws["quality"],
                 "t": torch.zeros(u.shape[0], dtype=torch.int32,
                                  device=u.device)}
        return state, self._obs(state)

    def reset(self, n: int, gen: torch.Generator):
        return self.reset_given(self.reset_draws(n, gen))

    @staticmethod
    def _obs(state: State) -> State:
        return {"user": state["u"], "topics": state["topics"],
                "quality": state["quality"]}

    def choice_logits(self, u, topics):
        """The user's choice logits over documents: u [.., d], topics
        [.., k, d] → [.., k]."""
        return torch.einsum("...kd,...d->...k", topics, u)

    def step_given(self, state: State, slate: torch.Tensor, draws: Draws):
        """``slate`` [n, k] candidate indices → (state, obs, reward, done,
        pick), ``pick`` ∈ [0, k] the chosen SLOT (k = no click)."""
        K = self.slate_size
        topics = state["topics"].gather(
            1, slate[..., None].expand(-1, -1, self.n_topics))   # [n, k, d]
        logits = self.choice_logits(state["u"], topics)
        full = torch.cat([logits, torch.full_like(logits[:, :1],
                                                  self.no_click_logit)], -1)
        pick = torch.argmax(full + draws["choice"], -1)
        clicked = pick < K
        doc = torch.where(clicked, slate.gather(
            1, pick.clamp(max=K - 1)[:, None])[:, 0], 0)
        reward = torch.where(clicked, state["quality"].gather(
            1, doc[:, None])[:, 0], 0.0)
        topic = state["topics"].gather(
            1, doc[:, None, None].expand(-1, 1, self.n_topics))[:, 0]
        u = torch.where(clicked[:, None],
                        state["u"] + self.drift * (topic - state["u"]),
                        state["u"])
        u = _unit(u)
        t = state["t"] + 1
        done = t >= self.horizon
        # auto-reset: a fresh user at the session's end; documents are
        # drawn fresh every step
        state = {"u": torch.where(done[:, None], _unit(draws["u0"]), u),
                 "topics": _unit(draws["topics"]),
                 "quality": draws["quality"],
                 "t": torch.where(done, 0, t)}
        return state, self._obs(state), reward, done, pick

    def greedy_quality_slate(self, obs: State) -> torch.Tensor:
        """The myopic baseline: the top-k documents by quality alone."""
        return torch.topk(obs["quality"], self.slate_size, -1).indices


@dataclasses.dataclass
class SlateQConfig:
    # env factory, called as env(device=...); None = RecSlateEnv
    env: Optional[Callable[..., RecSlateEnv]] = None
    num_envs: int = 16
    rollout_steps: int = 32
    buffer_capacity: int = 50_000
    batch_size: int = 128
    num_updates: int = 16
    gamma: float = 0.95
    lr: float = 1e-3
    tau: float = 0.01
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 20_000
    learn_start: int = 1_000
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the envs, the Q-network and the buffer live (None: the card)
    device: Any = None

    def build(self) -> "SlateQ":
        return SlateQ(self)


class SlateQ(Algorithm):
    _config_cls = SlateQConfig

    def __init__(self, config: SlateQConfig):
        super().__init__(config)
        cfg = config
        self.device = resolve_device(cfg.device)
        self.env = (cfg.env or RecSlateEnv)(device=self.device)
        env, dev = self.env, self.device
        d, C, K = env.n_topics, env.n_candidates, env.slate_size
        n_combos = math.comb(C, K)
        if n_combos > 8192:
            raise ValueError(
                f"C={C} choose k={K} = {n_combos} slates is too many "
                f"to enumerate exactly; shrink the candidate pool "
                f"(LP or greedy slate strategies are the escape hatch at "
                f"that scale)")
        self._combos = torch.tensor(
            list(itertools.combinations(range(C), K)), device=dev)
        self.item_in = 2 * d + 1      # user ⊕ topic ⊕ quality
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.params = mlp_init(self.generator, (self.item_in,)
                               + tuple(cfg.hidden) + (1,))
        self.target_params = tree_map(torch.clone, self.params)
        self.optimizer = Adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.buffer = replay.init(cfg.buffer_capacity, {
            "user": torch.zeros(d, device=dev),
            "topics": torch.zeros((C, d), device=dev),
            "quality": torch.zeros(C, device=dev),
            "slate": torch.zeros(K, dtype=torch.long, device=dev),
            "pick": torch.zeros((), dtype=torch.long, device=dev),
            "reward": torch.zeros((), device=dev),
            "next_user": torch.zeros(d, device=dev),
            "next_topics": torch.zeros((C, d), device=dev),
            "next_quality": torch.zeros(C, device=dev),
            "done": torch.zeros((), device=dev),
        })
        self.env_states, self.obs = env.reset(cfg.num_envs, self.generator)
        self._explorer = EpsilonGreedy(cfg.eps_start, cfg.eps_end,
                                       cfg.eps_decay_steps)
        self._gate = make_update_gate(
            self.optimizer, tau=cfg.tau, learn_start=cfg.learn_start,
            num_updates=cfg.num_updates,
            sample_fn=lambda buf, draw: replay.sample(
                buf, cfg.batch_size, self.generator, draw),
            loss_fn=self.td_loss)
        self._init_episode_tracking(cfg.num_envs)

    def param_shapes(self):
        """The item Q-network's shapes (`convert.
        policy_params_from_numpy`)."""
        return tree_map(lambda x: tuple(x.shape), self.params)

    # -- item-level Q -------------------------------------------------------
    def _q_items(self, params, user, topics, quality):
        """[.., C] item Q-values: Q(user, doc) for every candidate."""
        u = user[..., None, :].expand(topics.shape[:-1] + user.shape[-1:])
        x = torch.cat([u, topics, quality[..., None]], -1)
        return mlp_apply(params, x)[..., 0]

    def _slate_value(self, q_items, user, topics, slate):
        """Decomposed slate value: Σ_i P(click i | slate) Q_i, the no-click
        option contributing zero."""
        t = topics.gather(-2, slate[..., None].expand(
            slate.shape + topics.shape[-1:]))
        logits = self.env.choice_logits(user, t)
        full = torch.cat([logits, torch.full_like(
            logits[..., :1], self.env.no_click_logit)], -1)
        p = torch.softmax(full, -1)
        q = q_items.gather(-1, slate)
        return (p[..., :-1] * q).sum(-1)

    def _best_slate(self, q_items, user, topics):
        """The EXACT argmax of the decomposed value over all C-choose-k
        slates (an additive ranking is not optimal: every candidate shifts
        the shared choice denominator)."""
        v = torch.exp(self.env.choice_logits(user, topics))   # [.., C]
        combos = self._combos                                 # [N, K]
        v_s, q_s = v[..., combos], q_items[..., combos]       # [.., N, K]
        v0 = math.exp(self.env.no_click_logit)
        value = (v_s * q_s).sum(-1) / (v0 + v_s.sum(-1))      # [.., N]
        return combos[torch.argmax(value, -1)]

    def td_loss(self, params, target_params, batch):
        """The QL-mode TD loss on the CLICKED item, bootstrapping from the
        greedy next slate under the target network; no-click transitions
        train nothing."""
        K = self.env.slate_size
        q = self._q_items(params, batch["user"], batch["topics"],
                          batch["quality"])                      # [B, C]
        q_next = self._q_items(target_params, batch["next_user"],
                               batch["next_topics"], batch["next_quality"])
        next_slate = self._best_slate(q_next, batch["next_user"],
                                      batch["next_topics"])
        v_next = self._slate_value(q_next, batch["next_user"],
                                   batch["next_topics"], next_slate)
        target = batch["reward"] + self.config.gamma \
            * (1.0 - batch["done"]) * v_next.detach()
        clicked = (batch["pick"] < K).float()
        doc = batch["slate"].gather(
            -1, batch["pick"].clamp(max=K - 1)[..., None])
        q_sa = q.gather(-1, doc)[..., 0]
        td = (q_sa - target) * clicked
        return (td ** 2).sum() / torch.clamp(clicked.sum(), min=1.0)

    # -- draws --------------------------------------------------------------
    def collect_draws(self) -> List[Draws]:
        """Per step ``{"uniform": [E] (explore or not), "rand": [E, C]
        (a random slate: the first k of their argsort), "env": the envs'
        step draws}``."""
        cfg, gen = self.config, self.generator
        E, C = cfg.num_envs, self.env.n_candidates
        return [{"uniform": torch.rand(E, generator=gen, device=gen.device),
                 "rand": torch.rand((E, C), generator=gen,
                                    device=gen.device),
                 "env": self.env.step_draws(E, gen)}
                for _ in range(cfg.rollout_steps)]

    # -- the iteration ------------------------------------------------------
    @torch.no_grad()
    def collect(self, draws: Optional[List[Draws]] = None
                ) -> Dict[str, torch.Tensor]:
        """``rollout_steps`` epsilon-greedy slates in every env into the
        buffer; epsilon from the env steps before this iteration.  → the
        [T, E] ``reward`` and ``done``."""
        cfg, env = self.config, self.env
        K, E = env.slate_size, cfg.num_envs
        if draws is None:
            draws = self.collect_draws()
        eps = self._explorer.epsilon(self._total_env_steps)
        obs, rewards, dones = self.obs, [], []
        for d in draws:
            q = self._q_items(self.params, obs["user"], obs["topics"],
                              obs["quality"])
            greedy = self._best_slate(q, obs["user"], obs["topics"])
            # epsilon-greedy over SLATES: a random k-subset
            rand = torch.argsort(d["rand"], -1)[:, :K]
            slate = torch.where((d["uniform"] < eps)[:, None], rand, greedy)
            self.env_states, next_obs, reward, done, pick = env.step_given(
                self.env_states, slate, d["env"])
            replay.add_batch(self.buffer, {
                "user": obs["user"], "topics": obs["topics"],
                "quality": obs["quality"], "slate": slate, "pick": pick,
                "reward": reward, "next_user": next_obs["user"],
                "next_topics": next_obs["topics"],
                "next_quality": next_obs["quality"],
                "done": done.float()}, E)
            rewards.append(reward)
            dones.append(done)
            obs = next_obs
        self.obs = obs
        return {"reward": torch.stack(rewards), "done": torch.stack(dones)}

    def learn(self, draws: Optional[List[Draws]] = None) -> torch.Tensor:
        """``num_updates`` TD steps behind the learn-start gate → the last
        loss (0 below the gate).  ``draws``: a list over updates of the
        sample's ``{"idx"}``."""
        return self._gate(self.params, self.target_params, self.opt_state,
                          self.buffer, draws)

    def training_step(self, draws: Optional[Draws] = None) -> Dict[str, Any]:
        """`collect` then `learn`; ``draws``: ``{"collect": [...],
        "updates": [...]}`` (tests), else the generator."""
        cfg = self.config
        t0 = time.perf_counter()
        eps = self._explorer.epsilon(self._total_env_steps)
        traj = self.collect(None if draws is None else draws["collect"])
        td_loss = self.learn(None if draws is None else draws["updates"])
        # the iteration's one read of the device
        td_loss = float(td_loss)
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        steps = cfg.num_envs * cfg.rollout_steps
        return {"td_loss": td_loss, "epsilon": eps,
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
