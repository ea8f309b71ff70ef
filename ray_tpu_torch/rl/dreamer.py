"""Dreamer: model-based RL, a latent world model and an actor-critic
trained in imagination (counterpart of ``ray_tpu/rl/dreamer.py``).

The vector-observation variant of the JAX package: an RSSM (a GRU
deterministic state, Gaussian prior and posterior with ``softplus + 0.1``
stds) with MLP encoder / decoder, reward and continue heads, trained on
replayed [T]-step sequences with the KL-balanced loss and free nats; a
discrete-action actor trained with REINFORCE on imagined λ-returns and a
critic regressing them with a slow target copy.

The JAX package compiles one iteration (the collect scan, the posterior
scan, the imagination scan, the λ-return scan, the update scans) into one
program behind a ``lax.cond`` on the buffer's size.  Here each scan is a
loop over its fixed length on [batch, ...] tensors, and the gate is a
Python ``if`` on the replay buffer's host-int size (`replay`, rows of [T,
...] sequences).  The six ``stop_gradient``s become ``.detach()`` at the
same places; the actor's loss reads the world model's params, which take
no gradient there.  Three `ClippedAdam` at norm 100.

The draws (the posterior and prior noise, the Gumbel noise of each
categorical action, the replay's indices, the envs' reset draws) come from
the algorithm's `torch.Generator` or as an argument.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import replay
from .algorithm import Algorithm
from .env import TorchEnv
from .learner import polyak, value_and_grad
from .policy import (gumbel, mlp_apply, mlp_init, tree_from_numpy,
                     tree_map, tree_to_numpy)
from .ppo import ClippedAdam

Draws = Dict[str, Any]


def _elu_mlp(params, x):
    return mlp_apply(params, x, activation=F.elu)


def _kl(m1, s1, m2, s2):
    """KL(N(m1, s1) || N(m2, s2)) of diagonal Gaussians, summed."""
    return (torch.log(s2 / s1) + (s1 ** 2 + (m1 - m2) ** 2)
            / (2 * s2 ** 2) - 0.5).sum(-1)


def _sigmoid_bce(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


@dataclasses.dataclass
class DreamerConfig:
    # env factory, called as env(device=...) (an env class will do)
    env: Optional[Callable[..., TorchEnv]] = None
    num_envs: int = 16
    seq_len: int = 16              # collected/model-training sequence
    buffer_capacity: int = 2048    # in sequences
    batch_size: int = 16           # sequences per model update
    model_updates: int = 4         # world-model steps per iteration
    ac_updates: int = 4            # actor-critic steps per iteration
    horizon: int = 12              # imagination length
    deter_size: int = 96           # GRU state
    stoch_size: int = 24           # Gaussian latent
    hidden: int = 96               # MLP widths
    gamma: float = 0.98
    lam: float = 0.95              # λ-returns
    free_nats: float = 1.0         # KL floor
    kl_balance: float = 0.8        # posterior/prior KL mixing
    model_lr: float = 3e-4
    actor_lr: float = 1e-4
    critic_lr: float = 3e-4
    entropy_coeff: float = 3e-3
    critic_tau: float = 0.02       # slow-target rate
    learn_start: int = 16          # sequences before updates
    seed: int = 0
    # where the envs, the model and the updates run (None: the card)
    device: Any = None

    def build(self) -> "Dreamer":
        return Dreamer(self)


class Dreamer(Algorithm):
    _config_cls = DreamerConfig

    def __init__(self, config: DreamerConfig):
        super().__init__(config)
        cfg = config
        if cfg.env is None:
            raise ValueError("DreamerConfig.env required")
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        if not self.env.discrete:
            raise ValueError("this Dreamer variant is discrete-action "
                             "(continuous needs pathwise imagination "
                             "gradients — a tanh-Normal actor swap)")
        self.n_act = self.env.action_size
        D, S = cfg.deter_size, cfg.stoch_size
        gen = self.generator = torch.Generator(
            device=self.device).manual_seed(cfg.seed)
        sizes = self._sizes()
        in_dim = S + self.n_act + D
        self.params = {
            # RSSM (standard GRU: reset/update gates, candidate on r*h)
            "gru": {
                "w_ru": torch.randn((in_dim, 2 * D), generator=gen,
                                    device=self.device) / math.sqrt(in_dim),
                "b_ru": torch.zeros(2 * D, device=self.device),
                "w_c": torch.randn((in_dim, D), generator=gen,
                                   device=self.device) / math.sqrt(in_dim),
                "b_c": torch.zeros(D, device=self.device),
            },
            **{k: mlp_init(gen, sizes[k]) for k in
               ("prior", "post", "decoder", "reward", "cont")},
        }
        self.actor_params = mlp_init(gen, sizes["actor"])
        self.critic_params = mlp_init(gen, sizes["critic"])
        self.critic_target = tree_map(torch.clone, self.critic_params)
        self.model_opt = ClippedAdam(100.0, cfg.model_lr)
        self.actor_opt = ClippedAdam(100.0, cfg.actor_lr)
        self.critic_opt = ClippedAdam(100.0, cfg.critic_lr)
        self.model_opt_state = self.model_opt.init(self.params)
        self.actor_opt_state = self.actor_opt.init(self.actor_params)
        self.critic_opt_state = self.critic_opt.init(self.critic_params)
        T, obs_dim, dev = cfg.seq_len, self.env.observation_size, self.device
        self.buffer = replay.init(cfg.buffer_capacity, {
            "obs": torch.zeros((T, obs_dim), device=dev),
            "action": torch.zeros(T, dtype=torch.long, device=dev),
            "reward": torch.zeros(T, device=dev),
            "done": torch.zeros(T, device=dev),
        })
        self.env_states, self.obs = self.env.reset(cfg.num_envs, gen)
        self.h = torch.zeros((cfg.num_envs, D), device=dev)
        self._init_episode_tracking(cfg.num_envs)

    def _sizes(self) -> Dict[str, tuple]:
        cfg = self.config
        D, S, H = cfg.deter_size, cfg.stoch_size, cfg.hidden
        obs_dim = self.env.observation_size
        return {"prior": (D, H, 2 * S), "post": (D + obs_dim, H, 2 * S),
                "decoder": (D + S, H, obs_dim), "reward": (D + S, H, 1),
                "cont": (D + S, H, 1), "actor": (D + S, H, H, self.n_act),
                "critic": (D + S, H, H, 1)}

    def param_shapes(self):
        """The world model's, the actor's and the critic's shapes, as
        ``{"model", "actor", "critic"}`` (`convert.
        policy_params_from_numpy`)."""
        return tree_map(lambda x: tuple(x.shape), {
            "model": self.params, "actor": self.actor_params,
            "critic": self.critic_params})

    # -- RSSM pieces ---------------------------------------------------------
    @staticmethod
    def _gru(p, x, h):
        D = h.shape[-1]
        ru = torch.cat([x, h], -1) @ p["w_ru"] + p["b_ru"]
        r = torch.sigmoid(ru[..., :D])
        u = torch.sigmoid(ru[..., D:])
        cand = torch.tanh(torch.cat([x, r * h], -1) @ p["w_c"] + p["b_c"])
        return u * h + (1 - u) * cand

    def _step_deter(self, params, z, a, h):
        a_onehot = F.one_hot(a, self.n_act).float()
        return self._gru(params["gru"], torch.cat([z, a_onehot], -1), h)

    @staticmethod
    def _gauss(stats):
        mean, std_raw = stats.chunk(2, -1)
        return mean, F.softplus(std_raw) + 0.1

    def _prior(self, params, h):
        return self._gauss(_elu_mlp(params["prior"], h))

    def _post(self, params, h, obs):
        return self._gauss(_elu_mlp(params["post"], torch.cat([h, obs], -1)))

    # -- draws --------------------------------------------------------------
    def collect_draws(self) -> List[Draws]:
        """The collect's draws, per step ``{"z": [E, S], "gumbel": [E, A],
        "reset": the envs' reset draws}``."""
        cfg, gen = self.config, self.generator
        E = cfg.num_envs
        return [{"z": torch.randn((E, cfg.stoch_size), generator=gen,
                                  device=gen.device),
                 "gumbel": gumbel((E, self.n_act), gen),
                 "reset": self.env.reset_draws(E, gen)}
                for _ in range(cfg.seq_len)]

    def learn_draws(self) -> Draws:
        """The updates' draws: per model update ``{"idx": [B], "z": [B, T,
        S]}``, per actor-critic update ``{"gumbel": [H, N, A], "z": [H, N,
        S]}`` with N = B·T imagination starts."""
        cfg, gen = self.config, self.generator
        B, T, S, H = cfg.batch_size, cfg.seq_len, cfg.stoch_size, cfg.horizon
        size = max(self.buffer["size"], 1)
        return {"model": [{"idx": torch.randint(size, (B,), generator=gen,
                                                 device=gen.device),
                           "z": torch.randn((B, T, S), generator=gen,
                                            device=gen.device)}
                          for _ in range(cfg.model_updates)],
                "ac": [{"gumbel": gumbel((H, B * T, self.n_act), gen),
                        "z": torch.randn((H, B * T, S), generator=gen,
                                         device=gen.device)}
                       for _ in range(cfg.ac_updates)]}

    # -- the world model ----------------------------------------------------
    def observe(self, params, obs, action, done, z_noise):
        """The posterior over [B, T] sequences → (h [B, T, D], z [B, T, S],
        the balanced KL [B, T]).  h_t is advanced with the PREVIOUS action,
        and the latent resets after a done, as the collect does."""
        cfg = self.config
        B, T = action.shape
        h = torch.zeros((B, cfg.deter_size), device=obs.device)
        z = torch.zeros((B, cfg.stoch_size), device=obs.device)
        prev_a = torch.zeros_like(action[:, 0])
        prev_done = torch.zeros_like(done[:, 0])
        hs, zs, kls = [], [], []
        for t in range(T):
            keep = (1.0 - prev_done)[..., None]
            h, z = h * keep, z * keep
            h = self._step_deter(params, z, prev_a, h)
            pm, ps = self._prior(params, h)
            qm, qs = self._post(params, h, obs[:, t])
            z = qm + qs * z_noise[:, t]
            kl_post = _kl(qm, qs, pm.detach(), ps.detach())
            kl_prior = _kl(qm.detach(), qs.detach(), pm, ps)
            kls.append(cfg.kl_balance * kl_prior
                       + (1 - cfg.kl_balance) * kl_post)
            hs.append(h)
            zs.append(z)
            prev_a, prev_done = action[:, t], done[:, t]
        return (torch.stack(hs, 1), torch.stack(zs, 1), torch.stack(kls, 1))

    def model_loss(self, params, batch, z_noise):
        """→ (loss, {"feat" [B, T, D+S], "recon", "kl"})."""
        cfg = self.config
        hs, zs, kls = self.observe(params, batch["obs"], batch["action"],
                                   batch["done"], z_noise)
        feat = torch.cat([hs, zs], -1)
        recon = _elu_mlp(params["decoder"], feat)
        r_hat = _elu_mlp(params["reward"], feat)[..., 0]
        c_logit = _elu_mlp(params["cont"], feat)[..., 0]
        recon_l = ((recon - batch["obs"]) ** 2).sum(-1).mean()
        reward_l = ((r_hat - batch["reward"]) ** 2).mean()
        cont_l = _sigmoid_bce(c_logit, 1.0 - batch["done"]).mean()
        kl_l = torch.clamp(kls.mean(), min=cfg.free_nats)
        loss = recon_l + reward_l + cont_l + kl_l
        return loss, {"feat": feat, "recon": recon_l, "kl": kl_l}

    # -- imagination and the actor-critic -----------------------------------
    def imagine(self, params, actor_params, feat0, draws):
        """Roll the PRIOR from the posterior features ``feat0`` [N, D+S]
        for ``horizon`` steps under the actor → (feats [H+1, N, F], logps
        [H, N], entropies [H, N])."""
        cfg = self.config
        h, z = feat0[..., :cfg.deter_size], feat0[..., cfg.deter_size:]
        feats, logps, ents = [feat0], [], []
        for t in range(cfg.horizon):
            logits = _elu_mlp(actor_params, torch.cat([h, z], -1))
            a = torch.argmax(logits + draws["gumbel"][t], -1)
            logp_all = torch.log_softmax(logits, -1)
            logps.append(logp_all.gather(-1, a[..., None])[..., 0])
            ents.append(-(torch.softmax(logits, -1) * logp_all).sum(-1))
            h = self._step_deter(params, z, a, h)
            pm, ps = self._prior(params, h)
            z = pm + ps * draws["z"][t]
            feats.append(torch.cat([h, z], -1))
        return torch.stack(feats), torch.stack(logps), torch.stack(ents)

    def lambda_returns(self, rewards, conts, values):
        """λ-returns over imagined trajectories: rewards / conts [H, N] for
        the transitions, values [H+1, N] → [H, N]."""
        cfg = self.config
        rets = [None] * rewards.shape[0]
        nxt = values[-1]
        for t in reversed(range(rewards.shape[0])):
            nxt = rewards[t] + cfg.gamma * conts[t] * (
                (1 - cfg.lam) * values[t + 1] + cfg.lam * nxt)
            rets[t] = nxt
        return torch.stack(rets)

    def actor_loss(self, actor_params, critic_target, params, feat_flat,
                   draws):
        """REINFORCE on imagined λ-returns; the aux carries the imagined
        data (detached) so the critic trains on the same rollouts."""
        cfg = self.config
        feats, logps, ents = self.imagine(params, actor_params, feat_flat,
                                          draws)
        r_im = _elu_mlp(params["reward"], feats[1:])[..., 0]
        c_im = torch.sigmoid(_elu_mlp(params["cont"], feats[1:])[..., 0])
        v_t = _elu_mlp(critic_target, feats)[..., 0]
        rets = self.lambda_returns(r_im, c_im, v_t.detach())
        # discount weights: the probability the trajectory is alive
        w = torch.cumprod(torch.cat([torch.ones_like(c_im[:1]),
                                     cfg.gamma * c_im[:-1]]), 0).detach()
        adv = (rets - v_t[:-1]).detach()
        a_l = -(w * (logps * adv + cfg.entropy_coeff * ents)).mean()
        return a_l, {"feats": feats.detach(), "rets": rets.detach(),
                     "w": w}

    # -- the iteration ------------------------------------------------------
    @torch.no_grad()
    def collect(self, draws: Optional[List[Draws]] = None
                ) -> Dict[str, torch.Tensor]:
        """One [T]-step sequence per env with the latent actor, into the
        buffer.  → the [T, E] ``reward`` and ``done``."""
        cfg = self.config
        if draws is None:
            draws = self.collect_draws()
        obs, h = self.obs, self.h
        frames = {"obs": [], "action": [], "reward": [], "done": []}
        for t in range(cfg.seq_len):
            d = draws[t]
            qm, qs = self._post(self.params, h, obs)
            zn = qm + qs * d["z"]
            logits = _elu_mlp(self.actor_params, torch.cat([h, zn], -1))
            a = torch.argmax(logits + d["gumbel"], -1)
            self.env_states, next_obs, reward, done = self.env.step_given(
                self.env_states, a, d["reset"])
            for k, v in (("obs", obs), ("action", a), ("reward", reward),
                         ("done", done.float())):
                frames[k].append(v)
            # advance the deterministic state; reset on done
            h = self._step_deter(self.params, zn, a, h) \
                * (1.0 - done.float())[..., None]
            obs = next_obs
        self.obs, self.h = obs, h
        rows = {k: torch.stack(v, 1) for k, v in frames.items()}
        replay.add_batch(self.buffer, rows, cfg.num_envs)
        return {"reward": rows["reward"].T, "done": rows["done"].T}

    def learn(self, draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """The world-model and actor-critic updates behind the learn-start
        gate (nothing below it).  → the last losses and the imagined
        return (tensors, not yet read; 0 below the gate)."""
        cfg = self.config
        zero = torch.zeros((), device=self.device)
        if self.buffer["size"] < cfg.learn_start:
            return {"model_loss": zero, "actor_loss": zero,
                    "critic_loss": zero, "imagined_return": zero}
        if draws is None:
            draws = self.learn_draws()
        feat = torch.zeros((cfg.batch_size, cfg.seq_len,
                            cfg.deter_size + cfg.stoch_size),
                           device=self.device)
        for d in draws["model"]:
            batch, _ = replay.sample(self.buffer, cfg.batch_size,
                                     draw={"idx": d["idx"]})
            m_loss, aux, grads = value_and_grad(self.model_loss, self.params,
                                                batch, d["z"])
            self.model_opt.update(grads, self.model_opt_state, self.params)
            # only the last batch's features seed imagination
            feat = aux["feat"]
        feat_flat = feat.reshape(-1, feat.shape[-1])
        for d in draws["ac"]:
            a_loss, im, a_grads = value_and_grad(
                self.actor_loss, self.actor_params, self.critic_target,
                self.params, feat_flat, d)
            self.actor_opt.update(a_grads, self.actor_opt_state,
                                  self.actor_params)

            def critic_loss(cp):
                v = _elu_mlp(cp, im["feats"][:-1])[..., 0]
                return (im["w"] * (v - im["rets"]) ** 2).mean(), None

            c_loss, _, c_grads = value_and_grad(critic_loss,
                                                self.critic_params)
            self.critic_opt.update(c_grads, self.critic_opt_state,
                                   self.critic_params)
            polyak(self.critic_target, self.critic_params, cfg.critic_tau)
        return {"model_loss": m_loss, "actor_loss": a_loss,
                "critic_loss": c_loss, "imagined_return": im["rets"].mean()}

    def training_step(self, draws: Optional[Draws] = None) -> Dict[str, Any]:
        """`collect` then `learn`; ``draws``: ``{"collect": [...],
        "learn": {...}}`` (tests), else the generator."""
        cfg = self.config
        t0 = time.perf_counter()
        traj = self.collect(None if draws is None else draws["collect"])
        metrics = self.learn(None if draws is None else draws["learn"])
        # the iteration's one read of the device
        values = torch.stack(list(metrics.values())).tolist()
        self._track_episodes(traj["reward"].cpu().numpy(),
                             traj["done"].cpu().numpy())
        dt = time.perf_counter() - t0
        steps = cfg.num_envs * cfg.seq_len
        out = dict(zip(metrics, values))
        out.update({"buffer_size": self.buffer["size"],
                    "episode_reward_mean": self.episode_reward_mean(),
                    "env_steps_this_iter": steps,
                    "env_steps_per_s": steps / dt})
        return out

    # -- checkpointing ------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "actor_params": tree_to_numpy(self.actor_params),
                "critic_params": tree_to_numpy(self.critic_params),
                "critic_target": tree_to_numpy(self.critic_target),
                "iteration": self.iteration,
                "env_steps_total": self._total_env_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        dev = self.device
        self.params = tree_from_numpy(state["params"], dev)
        self.actor_params = tree_from_numpy(state["actor_params"], dev)
        self.critic_params = tree_from_numpy(state["critic_params"], dev)
        self.critic_target = tree_from_numpy(
            state.get("critic_target", state["critic_params"]), dev)
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("env_steps_total", 0)
