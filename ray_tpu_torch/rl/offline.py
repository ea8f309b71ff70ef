"""Offline RL: datasets of experience, behavioural cloning, MARWIL, CQL,
CRR and importance-sampling estimation (counterpart of
``ray_tpu/rl/offline.py``).

Datasets are columnar numpy batches, as in the JAX package, and ``.npz``
files in its format (the same column names and dtypes), so a file either
package writes loads in the other.  An algorithm copies the columns to the
card once; an epoch is a loop over the minibatches of one permutation of
the rows (the JAX package's ``lax.scan``), each an Adam step, and reads
the device once, for its mean losses.  Permutations come from the
algorithm's `torch.Generator` or as an argument (``training_step(perms)``,
one [n] permutation an epoch), so tests can give both packages the same
ones.

``action_fn()`` is the JAX package's: CQL and CRR act greedily (argmax);
BC and MARWIL sample from the policy, because the JAX ``action_fn`` calls
``policy.greedy_action`` only where the policy has one and ``MLPPolicy``
has none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .algorithm import Algorithm
from .dqn import QNetwork, dqn_target
from .env import TorchEnv
from .learner import polyak, value_and_grad
from .policy import (MLPPolicy, mlp_apply, mlp_init, mlp_shapes,
                     tree_from_numpy, tree_map, tree_to_numpy)
from .ppo import Adam


# ------------------------------------------------------------------ datasets
def collect_dataset(env_factory: Callable[..., TorchEnv], policy_fn, *,
                    n_steps: int, num_envs: int = 32, seed: int = 0,
                    device=None, draws=None) -> Dict[str, np.ndarray]:
    """Roll a (possibly scripted) policy over ``num_envs`` envs for
    ``ceil(n_steps / num_envs)`` steps and record columnar experience.

    ``policy_fn(obs [B, obs], draws) -> actions [B]`` acts on the batch;
    its ``draws`` are ``draws["steps"][t]["policy"]`` when the caller gives
    ``draws`` (``{"reset": the first reset's draws, "steps": [{"policy",
    "reset"}, ...]}``), else the collector's generator.  Returns env-major
    flattened columns cut to ``n_steps`` rows: obs, action, reward, done,
    next_obs, and ``env_id``, which marks the block junctions (each env's
    trailing partial episode has done 0, so episode reconstruction needs
    it).  The trajectory stays on the device until its one copy to the
    host."""
    dev = resolve_device(device)
    env = env_factory(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    states, obs = env.reset_given(draws["reset"] if draws is not None
                                  else env.reset_draws(num_envs, gen))
    steps = -(-n_steps // num_envs)
    frames = []
    with torch.no_grad():
        for t in range(steps):
            d = draws["steps"][t] if draws is not None else None
            actions = policy_fn(obs, d["policy"] if d is not None else gen)
            reset = (d["reset"] if d is not None
                     else env.reset_draws(num_envs, gen))
            states, next_obs, rewards, dones = env.step_given(
                states, actions, reset)
            frames.append({"obs": obs, "action": actions, "reward": rewards,
                           "done": dones, "next_obs": next_obs})
            obs = next_obs
    flat = {}
    for k in frames[0]:
        v = torch.stack([f[k] for f in frames]).transpose(0, 1)  # [B, T]
        v = v.reshape((-1,) + v.shape[2:])[:n_steps].cpu().numpy()
        if k == "action" and env.discrete:
            v = v.astype(np.int32)        # the JAX package's action dtype
        flat[k] = v
    flat["env_id"] = np.repeat(np.arange(num_envs), steps)[:n_steps]
    return flat


def save_dataset(path: str, batch: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **batch)


def load_dataset(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_EPOCHS = ("epochs_per_iter must be >= 1 (a zero-epoch iteration would "
           "report no loss)")


def _rows(ds, batch_size: int, check: bool) -> int:
    """The rows an epoch covers: whole minibatches only."""
    n = (len(ds["obs"]) // batch_size) * batch_size
    if check and n == 0:
        raise ValueError(
            f"dataset has {len(ds['obs'])} rows < batch_size={batch_size}: "
            f"an epoch would run zero minibatches and train nothing")
    return n


def _columns(ds, n: int, device, keys=("obs", "action", "reward",
                                       "next_obs", "done")):
    """The first ``n`` rows of the dataset's columns on ``device``;
    floats as float32, actions as stored."""
    out = {}
    for k in keys:
        col = np.asarray(ds[k][:n])
        if k != "action":
            col = col.astype(np.float32)
        out[k] = torch.as_tensor(col, device=device)
    return out


def _sampler(policy: MLPPolicy, params):
    """``act(obs, gen=None, noise=None)``: actions sampled from the
    policy, with the given noise or from ``gen``."""
    def act(obs, gen=None, noise=None):
        with torch.no_grad():
            return policy.sample_action(params, obs, gen, noise)[0]
    return act


class _OfflineAlgorithm(Algorithm):
    """An epoch over permuted minibatches of a dataset on the device."""

    def _setup(self, required: str):
        cfg = self.config
        if cfg.env is None or cfg.dataset is None:
            raise ValueError(required)
        if cfg.epochs_per_iter < 1:
            raise ValueError(_EPOCHS)
        self.device = resolve_device(cfg.device)
        self.env = cfg.env(device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def _minibatches(self, perm):
        """Row index blocks [n_mb, batch_size] of one epoch."""
        n, b = self._n, self.config.batch_size
        if perm is None:
            perm = torch.randperm(n, generator=self.generator,
                                  device=self.device)
        return perm.view(n // b, b)

    def _epochs(self, step, perms, n_parts: int):
        """``epochs_per_iter`` epochs of ``step(rows) -> [n_parts losses]``;
        → the last epoch's parts [n_parts], each the mean over its
        minibatches, not yet read (NaN where the dataset holds no whole
        minibatch, as the JAX package's empty scan gives)."""
        parts = None
        for e in range(self.config.epochs_per_iter):
            per_mb = [torch.stack(step(rows)) for rows in self._minibatches(
                None if perms is None else perms[e])]
            parts = (torch.stack(per_mb).mean(0) if per_mb
                     else torch.full((n_parts,), float("nan"),
                                     device=self.device))
        return parts


# ------------------------------------------------------ behavioural cloning
@dataclasses.dataclass
class BCConfig:
    # env factory, called as env(device=...)
    env: Optional[Callable[..., TorchEnv]] = None
    dataset: Optional[Dict[str, np.ndarray]] = None
    lr: float = 1e-3
    batch_size: int = 256
    epochs_per_iter: int = 1
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the dataset and the policy live (None: the card)
    device: Any = None

    def build(self) -> "BC":
        return BC(self)


class BC(_OfflineAlgorithm):
    """Behavioural cloning: maximize log pi(a|s) over the dataset."""

    _config_cls = BCConfig

    def __init__(self, config: BCConfig):
        super().__init__(config)
        self._setup("BCConfig.env and BCConfig.dataset required")
        self.policy = MLPPolicy(self.env.observation_size,
                                self.env.action_size,
                                discrete=self.env.discrete,
                                hidden=config.hidden, device=self.device)
        self.params = self.policy.init(self.generator)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._n = _rows(config.dataset, config.batch_size, check=False)
        self._data = _columns(config.dataset, self._n, self.device,
                              keys=("obs", "action"))

    def _loss(self, params, obs, action):
        logp, _, _ = self.policy.log_prob(params, obs, action)
        return -torch.mean(logp), None

    def _step(self, rows):
        loss, _, grads = value_and_grad(self._loss, self.params,
                                        self._data["obs"][rows],
                                        self._data["action"][rows])
        self.optimizer.update(grads, self.opt_state, self.params)
        return [loss]

    def training_step(self, perms=None) -> Dict[str, Any]:
        # the iteration's one read of the device
        (loss,) = self._epochs(self._step, perms, 1).tolist()
        return {"bc_loss": loss, "env_steps_this_iter": 0}

    def action_fn(self):
        """The policy for deployment and evaluation (it samples, see the
        module's docstring)."""
        return _sampler(self.policy, self.params)

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.policy.get_weights(self.params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = self.policy.set_weights(self.params, state["params"])
        self.iteration = state.get("iteration", 0)


# ------------------------------------------------------------- MARWIL
@dataclasses.dataclass
class MARWILConfig:
    # env factory, called as env(device=...)
    env: Optional[Callable[..., TorchEnv]] = None
    dataset: Optional[Dict[str, np.ndarray]] = None
    beta: float = 1.0              # advantage-weighting temperature;
    #   beta=0 degenerates to BC
    gamma: float = 0.99
    vf_coeff: float = 1.0
    weight_clip: float = 20.0      # cap on exp(beta * A / c)
    lr: float = 1e-3
    batch_size: int = 256
    epochs_per_iter: int = 1
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the dataset and the networks live (None: the card)
    device: Any = None

    def build(self) -> "MARWIL":
        return MARWIL(self)


class MARWIL(_OfflineAlgorithm):
    """Monotonic Advantage Re-Weighted Imitation Learning: behavioural
    cloning weighted by ``exp(beta * A / c)`` (capped), with a jointly
    learned value function.  Advantages are one-step TD residuals against
    the learned V, normalized by a running root mean square ``c`` updated
    after every minibatch."""

    _config_cls = MARWILConfig

    def __init__(self, config: MARWILConfig):
        super().__init__(config)
        self._setup("MARWILConfig.env and MARWILConfig.dataset required")
        self.policy = MLPPolicy(self.env.observation_size,
                                self.env.action_size,
                                discrete=self.env.discrete,
                                hidden=config.hidden, device=self.device)
        self.params = {
            "pi": self.policy.init(self.generator),
            "v": mlp_init(self.generator, (self.env.observation_size,)
                          + tuple(config.hidden) + (1,))}
        self.adv_rms = torch.ones((), device=self.device)  # sqrt(E[A^2])
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._n = _rows(config.dataset, config.batch_size, check=True)
        self._data = _columns(config.dataset, self._n, self.device)

    def param_shapes(self):
        """The params tree's shapes (`convert.policy_params_from_numpy`)."""
        return {"pi": self.policy.param_shapes(),
                "v": mlp_shapes((self.env.observation_size,)
                                + tuple(self.config.hidden) + (1,))}

    def _loss(self, p, batch):
        cfg = self.config
        v = mlp_apply(p["v"], batch["obs"])[..., 0]
        with torch.no_grad():
            v_next = mlp_apply(p["v"], batch["next_obs"])[..., 0]
            target = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) \
                * v_next
        vf_loss = torch.mean((v - target) ** 2)
        adv = (target - v).detach()
        weights = torch.clamp(torch.exp(
            cfg.beta * adv / torch.clamp(self.adv_rms, min=1e-6)),
            max=cfg.weight_clip)
        logp, _, _ = self.policy.log_prob(p["pi"], batch["obs"],
                                          batch["action"])
        pi_loss = -torch.mean(weights * logp)
        return pi_loss + cfg.vf_coeff * vf_loss, (pi_loss, vf_loss, adv)

    def _step(self, rows):
        batch = {k: v[rows] for k, v in self._data.items()}
        _, (pi_loss, vf_loss, adv), grads = value_and_grad(
            self._loss, self.params, batch)
        # the running RMS of the advantages (the reference's moving
        # average of c^2)
        self.adv_rms = torch.sqrt(0.99 * self.adv_rms ** 2
                                  + 0.01 * torch.mean(adv ** 2))
        self.optimizer.update(grads, self.opt_state, self.params)
        return [pi_loss, vf_loss]

    def training_step(self, perms=None) -> Dict[str, Any]:
        parts = self._epochs(self._step, perms, 2)
        # the iteration's one read of the device
        pi_loss, vf_loss, adv_rms = torch.cat(
            [parts, self.adv_rms.view(1)]).tolist()
        return {"policy_loss": pi_loss, "vf_loss": vf_loss,
                "adv_rms": adv_rms, "env_steps_this_iter": 0}

    def action_fn(self):
        """The policy for deployment and evaluation (it samples, see the
        module's docstring)."""
        return _sampler(self.policy, self.params["pi"])

    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "adv_rms": float(self.adv_rms),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.adv_rms = torch.tensor(float(state.get("adv_rms", 1.0)),
                                    device=self.device)
        self.iteration = state.get("iteration", 0)


# ------------------------------------------------------ conservative Q
@dataclasses.dataclass
class CQLConfig:
    # env factory, called as env(device=...)
    env: Optional[Callable[..., TorchEnv]] = None
    dataset: Optional[Dict[str, np.ndarray]] = None
    lr: float = 1e-3
    batch_size: int = 256
    epochs_per_iter: int = 1
    gamma: float = 0.99
    tau: float = 0.01              # Polyak target-average rate
    cql_alpha: float = 1.0         # conservative-penalty weight
    double_q: bool = True
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the dataset and the networks live (None: the card)
    device: Any = None

    def build(self) -> "CQL":
        return CQL(self)


class CQL(_OfflineAlgorithm):
    """Conservative Q-Learning, discrete actions: (double-)DQN TD learning
    on the fixed dataset plus ``alpha * E[logsumexp_a Q(s, a) - Q(s,
    a_data)]``, which pushes down the values of actions the dataset never
    took; Polyak after every minibatch."""

    _config_cls = CQLConfig

    def __init__(self, config: CQLConfig):
        super().__init__(config)
        self._setup("CQLConfig.env and CQLConfig.dataset required")
        if not self.env.discrete:
            raise ValueError("this CQL implementation is discrete-action "
                             "(the reference's continuous variant adds "
                             "an SAC actor)")
        self.q = QNetwork(self.env.observation_size, self.env.action_size,
                          hidden=config.hidden, device=self.device)
        self.params = self.q.init(self.generator)
        self.target_params = tree_map(torch.clone, self.params)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._n = _rows(config.dataset, config.batch_size, check=False)
        self._data = _columns(config.dataset, self._n, self.device)
        self._data["action"] = self._data["action"].long()

    def _loss(self, p, batch):
        cfg = self.config
        qvals = self.q.apply(p, batch["obs"])                   # [B, A]
        q_sa = qvals.gather(-1, batch["action"][:, None])[:, 0]
        target = dqn_target(self.q.apply, p, self.target_params,
                            batch["reward"], batch["next_obs"],
                            batch["done"], cfg.gamma, cfg.double_q)
        # the conservative term: push down out-of-distribution values
        cql = torch.mean(torch.logsumexp(qvals, dim=-1) - q_sa)
        return torch.mean((q_sa - target) ** 2) + cfg.cql_alpha * cql, cql

    def _step(self, rows):
        batch = {k: v[rows] for k, v in self._data.items()}
        loss, cql, grads = value_and_grad(self._loss, self.params, batch)
        self.optimizer.update(grads, self.opt_state, self.params)
        polyak(self.target_params, self.params, self.config.tau)
        return [loss, cql]

    def training_step(self, perms=None) -> Dict[str, Any]:
        # the iteration's one read of the device
        loss, cql = self._epochs(self._step, perms, 2).tolist()
        return {"cql_loss": loss, "cql_gap": cql, "env_steps_this_iter": 0}

    def action_fn(self):
        """The greedy policy: ``act(obs) -> argmax_a Q(obs, a)``."""
        q, params = self.q, self.params

        def act(obs, gen=None):
            with torch.no_grad():
                return torch.argmax(q.apply(params, obs), dim=-1)
        return act

    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "target_params": tree_to_numpy(self.target_params),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.target_params = tree_from_numpy(state["target_params"],
                                             self.device)
        self.iteration = state.get("iteration", 0)


def importance_sampling_estimate(policy: MLPPolicy, params,
                                 episodes: Dict[str, np.ndarray],
                                 behavior_logp: np.ndarray,
                                 gamma: float = 0.99,
                                 weighted: bool = True) -> Dict[str, float]:
    """Per-episode (weighted) importance-sampling estimate of the target
    policy's value from behaviour data.  ``episodes``' obs / action /
    reward / done columns delimit episodes by ``done``; ``behavior_logp``
    are the behaviour policy's log-probs of the logged actions.  The
    target log-probs are computed on the policy's device and read once;
    the per-episode products run on the host in float64."""
    dev = policy.device
    with torch.no_grad():
        logp, _, _ = policy.log_prob(
            params, torch.as_tensor(np.asarray(episodes["obs"]), device=dev),
            torch.as_tensor(np.asarray(episodes["action"]), device=dev))
    ratios = np.exp(logp.cpu().numpy() - behavior_logp)
    rewards, dones = episodes["reward"], episodes["done"]
    ep_returns, ep_weights = [], []
    w, ret, disc = 1.0, 0.0, 1.0
    for t in range(len(rewards)):
        w *= float(ratios[t])
        ret += disc * float(rewards[t])
        disc *= gamma
        if dones[t]:
            ep_returns.append(ret)
            ep_weights.append(w)
            w, ret, disc = 1.0, 0.0, 1.0
    if not ep_returns:
        ep_returns, ep_weights = [ret], [w]
    ep_returns = np.asarray(ep_returns)
    ep_weights = np.asarray(ep_weights)
    if weighted:
        denom = max(ep_weights.sum(), 1e-8)
        v = float((ep_weights * ep_returns).sum() / denom)
    else:
        v = float((ep_weights * ep_returns).mean())
    return {"v_target": v,
            "v_behavior": float(ep_returns.mean()),
            "num_episodes": int(len(ep_returns)),
            "mean_ratio": float(ratios.mean())}


# ------------------------------------------------- critic-regularized
@dataclasses.dataclass
class CRRConfig:
    # env factory, called as env(device=...)
    env: Optional[Callable[..., TorchEnv]] = None
    dataset: Optional[Dict[str, np.ndarray]] = None
    weight_fn: str = "binary"      # "binary" (1[A>0]) | "exp"
    beta: float = 1.0              # exp-weight temperature
    weight_clip: float = 20.0      # cap on exp weights
    gamma: float = 0.99
    tau: float = 0.01              # Polyak target-average rate
    lr: float = 1e-3
    batch_size: int = 256
    epochs_per_iter: int = 1
    hidden: tuple = (64, 64)
    seed: int = 0
    # where the dataset and the networks live (None: the card)
    device: Any = None

    def build(self) -> "CRR":
        return CRR(self)


class CRR(_OfflineAlgorithm):
    """Critic-Regularized Regression, discrete actions: a Q critic TD-
    trained against the current policy's expected target value, and an
    actor that clones only the transitions the critic approves (weight
    ``1[A > 0]``, "binary", or ``exp(A / beta)`` capped, "exp"), ``A(s, a)
    = Q(s, a) - E_{a~pi} Q(s, a)``."""

    _config_cls = CRRConfig

    def __init__(self, config: CRRConfig):
        super().__init__(config)
        self._setup("CRRConfig.env and CRRConfig.dataset required")
        if config.weight_fn not in ("binary", "exp"):
            raise ValueError(f"weight_fn={config.weight_fn!r} not in "
                             "('binary', 'exp')")
        if not self.env.discrete:
            raise ValueError("this CRR implementation is discrete-action "
                             "(the reference's continuous variant samples "
                             "the policy for the advantage expectation)")
        obs_dim, n_act = self.env.observation_size, self.env.action_size
        self.policy = MLPPolicy(obs_dim, n_act, discrete=True,
                                hidden=config.hidden, device=self.device)
        self.q = QNetwork(obs_dim, n_act, hidden=config.hidden,
                          device=self.device)
        self.params = {"pi": self.policy.init(self.generator),
                       "q": self.q.init(self.generator)}
        self.target_q = tree_map(torch.clone, self.params["q"])
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._n = _rows(config.dataset, config.batch_size, check=True)
        self._data = _columns(config.dataset, self._n, self.device)
        self._data["action"] = self._data["action"].long()

    def param_shapes(self):
        """The params tree's shapes (`convert.policy_params_from_numpy`)."""
        return {"pi": self.policy.param_shapes(),
                "q": self.q.param_shapes()}

    def weights(self, params, batch):
        """The actor's per-sample weights and the advantages, [B] each
        (no gradient)."""
        cfg = self.config
        with torch.no_grad():
            qvals = self.q.apply(params["q"], batch["obs"])
            q_sa = qvals.gather(-1, batch["action"][:, None])[:, 0]
            pi_cur = torch.softmax(
                self.policy.forward(params["pi"], batch["obs"])[0], dim=-1)
            adv = q_sa - (pi_cur * qvals).sum(-1)
            if cfg.weight_fn == "binary":
                return (adv > 0).float(), adv
            return torch.clamp(torch.exp(adv / cfg.beta),
                               max=cfg.weight_clip), adv

    def _loss(self, p, batch):
        cfg = self.config
        qvals = self.q.apply(p["q"], batch["obs"])               # [B, A]
        q_sa = qvals.gather(-1, batch["action"][:, None])[:, 0]
        with torch.no_grad():
            # the policy's distribution at s' for the expected target
            pi_next = torch.softmax(
                self.policy.forward(p["pi"], batch["next_obs"])[0], dim=-1)
            v_next = (pi_next * self.q.apply(self.target_q,
                                             batch["next_obs"])).sum(-1)
            target = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) \
                * v_next
        critic_loss = torch.mean((q_sa - target) ** 2)
        w, _ = self.weights(p, batch)
        logp, _, _ = self.policy.log_prob(p["pi"], batch["obs"],
                                          batch["action"])
        actor_loss = -torch.mean(w * logp)
        return actor_loss + critic_loss, (actor_loss, critic_loss,
                                          w.mean())

    def _step(self, rows):
        batch = {k: v[rows] for k, v in self._data.items()}
        _, parts, grads = value_and_grad(self._loss, self.params, batch)
        self.optimizer.update(grads, self.opt_state, self.params)
        polyak(self.target_q, self.params["q"], self.config.tau)
        return list(parts)

    def training_step(self, perms=None) -> Dict[str, Any]:
        # the iteration's one read of the device
        a_l, c_l, w_m = self._epochs(self._step, perms, 3).tolist()
        return {"actor_loss": a_l, "critic_loss": c_l,
                "accepted_fraction": w_m, "env_steps_this_iter": 0}

    def action_fn(self):
        """The greedy policy: ``act(obs) -> argmax of the logits``."""
        policy, params = self.policy, self.params["pi"]

        def act(obs, gen=None):
            with torch.no_grad():
                return torch.argmax(policy.forward(params, obs)[0], dim=-1)
        return act

    def get_state(self) -> Dict[str, Any]:
        return {"params": tree_to_numpy(self.params),
                "target_q": tree_to_numpy(self.target_q),
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_from_numpy(state["params"], self.device)
        self.target_q = tree_from_numpy(state["target_q"], self.device)
        self.iteration = state.get("iteration", 0)
