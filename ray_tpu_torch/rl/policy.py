"""Actor-critic policies (counterpart of ``ray_tpu/rl/policy.py``).

Plain functions over a params tree of tensors, as in
``models/transformer.py``, with the JAX package's tree layout (``torso``,
``pi``, ``vf``; ``lstm``; ``convs``) and its arithmetic, batched: every
call takes ``obs [B, ...]``.  Discrete heads give logits, continuous heads
(mean, log_std) with log_std clipped to [-5, 2].

Sampling takes its noise as an argument or draws it from a generator:
a discrete action is argmax(logits + Gumbel noise), which is what
``jax.random.categorical`` computes, and a continuous one mean +
exp(log_std) * eps with eps standard normal, so tests can pass the JAX
package's ``jax.random.gumbel`` / ``jax.random.normal`` draws.

Two layouts differ from the JAX package's, on purpose: conv kernels are
OIHW (the JAX package keeps HWIO; `convert.policy_params_from_numpy`
permutes them once), and the conv torso runs NCHW but flattens its features
in the JAX package's NHWC order, so the MLP head's weights line up.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

Params = Any
_LOG_2PI = math.log(2 * math.pi)


def gumbel(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws: ``argmax(logits + gumbel)`` samples the
    categorical of ``logits``, as ``jax.random.categorical`` does."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def mlp_init(gen: torch.Generator, sizes: Sequence[int]
             ) -> List[Dict[str, torch.Tensor]]:
    """He-initialized dense stack: [{w, b}] per layer."""
    return [{"w": _normal(gen, (a, b), math.sqrt(2.0 / a)),
             "b": torch.zeros(b, device=gen.device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_shapes(sizes: Sequence[int]) -> List[Dict[str, tuple]]:
    """The shapes of an mlp_init stack."""
    return [{"w": (a, b), "b": (b,)} for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params: List[Dict[str, torch.Tensor]], x: torch.Tensor,
              activation=torch.tanh) -> torch.Tensor:
    """Apply an mlp_init stack; activation on all but the output layer."""
    for layer in params[:-1]:
        x = activation(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_to_numpy(tree):
    """A copy of a tree's tensors as numpy arrays (the updates change
    params in place; a snapshot must not follow them)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True).numpy(), tree)


def tree_from_numpy(tree, device) -> Any:
    """Arrays (from `tree_to_numpy`) copied into new tensors on
    ``device``."""
    return tree_map(lambda w: torch.tensor(np.asarray(w), device=device),
                    tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, dict keys sorted (the order
    ``jax.tree_util.tree_leaves`` gives)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class MLPPolicy:
    def __init__(self, obs_size: int, action_size: int, *,
                 discrete: bool = True, hidden: Sequence[int] = (64, 64),
                 device: DeviceLike = None):
        self.obs_size = obs_size
        self.action_size = action_size
        self.discrete = discrete
        self.hidden = tuple(hidden)
        self.device = resolve_device(device)

    @property
    def _n_out(self) -> int:
        return self.action_size if self.discrete else 2 * self.action_size

    # -- params -------------------------------------------------------------
    def param_shapes(self) -> Params:
        sizes = (self.obs_size,) + self.hidden
        return {"torso": mlp_shapes(sizes),
                "pi": {"w": (sizes[-1], self._n_out), "b": (self._n_out,)},
                "vf": {"w": (sizes[-1], 1), "b": (1,)}}

    def init(self, gen: torch.Generator) -> Params:
        """Parameters drawn from ``gen`` (on this policy's device), in the
        JAX init's distributions."""
        sizes = (self.obs_size,) + self.hidden
        return {
            "torso": mlp_init(gen, sizes),
            "pi": {"w": _normal(gen, (sizes[-1], self._n_out), 0.01),
                   "b": torch.zeros(self._n_out, device=gen.device)},
            "vf": {"w": _normal(gen, (sizes[-1], 1), 1.0),
                   "b": torch.zeros(1, device=gen.device)},
        }

    # -- forward ------------------------------------------------------------
    def _torso(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for layer in params["torso"]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        return x

    def _heads(self, params: Params, x: torch.Tensor):
        pi = x @ params["pi"]["w"] + params["pi"]["b"]
        v = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
        return pi, v

    def forward(self, params: Params, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (policy head output [B, n_out], value [B])."""
        return self._heads(params, self._torso(params, obs))

    # -- distributions ------------------------------------------------------
    def draw_noise(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """Sampling noise for ``n`` actions: Gumbel (discrete) or standard
        normal (continuous), [n, action_size]."""
        shape = (n, self.action_size)
        if self.discrete:
            return gumbel(shape, gen)
        return torch.randn(shape, generator=gen, device=gen.device)

    def _sample_from(self, pi: torch.Tensor, noise: torch.Tensor):
        """Head output and noise → (action, logp)."""
        if self.discrete:
            action = torch.argmax(pi + noise, dim=-1)
            logp = torch.log_softmax(pi, dim=-1).gather(
                -1, action[..., None])[..., 0]
            return action, logp
        mean, log_std = pi.chunk(2, dim=-1)
        log_std = log_std.clamp(-5.0, 2.0)
        action = mean + torch.exp(log_std) * noise
        return action, self._gauss_logp(mean, log_std, action)

    def _logp_entropy_from(self, pi: torch.Tensor, action: torch.Tensor):
        """Head output + taken action → (logp, entropy)."""
        if self.discrete:
            logp_all = torch.log_softmax(pi, dim=-1)
            logp = logp_all.gather(-1, action.long()[..., None])[..., 0]
            entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
            return logp, entropy
        mean, log_std = pi.chunk(2, dim=-1)
        log_std = log_std.clamp(-5.0, 2.0)
        logp = self._gauss_logp(mean, log_std, action)
        entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
        return logp, entropy

    def sample_action(self, params: Params, obs: torch.Tensor,
                      gen: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
        """→ (action, logp, value); the noise is given or drawn from
        ``gen``."""
        pi, v = self.forward(params, obs)
        if noise is None:
            noise = self.draw_noise(obs.shape[0], gen)
        action, logp = self._sample_from(pi, noise)
        return action, logp, v

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor):
        """→ (logp, entropy, value) for PPO updates."""
        pi, v = self.forward(params, obs)
        logp, entropy = self._logp_entropy_from(pi, action)
        return logp, entropy, v

    @staticmethod
    def _gauss_logp(mean, log_std, action):
        var = torch.exp(2 * log_std)
        return (-((action - mean) ** 2) / (2 * var) - log_std
                - 0.5 * _LOG_2PI).sum(-1)

    def get_weights(self, params: Params):
        """A copy of the params as numpy arrays (this package's layout): the
        update changes the params in place, a snapshot must not change."""
        return tree_to_numpy(params)

    def set_weights(self, params: Params, weights):
        """``weights`` (from `get_weights`) copied into new tensors on this
        policy's device."""
        return tree_from_numpy(weights, self.device)


class LSTMPolicy(MLPPolicy):
    """Recurrent actor-critic: MLP torso → LSTM cell → pi/vf heads.

    The cell is written out as the JAX package writes it: the gates come
    from one product split as ``i, f, g, o``, and the forget gate adds 1.0
    inside its sigmoid (`nn.LSTMCell` does neither).  The state is an
    ``(h, c)`` pair carried by the caller; rollouts zero it where an
    episode ends, and the sequence update replays the recurrence from the
    segment's initial state (`log_prob_seq`)."""

    is_recurrent = True

    def __init__(self, obs_size: int, action_size: int, *,
                 discrete: bool = True, hidden: Sequence[int] = (64,),
                 lstm_size: int = 64, device: DeviceLike = None):
        super().__init__(obs_size, action_size, discrete=discrete,
                         hidden=hidden, device=device)
        self.lstm_size = lstm_size

    def param_shapes(self) -> Params:
        shapes = super().param_shapes()
        in_dim = ((self.obs_size,) + self.hidden)[-1] + self.lstm_size
        shapes["lstm"] = {"w": (in_dim, 4 * self.lstm_size),
                          "b": (4 * self.lstm_size,)}
        shapes["pi"]["w"] = (self.lstm_size, self._n_out)
        shapes["vf"]["w"] = (self.lstm_size, 1)
        return shapes

    def init(self, gen: torch.Generator) -> Params:
        sizes = (self.obs_size,) + self.hidden
        in_dim = sizes[-1] + self.lstm_size
        return {
            "torso": mlp_init(gen, sizes),
            "lstm": {"w": _normal(gen, (in_dim, 4 * self.lstm_size),
                                  math.sqrt(1.0 / in_dim)),
                     "b": torch.zeros(4 * self.lstm_size, device=gen.device)},
            "pi": {"w": _normal(gen, (self.lstm_size, self._n_out), 0.01),
                   "b": torch.zeros(self._n_out, device=gen.device)},
            "vf": {"w": _normal(gen, (self.lstm_size, 1), 1.0),
                   "b": torch.zeros(1, device=gen.device)},
        }

    def initial_state(self, batch_size: int):
        z = torch.zeros(batch_size, self.lstm_size, device=self.device)
        return (z, z.clone())

    def _cell(self, params: Params, x: torch.Tensor, state):
        h, c = state
        z = torch.cat([x, h], dim=-1) @ params["lstm"]["w"] \
            + params["lstm"]["b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    def step_recurrent(self, params: Params, obs: torch.Tensor, state):
        """One timestep of a batch: → (pi head, value, new_state)."""
        h, state = self._cell(params, self._torso(params, obs), state)
        pi, v = self._heads(params, h)
        return pi, v, state

    def sample_action_recurrent(self, params: Params, obs: torch.Tensor,
                                state, gen: Optional[torch.Generator] = None,
                                noise: Optional[torch.Tensor] = None):
        """→ (action, logp, value, new_state)."""
        pi, v, state = self.step_recurrent(params, obs, state)
        if noise is None:
            noise = self.draw_noise(obs.shape[0], gen)
        action, logp = self._sample_from(pi, noise)
        return action, logp, v, state

    def log_prob_seq(self, params: Params, obs_seq: torch.Tensor,
                     action_seq: torch.Tensor, done_seq: torch.Tensor,
                     init_state):
        """Replay the rollout's recurrence: [T, B, ...] sequences + the
        segment's initial state → (logp, entropy, value), each [T, B].  The
        state resets after a done step, as in the rollout."""
        state = init_state
        logps, ents, values = [], [], []
        for t in range(obs_seq.shape[0]):
            pi, v, state = self.step_recurrent(params, obs_seq[t], state)
            logp, ent = self._logp_entropy_from(pi, action_seq[t])
            keep = (1.0 - done_seq[t].float())[..., None]
            state = (state[0] * keep, state[1] * keep)
            logps.append(logp)
            ents.append(ent)
            values.append(v)
        return torch.stack(logps), torch.stack(ents), torch.stack(values)

    def forward(self, params: Params, obs: torch.Tensor):
        raise TypeError("LSTMPolicy.forward needs a recurrent state; use "
                        "step_recurrent(params, obs, state)")


class ConvPolicy(MLPPolicy):
    """Conv-torso actor-critic for image observations.

    Observations arrive flat in (H, W, C) order; the torso views them as
    ``[B, H, W, C]``, runs the conv stack (``conv_filters``: [(out_channels,
    kernel, stride), ...], VALID padding, tanh) in NCHW, and flattens the
    features back in (H, W, C) order into the inherited MLP torso and
    heads."""

    def __init__(self, obs_shape, action_size: int, *,
                 discrete: bool = True,
                 conv_filters: Sequence[Tuple[int, int, int]] = (
                     (16, 3, 1), (32, 3, 1)),
                 hidden: Sequence[int] = (64,), device: DeviceLike = None):
        self.obs_shape = tuple(obs_shape)           # (H, W, C)
        self.conv_filters = tuple(conv_filters)
        h, w, c = self.obs_shape
        for (out_c, ksize, stride) in self.conv_filters:
            h = (h - ksize) // stride + 1
            w = (w - ksize) // stride + 1
            c = out_c
        self._feat_size = h * w * c
        super().__init__(self._feat_size, action_size, discrete=discrete,
                         hidden=tuple(hidden), device=device)

    def param_shapes(self) -> Params:
        shapes = super().param_shapes()
        convs, in_c = [], self.obs_shape[-1]
        for out_c, ksize, _ in self.conv_filters:
            convs.append({"w": (out_c, in_c, ksize, ksize), "b": (out_c,)})
            in_c = out_c
        shapes["convs"] = convs
        return shapes

    def init(self, gen: torch.Generator) -> Params:
        convs, in_c = [], self.obs_shape[-1]
        for out_c, ksize, _ in self.conv_filters:
            fan_in = ksize * ksize * in_c
            convs.append({"w": _normal(gen, (out_c, in_c, ksize, ksize),
                                       math.sqrt(2.0 / fan_in)),
                          "b": torch.zeros(out_c, device=gen.device)})
            in_c = out_c
        params = super().init(gen)
        params["convs"] = convs
        return params

    def _torso(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        x = obs.reshape((-1,) + self.obs_shape).permute(0, 3, 1, 2)
        for layer, (_o, _k, stride) in zip(params["convs"],
                                           self.conv_filters):
            x = torch.tanh(F.conv2d(x, layer["w"], layer["b"],
                                    stride=stride))
        # the JAX package's NHWC flatten order, which its head expects
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return super()._torso(params, x)
