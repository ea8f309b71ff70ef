"""The port's off-policy RL and PG (`ray_tpu_torch.rl`: exploration, replay,
learner, DQN / SimpleQ / Rainbow, R2D2, TD3 / DDPG, SAC, PG) against the
JAX package's on the CPU.

``jax.random`` streams cannot be reproduced, so each comparison gives both
packages the same draws: the test follows the JAX code's split chain from
its key and turns each key into the values it would draw (the explorer's
uniform and randint, the envs' reset draws, the replay's indices or the
Gumbel noise of ``jax.random.categorical``, TD3's smoothing noise, SAC's
action noise), and the port takes those values as arguments.  Weights are
the JAX init carried over with `convert.policy_params_from_numpy`.

Tolerances (fp32), each stated where it is used: forwards, explorers,
returns and targets within rtol 1e-5 (summation order only); the C51
projection and loss within 1e-5 (the port's ``torch.linspace`` support
differs from ``jnp.linspace`` by up to 9.5e-7 an atom); updates over
several Adam steps within rtol 1e-4; integers (actions, indices, cursor,
size) and buffer contents written from the same values exactly.
"""

import dataclasses
import functools
import math
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import rl as jrl
from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import exploration as jexp
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import pg as jpg
from ray_tpu.rl import replay as jreplay
from ray_tpu_torch import rl as trl
from ray_tpu_torch.convert import policy_params_from_numpy
from ray_tpu_torch.rl import dqn as tdqn
from ray_tpu_torch.rl import exploration as texp
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl import pg as tpg
from ray_tpu_torch.rl import replay as treplay
from ray_tpu_torch.rl.policy import tree_leaves
from ray_tpu_torch.train import RLTrainer

RTOL, ATOL = 1e-5, 1e-6          # forwards, explorers, returns, targets
UPD_RTOL, UPD_ATOL = 1e-4, 1e-6  # several Adam steps
C51_TOL = 1e-5                   # projection and loss (the support's bits)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got,
                   dtype=np.float64),
        np.asarray(want, dtype=np.float64), rtol=rtol, atol=atol)


def _equal(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def _tree_close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w, rtol, atol)
    else:
        _close(got, want, rtol, atol)


def _adam_close(tstate, jstate, rtol=UPD_RTOL):
    """The port's Adam state against optax.adam's (its first state)."""
    adam = jstate[0]
    assert tstate["count"] == int(adam.count)
    _tree_close(tstate["mu"], _np(adam.mu), rtol, UPD_ATOL)
    _tree_close(tstate["nu"], _np(adam.nu), rtol, 1e-10)


def _buffer_equal(tbuf, jbuf):
    """Cursor, size, actions and dones exactly; what the envs computed
    (observations, rewards) within rtol 1e-5, as the env steps."""
    assert tbuf["cursor"] == int(jbuf["cursor"])
    assert tbuf["size"] == int(jbuf["size"])
    for k, v in _np(jbuf["data"]).items():
        if k in ("action", "done"):
            _equal(tbuf["data"][k], v)
        else:
            _close(tbuf["data"][k], v)


# -- the JAX side's draws ------------------------------------------------------

def _reset_draws_one(name, key):
    if name == "CartPole":
        return {"obs": jax.random.uniform(key, (4,), minval=-0.05,
                                          maxval=0.05)}
    if name == "MemoryCue":
        return {"cue": jax.random.bernoulli(key)}
    k1, k2 = jax.random.split(key)                       # Pendulum
    return {"th": jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
            "thdot": jax.random.uniform(k2, (), minval=-1.0, maxval=1.0)}


@functools.lru_cache(maxsize=None)
def _jitted(what, *args):
    """One jitted JAX draw function per kind and shape, compiled once for
    the module."""
    if what == "reset":
        return jax.jit(jax.vmap(lambda k: _reset_draws_one(args[0], k)))
    if what == "normal_each":          # one normal [A] per key
        return jax.jit(jax.vmap(lambda k: jax.random.normal(k, (args[0],))))
    if what == "add":                  # a replay insert, size static
        return jax.jit(jreplay.add_batch_prioritized if args[0]
                       else jreplay.add_batch, static_argnums=2)
    if what == "qinit":                # a QNetwork's JAX init
        kind, seed = args
        jq = jdqn.QNetwork(5, 3, hidden=(8, 6), **QNETS[kind])
        return jq, _np(jax.jit(jq.init)(jax.random.PRNGKey(seed)))
    if what == "eps":                  # EpsilonGreedy's two draws
        n, a = args

        def eps(key):
            k_choice, k_rand = jax.random.split(key)
            return (jax.random.uniform(k_choice, (n,)),
                    jax.random.randint(k_rand, (n,), 0, a))
        return jax.jit(eps)
    raise ValueError(what)


def _reset_draws(name, keys):
    return {k: _t(v) for k, v in _jitted("reset", name)(keys).items()}


def _eps_draws(key, n, n_actions):
    u, r = _jitted("eps", n, n_actions)(key)
    return {"uniform": _t(u), "random": _t(r).long()}


def _sample_draw(key, per, batch, size, cap):
    """The draw a JAX replay sample makes from ``key`` (its ``skey``):
    the uniform indices, or the categorical's Gumbel noise [B, capacity]."""
    if per:
        return {"gumbel": _t(jax.random.gumbel(key, (batch, cap)))}
    return {"idx": _t(jax.random.randint(key, (batch,), 0,
                                         max(size, 1))).long()}


def _train(algo, draws):
    """`Algorithm.train` with the iteration's draws."""
    algo.iteration += 1
    res = algo.training_step(draws=draws)
    algo._total_env_steps += res["env_steps_this_iter"]
    return res


def _sync_env(talgo, jalgo, ekey, name):
    n = jalgo.config.num_envs
    talgo.env_states, talgo.obs = talgo.env.reset_given(
        _reset_draws(name, jax.random.split(ekey, n)))
    _close(talgo.obs, jalgo.obs)


# -- exploration ---------------------------------------------------------------

def test_epsilon_greedy_matches_jax():
    """The anneal in float32 exactly, and the actions (greedy ties to the
    first maximum) exactly, at epsilons 1, between and the floor."""
    je, te = jexp.EpsilonGreedy(1.0, 0.05, 1000), texp.EpsilonGreedy(
        1.0, 0.05, 1000)
    rng = np.random.default_rng(0)
    n, a = 64, 4
    q = rng.integers(0, 3, (n, a)).astype(np.float32)   # many ties
    jcall = jax.jit(lambda key, step: je((), key, jnp.asarray(q), step)[1])
    for i, step in enumerate((0, 333, 777, 5000)):
        assert te.epsilon(step) == float(je.epsilon(jnp.float32(step)))
        key = jax.random.PRNGKey(i)
        want = jcall(key, jnp.float32(step))
        _, got = te((), _t(q), step, draws=_eps_draws(key, n, a))
        _equal(got, want)
    assert te.epsilon(5000) == pytest.approx(0.05)


@pytest.mark.parametrize("kind", ["gaussian", "ou", "stochastic",
                                  "continuous"])
def test_noise_and_sampling_explorers_match_jax(kind):
    n, a = 6, 2
    rng = np.random.default_rng(1)
    action = rng.uniform(-1, 1, (n, a)).astype(np.float32)
    if kind == "gaussian":
        je = jexp.GaussianActionNoise(0.3, 0.05, 100, clip=1.0)
        te = texp.GaussianActionNoise(0.3, 0.05, 100, clip=1.0)
        for step in (0, 50, 400):
            assert te.scale(step) == float(je.scale(jnp.float32(step)))
            key = jax.random.PRNGKey(step)
            _, want = je((), key, jnp.asarray(action), jnp.float32(step))
            _, got = te((), _t(action), step, draws={
                "normal": _t(jax.random.normal(key, (n, a)))})
            _close(got, want)
    elif kind == "ou":
        je = jexp.OrnsteinUhlenbeckNoise(a, clip=2.0)
        te = texp.OrnsteinUhlenbeckNoise(a, clip=2.0)
        assert te.init_state().shape == je.init_state().shape == (a,)
        # the batched carrier (TD3 / DDPG) holds one process per env
        js, ts = jnp.zeros((n, a)), torch.zeros(n, a)
        for i in range(3):
            key = jax.random.PRNGKey(10 + i)
            js, want = je(js, key, jnp.asarray(action), 0)
            ts, got = te(ts, _t(action), 0, draws={
                "normal": _t(jax.random.normal(key, (n, a)))})
            _close(ts, js)
            _close(got, want)
    elif kind == "stochastic":
        logits = rng.normal(size=(n, 5)).astype(np.float32)
        key = jax.random.PRNGKey(3)
        _, want = jexp.StochasticSampling(True)((), key, jnp.asarray(logits),
                                                0)
        _, got = texp.StochasticSampling(True)((), _t(logits), 0, draws={
            "gumbel": _t(jax.random.gumbel(key, (n, 5)))})
        _equal(got, want)
        _, own = texp.StochasticSampling(True)(
            (), _t(logits), 0, gen=torch.Generator().manual_seed(0))
        assert own.shape == (n,) and own.dtype == torch.long
    else:
        x = _t(action)
        assert texp.StochasticSampling(False)((), x, 0)[1] is x


# -- replay --------------------------------------------------------------------

def _example(obs_dim=3):
    return ({"obs": jnp.zeros((obs_dim,)), "action": jnp.zeros((), jnp.int32),
             "reward": jnp.zeros(()), "next_obs": jnp.zeros((obs_dim,)),
             "done": jnp.zeros(())},
            {"obs": torch.zeros(obs_dim),
             "action": torch.zeros((), dtype=torch.long),
             "reward": torch.zeros(()), "next_obs": torch.zeros(obs_dim),
             "done": torch.zeros(())})


def _rows(rng, n, obs_dim=3, done_p=0.2, n_actions=3):
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "action": rng.integers(0, n_actions, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "done": (rng.random(n) < done_p).astype(np.float32)}


def _port_rows(rows):
    out = {k: _t(v) for k, v in rows.items()}
    out["action"] = out["action"].long()
    return out


def _fill(prioritized, cap, inserts, n, seed=2, obs_dim=3, n_actions=3):
    """The same inserts into a JAX and a port buffer (the port's in
    place); → (JAX state, port state)."""
    jex, tex = _example(obs_dim)
    if prioritized:
        jbuf, tbuf = jreplay.init_prioritized(cap, jex), \
            treplay.init_prioritized(cap, tex)
        tadd = treplay.add_batch_prioritized
    else:
        jbuf, tbuf = jreplay.init(cap, jex), treplay.init(cap, tex)
        tadd = treplay.add_batch
    jadd = _jitted("add", prioritized)
    rng = np.random.default_rng(seed)
    for _ in range(inserts):
        rows = _rows(rng, n, obs_dim, n_actions=n_actions)
        jbuf = jadd(jbuf, {k: jnp.asarray(v) for k, v in rows.items()}, n)
        tbuf = tadd(tbuf, _port_rows(rows), n)
    return jbuf, tbuf


def test_replay_wraps_around_and_samples_uniformly():
    """Inserts of 5 into 12 slots wrap inside an insert; the data, cursor
    and size exactly; a uniform sample from the JAX key's indices."""
    for inserts in (1, 2, 5):
        jbuf, tbuf = _fill(False, 12, inserts, 5)
        _buffer_equal(tbuf, jbuf)
    key = jax.random.PRNGKey(4)
    jbatch, jidx, _ = jax.jit(jreplay.sample, static_argnums=2)(jbuf, key,
                                                                 8)
    _, skey = jax.random.split(key)
    tbatch, tidx = treplay.sample(tbuf, 8, draw=_sample_draw(
        skey, False, 8, tbuf["size"], 12))
    _equal(tidx, jidx)
    for k, v in _np(jbatch).items():
        _equal(tbatch[k], v)
    gen = torch.Generator().manual_seed(0)
    _, own = treplay.sample(tbuf, 500, gen)
    assert int(own.min()) >= 0 and int(own.max()) < 12
    with pytest.raises(ValueError, match="capacity"):
        treplay.add_batch(tbuf, _port_rows(_rows(np.random.default_rng(0),
                                                 13)), 13)


@pytest.mark.parametrize("beta", [0.4, 1.0])
def test_prioritized_replay_matches_jax(beta):
    """Inserts at the running max priority, a priority update (with a slot
    sampled twice, equal values), then a prioritized sample from the JAX
    key's Gumbel noise: indices exactly, weights (the buffer-wide max
    weight, unfilled slots masked) within rtol 1e-5; the running max."""
    cap = 64
    jbuf, tbuf = _fill(True, cap, 3, 8)          # 24 of 64 filled
    rng = np.random.default_rng(5)
    idx = np.array([0, 3, 3, 7, 20, 23], np.int32)
    td = rng.uniform(0, 2, idx.size).astype(np.float32)
    td[2] = td[1]
    jbuf = jreplay.update_priorities(jbuf, jnp.asarray(idx),
                                     jnp.asarray(td))
    treplay.update_priorities(tbuf, _t(idx).long(), _t(td))
    _close(tbuf["priority"], jbuf["priority"])
    _close(tbuf["max_priority"], jbuf["max_priority"])
    # an insert after the update lands at the new max
    rows = _rows(rng, 8)
    jbuf = jreplay.add_batch_prioritized(
        jbuf, {k: jnp.asarray(v) for k, v in rows.items()}, 8)
    treplay.add_batch_prioritized(tbuf, _port_rows(rows), 8)
    _close(tbuf["priority"], jbuf["priority"])
    key = jax.random.PRNGKey(6)
    jbatch, jidx, jw, _ = jax.jit(functools.partial(
        jreplay.sample_prioritized, batch_size=16, beta=beta))(jbuf, key)
    _, skey = jax.random.split(key)
    draw = _sample_draw(skey, True, 16, tbuf["size"], cap)
    assert np.array_equal(np.asarray(jnp.argmax(
        _t(draw["gumbel"]).numpy() + np.where(
            np.arange(cap) < 32, 0.6 * np.log(np.asarray(
                jbuf["priority"]) + 1e-6), -np.inf), axis=-1)),
        np.asarray(jidx))
    tbatch, tidx, tw = treplay.sample_prioritized(tbuf, 16, beta=beta,
                                                  draw=draw)
    _equal(tidx, jidx)
    _close(tw, jw)
    for k, v in _np(jbatch).items():
        _equal(tbatch[k], v)


def test_prioritized_inverse_cdf_sampler_is_exact_and_in_range():
    """The port's own sampler (uniforms → float64 cumulative priorities
    → binary search) picks, for each uniform, the slot numpy's inverse CDF
    picks, and never an unfilled slot."""
    jbuf, tbuf = _fill(True, 64, 5, 8)           # 40 of 64 filled
    rng = np.random.default_rng(7)
    idx = np.arange(0, 40, 3)
    treplay.update_priorities(tbuf, _t(idx).long(),
                              _t(rng.uniform(0, 3, idx.size).astype(
                                  np.float32)))
    u = torch.rand(4000, generator=torch.Generator().manual_seed(1))
    _, got, _ = treplay.sample_prioritized(tbuf, 4000, draw={"u": u})
    w = (tbuf["priority"][:40].double().numpy() + 1e-6) ** 0.6
    cdf = np.cumsum(w)
    want = np.minimum(np.searchsorted(cdf, u.double().numpy() * cdf[-1],
                                      side="right"), 39)
    _equal(got, want)
    assert int(got.max()) < 40


@pytest.mark.parametrize("state", ["filling", "wrapped"])
def test_nstep_window_matches_jax(state):
    """n = 3 at stride 4 (4 envs): episode ends truncate the sum, windows
    that cross the cursor (wrapped) or the filled region (filling) fall
    back to 1-step, the bootstrap obs from the last live step; rewards,
    gammas within rtol 1e-5, dones and obs exactly."""
    cap = 64
    jbuf, tbuf = _fill(False, cap, 11 if state == "wrapped" else 6, 4,
                       seed=8)
    cur, size = tbuf["cursor"], tbuf["size"]
    near = [(cur - k) % cap for k in range(1, 13)]    # windows at the cursor
    idx = np.array(near + [0, 5, 17, 30, size - 1], np.int32) % size
    one = {k: v[idx] for k, v in _np(jbuf["data"]).items()}
    want = jax.jit(functools.partial(jreplay.nstep_window, n=3, gamma=0.9,
                                     stride=4))(jbuf, jnp.asarray(idx),
                                                one_step=one)
    got = treplay.nstep_window(tbuf, _t(idx).long(), 3, 0.9, stride=4,
                               one_step={k: _t(v) for k, v in one.items()})
    _close(got[0], want[0])
    _equal(got[1], want[1])
    _equal(got[2], want[2])
    _close(got[3], want[3])
    # some windows fell back to 1-step and some summed past one step
    fell = np.asarray(want[3]) == np.float32(0.9)
    assert fell.any() and (~fell).any()


# -- Q networks and targets ----------------------------------------------------

QNETS = {"plain": {}, "dueling": {"dueling": True},
         "c51": {"num_atoms": 7, "v_min": -2.0, "v_max": 3.0},
         "dueling-c51": {"dueling": True, "num_atoms": 7}}


def _qpair(kind, seed=0):
    jq, jp = _jitted("qinit", kind, seed)
    tq = tdqn.QNetwork(5, 3, hidden=(8, 6), device="cpu", **QNETS[kind])
    return jq, tq, jp, policy_params_from_numpy(tq, jp)


@pytest.mark.parametrize("kind", list(QNETS))
def test_qnetwork_heads_match_jax(kind):
    jq, tq, jp, tp = _qpair(kind)
    obs = np.random.default_rng(9).normal(size=(7, 5)).astype(np.float32)
    _close(tq.apply(tp, _t(obs)), jax.jit(jq.apply)(jp, obs))
    if jq.num_atoms > 1:
        _close(tq.logits(tp, _t(obs)), jax.jit(jq.logits)(jp, obs))
        _close(tq.support, jq.support, atol=1e-6)
    # the dueling torso applies tanh on every layer
    if jq.dueling:
        x = tq._torso(tp, _t(obs))
        assert float(x.abs().max()) <= 1.0
    assert [tuple(p.shape) for p in tree_leaves(tp)] == [
        tuple(np.shape(p)) for p in jax.tree_util.tree_leaves(jp)]


def test_qnetwork_and_converter_refusals():
    with pytest.raises(ValueError, match="v_min < v_max"):
        tdqn.QNetwork(3, 2, num_atoms=5, v_min=1.0, v_max=1.0, device="cpu")
    with pytest.raises(ValueError, match="at least one hidden"):
        tdqn.QNetwork(3, 2, hidden=(), dueling=True, device="cpu").init(
            torch.Generator())
    _, tq, jp, _ = _qpair("dueling")
    bad = _np(jp)
    bad["a"][0]["w"] = bad["a"][0]["w"][:, :2]
    with pytest.raises(ValueError, match="/a/0/w: shape"):
        policy_params_from_numpy(tq, bad)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_target_matches_jax(double_q):
    jq, tq, jp, tp = _qpair("dueling")
    _, _, jtp, ttp = _qpair("dueling", seed=1)
    rng = np.random.default_rng(10)
    b = 9
    reward = rng.normal(size=b).astype(np.float32)
    next_obs = rng.normal(size=(b, 5)).astype(np.float32)
    done = (rng.random(b) < 0.3).astype(np.float32)
    gamma = rng.uniform(0.8, 0.99, b).astype(np.float32)
    want = jax.jit(functools.partial(jdqn.dqn_target, jq.apply,
                                     double_q=double_q))(
        jp, jtp, reward, next_obs, done, gamma)
    got = tdqn.dqn_target(tq.apply, tp, ttp, _t(reward), _t(next_obs),
                          _t(done), _t(gamma), double_q)
    _close(got, want)


@pytest.mark.parametrize("kind,double_q", [("c51", True),
                                           ("dueling-c51", False)])
def test_categorical_td_loss_and_gradients_match_jax(kind, double_q):
    """The C51 projection, the per-sample CE, the loss and its gradients
    against ``jax.grad``; rewards and gammas put some shifted atoms on
    the support's ends (clamped) and some exactly on atoms."""
    jq, tq, jp, tp = _qpair(kind)
    _, _, jtp, ttp = _qpair(kind, seed=1)
    rng = np.random.default_rng(11)
    b = 10
    batch = {"obs": rng.normal(size=(b, 5)).astype(np.float32),
             "action": rng.integers(0, 3, b).astype(np.int32),
             "reward": np.concatenate([rng.normal(size=b - 3) * 2,
                                       [9.0, -9.0, 0.0]]).astype(np.float32),
             "next_obs": rng.normal(size=(b, 5)).astype(np.float32),
             "done": (rng.random(b) < 0.3).astype(np.float32),
             "gamma_n": np.concatenate([rng.uniform(0.8, 0.99, b - 1),
                                        [0.0]]).astype(np.float32)}
    weights = rng.uniform(0.2, 1.0, b).astype(np.float32)

    def jloss(p):
        return jdqn.categorical_td_loss(jq, p, jtp, batch, weights, double_q)

    (jl, jce), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tbatch = {k: _t(v) for k, v in batch.items()}
    proj = tdqn.categorical_projection(tq, tp, ttp, tbatch, double_q)
    assert torch.allclose(proj.sum(-1), torch.ones(b), atol=1e-6)
    tl, tce, tg = tlearner.value_and_grad(
        lambda p: tdqn.categorical_td_loss(tq, p, ttp, tbatch, _t(weights),
                                           double_q), tp)
    _close(tl, jl, C51_TOL, C51_TOL)
    _close(tce, jce, C51_TOL, C51_TOL)
    for g, w in zip(tg, jax.tree_util.tree_leaves(jg)):
        _close(g, w, C51_TOL, C51_TOL)


# -- DQN, SimpleQ, Rainbow -----------------------------------------------------

SMALL_DQN = dict(num_envs=4, rollout_steps=4, buffer_capacity=64,
                 batch_size=8, num_updates=2, learn_start=20, eps_start=0.3,
                 hidden=(8,), seed=0)


def _dqn_pair(cls_name, **kw):
    kw = {**SMALL_DQN, **kw}
    jalgo = getattr(jrl, cls_name)(env=jrl.CartPole, **kw).build()
    talgo = getattr(trl, cls_name)(env=trl.CartPole, device="cpu",
                                   **kw).build()
    _, _, ekey = jax.random.split(jax.random.PRNGKey(kw["seed"]), 3)
    talgo.params = policy_params_from_numpy(talgo.q, _np(jalgo.params))
    talgo.target_params = policy_params_from_numpy(talgo.q,
                                                   _np(jalgo.target_params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    _sync_env(talgo, jalgo, ekey, "CartPole")
    return jalgo, talgo


def _dqn_draws(jalgo, env_name, steps, size_after):
    """An iteration's draws from the JAX algorithm's key: per collect step
    the explorer's and the envs' reset draws, then each update's sample
    draw (none below the learn-start gate)."""
    cfg, key = jalgo.config, jalgo.key
    n, a = cfg.num_envs, jalgo.env.action_size
    collect = []
    for _ in range(steps):
        key, akey, skey = jax.random.split(key, 3)
        collect.append({**_eps_draws(akey, n, a),
                        "reset": _reset_draws(env_name,
                                              jax.random.split(skey, n))})
    updates = []
    if size_after >= cfg.learn_start:
        for _ in range(cfg.num_updates):
            key, skey = jax.random.split(key)
            updates.append(_sample_draw(skey, cfg.prioritized_replay,
                                        cfg.batch_size, size_after,
                                        cfg.buffer_capacity))
    return {"collect": collect, "updates": updates}


@pytest.mark.parametrize("cls_name", ["DQNConfig", "SimpleQConfig",
                                      "RainbowConfig"])
def test_dqn_family_training_steps_match_jax(cls_name):
    """Two iterations from the JAX init, reset and draws: the first below
    the learn-start gate (16 < 20 rows: an exact no-op), the second with 2
    updates (Rainbow: 3-step, PER, dueling C51).  The envs, the buffer
    (data exactly, priorities), params, targets and Adam state within
    rtol 1e-4, the loss and epsilon."""
    jalgo, talgo = _dqn_pair(cls_name)
    cfg = jalgo.config
    per = cfg.prioritized_replay
    for it in range(2):
        size_after = cfg.num_envs * cfg.rollout_steps * (it + 1)
        draws = _dqn_draws(jalgo, "CartPole", cfg.rollout_steps, size_after)
        jres = jalgo.train()
        tres = _train(talgo, draws)
        _close(talgo.obs, jalgo.obs)
        _buffer_equal(talgo.buffer, jalgo.buffer)
        assert tres["epsilon"] == jres["epsilon"]
        assert tres["buffer_size"] == jres["buffer_size"]
        _close(tres["step_reward_mean"], jres["step_reward_mean"])
        if it == 0:
            assert tres["td_loss"] == 0.0 == jres["td_loss"]
            assert talgo.opt_state["count"] == 0
        else:
            _close(tres["td_loss"], jres["td_loss"], UPD_RTOL, UPD_ATOL)
        if per:
            _close(talgo.buffer["priority"], jalgo.buffer["priority"],
                   UPD_RTOL, UPD_ATOL)
        _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
        _tree_close(talgo.target_params, _np(jalgo.target_params), UPD_RTOL,
                    UPD_ATOL)
        _adam_close(talgo.opt_state, jalgo.opt_state)
    assert talgo._ep_done_returns == pytest.approx(jalgo._ep_done_returns)


def test_dqn_update_block_matches_jax():
    """The update block alone (scalar TD, 3-step at stride 4, PER with the
    beta annealed from env steps, dueling) on a full, wrapped buffer:
    3 updates from the same params and draws."""
    kw = dict(n_step=3, prioritized_replay=True, dueling=True,
              num_updates=3, learn_start=8, eps_decay_steps=100)
    jalgo, talgo = _dqn_pair("DQNConfig", **kw)
    cfg = jalgo.config
    jbuf, tbuf = _fill(True, 64, 19, 4, seed=12, obs_dim=4,
                       n_actions=2)
    jbuf = jreplay.update_priorities(
        jbuf, jnp.arange(0, 64, 5), jnp.linspace(0.1, 2.0, 13))
    treplay.update_priorities(tbuf, torch.arange(0, 64, 5),
                              _t(jnp.linspace(0.1, 2.0, 13)))
    talgo.buffer = tbuf
    talgo._total_env_steps = 40
    block = jax.jit(jalgo._make_update_block(insert_stride=4))
    key = jax.random.PRNGKey(13)
    out = block(jalgo.params, jalgo.target_params, jalgo.opt_state, jbuf,
                key, jnp.float32(40))
    draws, k = [], key
    for _ in range(cfg.num_updates):
        k, skey = jax.random.split(k)
        draws.append(_sample_draw(skey, True, cfg.batch_size, 64, 64))
    res = talgo.learn(draws)
    assert len(res["indices"]) == 3
    _close(res["td_loss"], out[5], UPD_RTOL, UPD_ATOL)
    _close(talgo.buffer["priority"], out[3]["priority"], UPD_RTOL, UPD_ATOL)
    _close(talgo.buffer["max_priority"], out[3]["max_priority"], UPD_RTOL)
    _tree_close(talgo.params, _np(out[0]), UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.target_params, _np(out[1]), UPD_RTOL, UPD_ATOL)
    _adam_close(talgo.opt_state, out[2])


def test_dqn_checkpoint_keeps_epsilon_and_serves_actions():
    cfg = trl.DQNConfig(env=trl.CartPole, device="cpu", eps_decay_steps=100,
                        **{k: v for k, v in SMALL_DQN.items()
                           if k != "eps_start"})
    algo = cfg.build()
    for _ in range(3):
        algo.train()
    saved = algo.save()
    fresh = cfg.build()
    fresh.restore(saved)
    assert fresh._total_env_steps == 48 and fresh.iteration == 3
    assert fresh.train()["epsilon"] == algo.train()["epsilon"] < 1.0
    state = saved.to_dict()
    for got, want in zip(tree_leaves(fresh.params),
                         tree_leaves(algo.get_state()["params"])):
        assert got.shape == want.shape
    # a saved state does not follow later training (in-place updates)
    before = [w.copy() for w in tree_leaves(state["params"])]
    algo.train()
    assert all(np.array_equal(a, b) for a, b in zip(
        before, tree_leaves(state["params"])))
    # served actions: the exploration coin is numpy's, seeded from the
    # config, so from the same params the JAX package serves the same
    jalgo, talgo = _dqn_pair("DQNConfig")
    obs = np.random.default_rng(23).normal(size=(8, 4)).astype(np.float32)
    for explore in (True, False):
        assert [talgo.compute_single_action(o, explore) for o in obs] == \
            [jalgo.compute_single_action(o, explore) for o in obs]


def test_rltrainer_runs_dqn_and_its_checkpoint_restores():
    cfg = trl.DQNConfig(env=trl.CartPole, device="cpu", **SMALL_DQN)
    result = RLTrainer(cfg, iterations=3).fit()
    assert result.metrics["training_iteration"] == 3
    assert np.isfinite(result.metrics["td_loss"])
    assert result.metrics["td_loss"] > 0 and result.metrics["buffer_size"] \
        == 48
    algo = cfg.build()
    algo.restore(result.checkpoint)
    assert algo.iteration == 3 and algo._total_env_steps == 48


# -- PG ------------------------------------------------------------------------

def test_returns_to_go_match_jax():
    rng = np.random.default_rng(14)
    rewards = rng.normal(size=(7, 5)).astype(np.float32)
    dones = rng.random((7, 5)) < 0.3
    want = jpg._returns_to_go(jnp.asarray(rewards), jnp.asarray(dones), 0.9)
    got = tpg._returns_to_go(_t(rewards), _t(dones), 0.9)
    _close(got, want)
    # zero-bootstrapped at the truncation: the last step is its reward
    _close(got[-1], rewards[-1])


def test_a_pg_iteration_matches_jax():
    """One PG iteration (8 envs x 8 steps) from the JAX init, reset and
    draws: the trajectory-driven state, the losses and the params after
    the one clipped-Adam step."""
    kw = dict(num_envs=8, rollout_length=8, hidden=(8,), seed=0)
    jalgo = jrl.PGConfig(env=jrl.CartPole, **kw).build()
    talgo = tpg.PGConfig(env=trl.CartPole, device="cpu", **kw).build()
    _, _, ekey = jax.random.split(jax.random.PRNGKey(0), 3)
    talgo.params = policy_params_from_numpy(talgo.policy, _np(jalgo.params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    _sync_env(talgo, jalgo, ekey, "CartPole")
    key, draws = jalgo.key, []
    gumbel = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (2,))))
    for _ in range(8):
        key, akey, skey = jax.random.split(key, 3)
        draws.append({"noise": _t(gumbel(jax.random.split(akey, 8))),
                      "reset": _reset_draws("CartPole",
                                            jax.random.split(skey, 8))})
    jres = jalgo.train()
    tres = talgo.training_step(draws=draws)
    _close(talgo.obs, jalgo.obs)
    _close(tres["reward_sum"], jres["reward_sum"])
    for k in ("pg_loss", "entropy", "total_loss"):
        _close(tres[k], jres[k], UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    assert talgo.get_state()["algo"] == "PG"


def test_pg_refusals_match_jax():
    for kw in ({"num_workers": 2}, {"model": {"use_lstm": True}}):
        with pytest.raises(ValueError) as want:
            jrl.PGConfig(env=jrl.CartPole, num_envs=2, rollout_length=2,
                         **kw).build()
        with pytest.raises(ValueError) as got:
            tpg.PGConfig(env=trl.CartPole, num_envs=2, rollout_length=2,
                         device="cpu", **kw).build()
        assert str(got.value) == str(want.value)


# -- learner and R2D2 ----------------------------------------------------------

def test_learner_gate_below_and_above_learn_start():
    """`make_update_gate` on a quadratic loss: below learn_start nothing
    moves (params, targets, optimizer count) and the loss is 0; above,
    two Adam steps with Polyak after each, as the JAX gate."""
    import optax

    def jloss(p, tp, batch):
        return jnp.mean((batch["obs"] @ p["w"] - tp["w"].sum()) ** 2)

    def tloss(p, tp, batch):
        return torch.mean((batch["obs"] @ p["w"] - tp["w"].sum()) ** 2)

    jex, tex = _example()
    rng = np.random.default_rng(15)
    w = rng.normal(size=(3, 2)).astype(np.float32)
    jopt = optax.adam(1e-2)
    jgate = jax.jit(jlearner.make_update_gate(
        jopt, tau=0.1, learn_start=16, num_updates=2,
        sample_fn=lambda b, k: jreplay.sample(b, k, 4), loss_fn=jloss))
    for rows, learn in ((8, False), (24, True)):
        jbuf, tbuf = jreplay.init(32, jex), treplay.init(32, tex)
        data = _rows(rng, 24)
        for k in data:
            data[k][rows:] = 0     # one insert shape: the unwritten rows
        jbuf = _jitted("add", False)(jbuf, {k: jnp.asarray(v) for k, v
                                            in data.items()}, 24)
        jbuf = dict(jbuf, size=jnp.int32(rows), cursor=jnp.int32(rows))
        treplay.add_batch(tbuf, _port_rows(data), 24)
        tbuf.update(size=rows, cursor=rows)
        jp, jt = {"w": jnp.asarray(w)}, {"w": jnp.asarray(w) * 0.5}
        key = jax.random.PRNGKey(16)
        out = jgate(jp, jt, jopt.init(jp), jbuf, key)
        topt = trl.Adam(1e-2)
        tp, tt = {"w": _t(w)}, {"w": _t(w) * 0.5}
        tstate = topt.init(tp)
        draws, k = [], key
        for _ in range(2):
            k, skey = jax.random.split(k)
            draws.append(_sample_draw(skey, False, 4, rows, 32))
        tgate = tlearner.make_update_gate(
            topt, tau=0.1, learn_start=16, num_updates=2,
            sample_fn=lambda b, d: treplay.sample(b, 4, draw=d),
            loss_fn=tloss)
        loss = tgate(tp, tt, tstate, tbuf, draws)
        _close(loss, out[5], UPD_RTOL, UPD_ATOL)
        _tree_close(tp, _np(out[0]), UPD_RTOL, UPD_ATOL)
        _tree_close(tt, _np(out[1]), UPD_RTOL, UPD_ATOL)
        assert tstate["count"] == (2 if learn else 0)
        if not learn:
            assert float(loss) == 0.0 and torch.equal(tp["w"], _t(w))


def test_recurrent_q_network_unroll_matches_jax():
    jq = jrl.RecurrentQNetwork(3, 2, hidden=(6,), lstm_size=5)
    tq = trl.RecurrentQNetwork(3, 2, hidden=(6,), lstm_size=5, device="cpu")
    jp = jax.jit(jq.init)(jax.random.PRNGKey(17))
    tp = policy_params_from_numpy(tq, _np(jp))
    rng = np.random.default_rng(18)
    obs = rng.normal(size=(6, 4, 3)).astype(np.float32)
    done = rng.random((6, 4)) < 0.3
    init = (rng.normal(size=(4, 5)).astype(np.float32),
            rng.normal(size=(4, 5)).astype(np.float32))
    want = jax.jit(jq.unroll)(jp, obs, done, init)
    got = tq.unroll(tp, _t(obs), _t(done), (_t(init[0]), _t(init[1])))
    _close(got, want)
    with pytest.raises(ValueError, match=">=1 torso layer"):
        trl.RecurrentQNetwork(3, 2, hidden=(), device="cpu")


def test_r2d2_iterations_match_jax():
    """Two R2D2 iterations on MemoryCue (4 envs, sequences of 6 with a
    burn-in of 2): the first below learn_start (4 of 6 sequences), the
    second with 2 double-Q updates through the learner gate."""
    kw = dict(num_envs=4, seq_len=6, burn_in=2, buffer_capacity=16,
              batch_size=4, num_updates=2, learn_start=6, eps_start=0.3,
              hidden=(8,), lstm_size=6, seed=0)
    jalgo = jrl.R2D2Config(env=jrl.MemoryCue, **kw).build()
    talgo = trl.R2D2Config(env=trl.MemoryCue, device="cpu", **kw).build()
    _, _, ekey = jax.random.split(jax.random.PRNGKey(0), 3)
    talgo.params = policy_params_from_numpy(talgo.q, _np(jalgo.params))
    talgo.target_params = policy_params_from_numpy(
        talgo.q, _np(jalgo.target_params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    _sync_env(talgo, jalgo, ekey, "MemoryCue")
    for it in range(2):
        key, collect = jalgo.key, []
        for _ in range(kw["seq_len"]):
            key, akey, skey = jax.random.split(key, 3)
            collect.append({**_eps_draws(akey, 4, 2),
                            "reset": _reset_draws(
                                "MemoryCue", jax.random.split(skey, 4))})
        updates = []
        if 4 * (it + 1) >= kw["learn_start"]:
            for _ in range(kw["num_updates"]):
                key, skey = jax.random.split(key)
                updates.append(_sample_draw(skey, False, 4, 4 * (it + 1),
                                            16))
        jres = jalgo.train()
        tres = _train(talgo, {"collect": collect, "updates": updates})
        _close(talgo.obs, jalgo.obs)
        _close(talgo.lstm_state[0], jalgo.lstm_state[0])
        _buffer_equal(talgo.buffer, jalgo.buffer)
        _close(tres["td_loss"], jres["td_loss"], UPD_RTOL, UPD_ATOL)
        _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
        _tree_close(talgo.target_params, _np(jalgo.target_params),
                    UPD_RTOL, UPD_ATOL)
    assert talgo.opt_state["count"] == 2
    with pytest.raises(ValueError, match="no steps would remain"):
        trl.R2D2Config(env=trl.MemoryCue, seq_len=4, burn_in=4,
                       device="cpu").build()


# -- TD3, DDPG -----------------------------------------------------------------

SMALL_TD3 = dict(num_envs=4, rollout_steps=4, buffer_capacity=64,
                 batch_size=8, num_updates=4, learn_start=20, hidden=(8,),
                 seed=0)


def _continuous_pair(cls_name, **kw):
    kw = {**SMALL_TD3, **kw}
    jalgo = getattr(jrl, cls_name)(env=jrl.Pendulum, **kw).build()
    talgo = getattr(trl, cls_name)(env=trl.Pendulum, device="cpu",
                                   **kw).build()
    ekey = jax.random.split(jax.random.PRNGKey(kw["seed"]), 5)[4]
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    if cls_name == "SACConfig":
        # the target critics: the converter takes the whole tree
        whole = {**_np(jalgo.params), **_np(jalgo.target_q)}
        talgo.target_q = {k: v for k, v in policy_params_from_numpy(
            talgo, whole).items() if k in ("q1", "q2")}
        talgo.opt_state = talgo.optimizer.init(talgo.params)
    else:
        talgo.targets = policy_params_from_numpy(talgo, _np(jalgo.targets))
        talgo.actor_opt_state = talgo.actor_opt.init(talgo.params["actor"])
        talgo.critic_opt_state = talgo.critic_opt.init(
            talgo._critics(talgo.params))
    _sync_env(talgo, jalgo, ekey, "Pendulum")
    return jalgo, talgo


def _continuous_buffer(jalgo, talgo, inserts, seed):
    """The same random transitions into both algorithms' buffers."""
    rng = np.random.default_rng(seed)
    jadd = jax.jit(jalgo._replay_ops[1], static_argnums=2)
    for _ in range(inserts):
        rows = {"obs": rng.normal(size=(8, 3)).astype(np.float32),
                "action": rng.uniform(-2, 2, (8, 1)).astype(np.float32),
                "reward": rng.normal(size=8).astype(np.float32),
                "next_obs": rng.normal(size=(8, 3)).astype(np.float32),
                "done": (rng.random(8) < 0.1).astype(np.float32)}
        jalgo.buffer = jadd(jalgo.buffer, {k: jnp.asarray(v)
                                           for k, v in rows.items()}, 8)
        talgo._replay_ops[1](talgo.buffer, {k: _t(v)
                                            for k, v in rows.items()}, 8)


def test_td3_four_updates_match_jax_and_the_actor_moves_on_even_counts():
    """The update block from count 0: critics every update, the actor
    and the targets on counts 0 and 2 (policy_delay 2); params, targets
    and both Adam states within rtol 1e-4 of the JAX block from the same
    sample and smoothing draws."""
    jalgo, talgo = _continuous_pair("TD3Config")
    _continuous_buffer(jalgo, talgo, 4, seed=19)
    block = jax.jit(jalgo._make_update_block())
    key = jax.random.PRNGKey(20)
    out = block(jalgo.params, jalgo.targets, jalgo.actor_opt_state,
                jalgo.critic_opt_state, jalgo.buffer, key, jnp.int32(0))
    draws, k = [], key
    for _ in range(4):
        k, skey = jax.random.split(k)
        d = _sample_draw(skey, False, 8, 32, 64)
        k, nkey = jax.random.split(k)
        d["smooth"] = _t(jax.random.normal(nkey, (8, 1)))
        draws.append(d)
    td = talgo.learn(draws)
    _close(td, out[7], UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.params, _np(out[0]), UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.targets, _np(out[1]), UPD_RTOL, UPD_ATOL)
    _adam_close(talgo.actor_opt_state, out[2])
    _adam_close(talgo.critic_opt_state, out[3])
    assert talgo._update_count == int(out[6]) == 4
    assert talgo.actor_opt_state["count"] == 2
    # one update at a time: the actor moves at even counts only
    talgo.config = dataclasses.replace(talgo.config, num_updates=1)
    moved = []
    for _ in range(4):
        before = talgo.params["actor"][0]["w"].clone()
        talgo.learn()
        moved.append(not torch.equal(before, talgo.params["actor"][0]["w"]))
    assert moved == [True, False, True, False]


def test_ddpg_iterations_match_jax():
    """Two DDPG iterations (OU exploration per env, one critic, no
    smoothing, an actor step every update) from the JAX init and draws."""
    jalgo, talgo = _continuous_pair("DDPGConfig", num_updates=2)
    cfg = jalgo.config
    for it in range(2):
        key, collect = jalgo.key, []
        for _ in range(cfg.rollout_steps):
            key, nkey, skey = jax.random.split(key, 3)
            collect.append({"normal": _t(jax.random.normal(nkey, (4, 1))),
                            "reset": _reset_draws(
                                "Pendulum", jax.random.split(skey, 4))})
        updates = []
        if 16 * (it + 1) >= cfg.learn_start:
            for _ in range(cfg.num_updates):
                key, skey = jax.random.split(key)
                d = _sample_draw(skey, False, 8, 16 * (it + 1), 64)
                key, _ = jax.random.split(key)       # smoothing: unused
                d["smooth"] = torch.zeros(8, 1)
                updates.append(d)
        jres = jalgo.train()
        tres = _train(talgo, {"collect": collect, "updates": updates})
        _close(talgo.noise_state, jalgo.noise_state)
        _close(talgo.obs, jalgo.obs)
        _close(talgo.buffer["data"]["action"],
               jalgo.buffer["data"]["action"])
        _close(tres["td_abs"], jres["td_abs"], UPD_RTOL, UPD_ATOL)
        _close(tres["step_reward_mean"], jres["step_reward_mean"])
        _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
        _tree_close(talgo.targets, _np(jalgo.targets), UPD_RTOL, UPD_ATOL)
    assert talgo._update_count == int(jalgo._update_count) == 2


def test_td3_checkpoint_keeps_the_delay_phase():
    cfg = trl.TD3Config(env=trl.Pendulum, device="cpu",
                        **dict(SMALL_TD3, num_updates=3))
    algo = cfg.build()
    for _ in range(2):
        algo.train()
    assert algo._update_count == 3
    fresh = cfg.build()
    fresh.restore(algo.save())
    assert fresh._update_count == 3 and fresh._total_env_steps == 32
    # the next update is count 3: critics only, the actor stays
    fresh.config = dataclasses.replace(fresh.config, num_updates=1)
    before = fresh.params["actor"][0]["w"].clone()
    fresh.learn()
    assert torch.equal(before, fresh.params["actor"][0]["w"])


# -- SAC -----------------------------------------------------------------------

def test_sac_squashed_log_prob_matches_jax_at_large_u():
    """The squashed Gaussian's action and log-prob for |u| up to about 20
    (a mean pushed out by the last bias), where ``log(1 - tanh(u)^2)`` is
    -inf in float32 and the softplus form stays finite."""
    jalgo, talgo = _continuous_pair("SACConfig", hidden=(8,))
    jp = _np(jalgo.params)
    jp["actor"][-1]["b"] = np.array([18.0, 0.0], np.float32)
    n = 12
    obs = np.random.default_rng(21).normal(size=(n, 3)).astype(np.float32)
    obs[n // 2:] *= -1
    keys = jax.random.split(jax.random.PRNGKey(22), n)
    for sign in (1.0, -1.0):
        jp["actor"][-1]["b"][0] = 18.0 * sign
        want = jax.jit(jax.vmap(lambda o, k: jalgo._sample_action(
            jp["actor"], o, k)))(obs, keys)
        noise = _jitted("normal_each", 1)(keys)
        tp = policy_params_from_numpy(talgo, jp)
        a, logp = talgo._sample_action(tp["actor"], _t(obs), _t(noise))
        _close(a, want[0])
        _close(logp, want[1], RTOL, 1e-4)
        assert torch.isfinite(logp).all()
    u = torch.tensor([20.0])
    assert torch.isinf(torch.log(1 - torch.tanh(u) ** 2)).all()


def test_sac_iterations_with_per_and_log_alpha_match_jax():
    """Two SAC iterations with prioritized replay: the first below
    learn_start, the second with 2 updates of actor, twin critics and
    log_alpha (one Adam over the tree), from the JAX init and draws."""
    jalgo, talgo = _continuous_pair("SACConfig", num_updates=2,
                                    prioritized_replay=True)
    cfg = jalgo.config
    normal_each = _jitted("normal_each", 1)
    for it in range(2):
        key, collect = jalgo.key, []
        for _ in range(cfg.rollout_steps):
            key, akey, skey = jax.random.split(key, 3)
            collect.append({"noise": _t(normal_each(
                jax.random.split(akey, 4))),
                "reset": _reset_draws("Pendulum", jax.random.split(skey, 4))})
        updates = []
        if 16 * (it + 1) >= cfg.learn_start:
            for _ in range(cfg.num_updates):
                key, skey = jax.random.split(key)
                d = _sample_draw(skey, True, 8, 16 * (it + 1), 64)
                key, lkey = jax.random.split(key)
                d["next_noise"] = _t(normal_each(jax.random.split(lkey, 8)))
                d["pi_noise"] = _t(normal_each(jax.random.split(
                    jax.random.fold_in(lkey, 1), 8)))
                updates.append(d)
        jres = jalgo.train()
        tres = _train(talgo, {"collect": collect, "updates": updates})
        _close(talgo.obs, jalgo.obs)
        _close(talgo.buffer["data"]["action"],
               jalgo.buffer["data"]["action"])
        for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
            _close(tres[k], jres[k], UPD_RTOL, UPD_ATOL)
        _close(talgo.buffer["priority"], jalgo.buffer["priority"], UPD_RTOL,
               UPD_ATOL)
        _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
        _tree_close(talgo.target_q, _np(jalgo.target_q), UPD_RTOL, UPD_ATOL)
        _adam_close(talgo.opt_state, jalgo.opt_state)
    assert float(talgo.params["log_alpha"]) != math.log(0.2)
    assert talgo.params["log_alpha"].dim() == 0


# -- refusals, devices ---------------------------------------------------------

def test_off_policy_refusals():
    with pytest.raises(NotImplementedError, match="rl/external.py"):
        trl.DQNConfig(env=trl.CartPole, external_input=True,
                      device="cpu").build()
    algo = trl.DQNConfig(env=trl.CartPole, device="cpu",
                         **SMALL_DQN).build()
    with pytest.raises(NotImplementedError, match="rl/external.py"):
        algo.set_input_reader(object())
    cases = [
        (lambda m, e: m.DQNConfig(env=e.Pendulum, **dev(m)), "discrete"),
        (lambda m, e: m.DQNConfig(env=e.CartPole, n_step=3, num_envs=8,
                                  buffer_capacity=16, **dev(m)),
         "needs a window of 16 slots"),
        (lambda m, e: m.TD3Config(env=e.CartPole, **dev(m)), "continuous"),
        (lambda m, e: m.SACConfig(env=e.CartPole, **dev(m)), "continuous"),
        (lambda m, e: m.R2D2Config(env=e.Pendulum, **dev(m)), "discrete"),
        (lambda m, e: m.DQNConfig(**dev(m)), "env required"),
    ]
    for make, match in cases:
        with pytest.raises(ValueError, match=match) as want:
            make(jrl, jrl).build()
        with pytest.raises(ValueError, match=match) as got:
            make(trl, trl).build()
        assert str(got.value) == str(want.value)


def dev(module):
    return {"device": "cpu"} if module is trl else {}


def test_configs_mirror_the_jax_fields_and_defaults():
    for name in ("DQNConfig", "SimpleQConfig", "RainbowConfig", "PGConfig",
                 "R2D2Config", "TD3Config", "DDPGConfig", "SACConfig"):
        want = {f.name: f.default for f in dataclasses.fields(
            getattr(jrl, name))}
        got = {f.name: f.default for f in dataclasses.fields(
            getattr(trl, name))}
        assert set(got) - set(want) == {"device"}, name
        for k, v in want.items():
            assert got[k] == v, (name, k)


def test_entry_points_raise_without_cuda_and_device():
    with unittest.mock.patch.object(torch.cuda, "is_available",
                                    lambda: False):
        for cfg in (trl.DQNConfig(env=trl.CartPole),
                    trl.SACConfig(env=trl.Pendulum),
                    trl.TD3Config(env=trl.Pendulum),
                    trl.R2D2Config(env=trl.MemoryCue),
                    trl.PGConfig(env=trl.CartPole)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cfg.build()
