"""The port's reinforcement learning (`ray_tpu_torch.rl`, `.train.RLTrainer`,
`.air`) against the JAX package's on the CPU.

The JAX package draws from ``jax.random`` keys, which torch cannot
reproduce, so each comparison gives both packages the same draws: the
JAX test side turns the keys the JAX code would consume into the values it
would draw (env reset draws, Gumbel / normal sampling noise, minibatch
permutations), and the port takes those values as arguments.  Weights are
the JAX init carried over with `convert.policy_params_from_numpy`.

Tolerances (fp32): env steps, policy forwards, connectors and GAE within
rtol 1e-5 (summation order only); one update's params and Adam moments
within rtol 1e-4 (two epochs of gradient sums in another order, each Adam
step bounded by lr); sampled actions, rewards and dones exactly.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import rl as jrl
from ray_tpu.rl import connectors as jconn
from ray_tpu.rl import ppo as jppo
from ray_tpu_torch import rl as trl
from ray_tpu_torch.air import Checkpoint, Result
from ray_tpu_torch.convert import policy_params_from_numpy
from ray_tpu_torch.rl import connectors as tconn
from ray_tpu_torch.rl import ppo as tppo
from ray_tpu_torch.train import RLTrainer

RTOL, ATOL = 1e-5, 1e-6          # forwards, env steps, connectors, GAE
UPD_RTOL, UPD_ATOL = 1e-4, 1e-6  # one update's params and Adam state
ENVS = ["CartPole", "MemoryCue", "Pendulum", "PixelPong", "GridTarget"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


def _tree_close(got, want, rtol=RTOL, atol=ATOL):
    """A port tree (dicts, lists, tensors) against a JAX tree; conv kernels
    compared in the JAX layout."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w, rtol, atol)
    else:
        g = got.detach()
        if g.dim() == 4:
            g = g.permute(2, 3, 1, 0)          # OIHW -> HWIO
        _close(g, want, rtol, atol)


# -- the JAX side's draws ------------------------------------------------------

def _reset_draws_one(name, key):
    """The draws the JAX env's reset(key) makes, as values."""
    if name == "CartPole":
        return {"obs": jax.random.uniform(key, (4,), minval=-0.05,
                                          maxval=0.05)}
    if name == "MemoryCue":
        return {"cue": jax.random.bernoulli(key)}
    if name == "Pendulum":
        k1, k2 = jax.random.split(key)
        return {"th": jax.random.uniform(k1, (), minval=-jnp.pi,
                                         maxval=jnp.pi),
                "thdot": jax.random.uniform(k2, (), minval=-1.0, maxval=1.0)}
    if name == "PixelPong":
        kb, kp = jax.random.split(key)
        kx, kv = jax.random.split(kb)
        return {"x": jax.random.uniform(kx, minval=0.2, maxval=0.8),
                "vx": jax.random.uniform(kv, minval=-0.03, maxval=0.03),
                "paddle": jax.random.uniform(kp)}
    ka, kt = jax.random.split(key)
    n = jrl.GridTarget.N
    return {"agent": jax.random.randint(ka, (2,), 0, n),
            "target": jax.random.randint(kt, (2,), 0, n)}


@functools.lru_cache(maxsize=None)
def _jitted(what, arg):
    """One jitted JAX draw function per env (or action count), compiled
    once for the module."""
    if what == "reset":
        return jax.jit(jax.vmap(lambda k: _reset_draws_one(arg, k)))
    return jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (arg,))))


def _reset_draws(name, keys):
    return {k: _t(v) for k, v in _jitted("reset", name)(keys).items()}


def _gumbel(keys, n_actions):
    return _t(_jitted("gumbel", n_actions)(keys))


# -- envs ----------------------------------------------------------------------

def _state_to_port(state):
    return {k: _t(v) for k, v in _np(state).items()}


@pytest.mark.parametrize("name", ENVS)
def test_env_reset_and_steps_match_jax(name):
    """Reset from the same draws, then 12 steps, each from the JAX env's
    state, with the same actions and reset draws; the episodes are set to
    end at spread-out steps so the auto-reset runs."""
    n, steps = 16, 12
    jenv, tenv = getattr(jrl, name)(), getattr(trl, name)(device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate, tobs = tenv.reset_given(_reset_draws(name, keys))
    _close(tobs, jobs)
    for k, v in _np(jstate).items():
        _close(tstate[k], v)
    # episode ends spread over the steps below (time limits included)
    t0 = jenv.max_episode_steps - 1 - (np.arange(n) % steps)
    jstate = dict(jstate, t=jnp.asarray(t0, jnp.int32))
    rng = np.random.default_rng(0)
    jstep = jax.jit(jax.vmap(jenv.step))
    ended = 0
    key = jax.random.PRNGKey(2)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        skeys = jax.random.split(sub, n)
        if jenv.discrete:
            action = rng.integers(0, jenv.action_size, n).astype(np.int32)
        else:
            action = rng.normal(0, 2, (n, jenv.action_size)).astype(
                np.float32)
        out = jstep(jstate, jnp.asarray(action), skeys)
        got = tenv.step_given(_state_to_port(jstate), _t(action),
                              _reset_draws(name, skeys))
        for k, v in _np(out[0]).items():
            _close(got[0][k], v)
        _close(got[1], out[1])
        _close(got[2], out[2])
        assert got[3].tolist() == np.asarray(out[3]).tolist()
        ended += int(np.asarray(out[3]).sum())
        jstate = out[0]
    assert ended >= n


def test_env_draws_its_own_and_steps_on_its_generator():
    env = trl.PixelPong(device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(4, gen)
    assert obs.shape == (4, env.observation_size)
    assert obs.view(4, 24, 24, 3)[:, :, :, 0].sum(dim=(1, 2)).tolist() == \
        [1.0] * 4
    state, obs, reward, done = env.step(state, torch.ones(4, dtype=torch.long),
                                        gen)
    assert reward.dtype == torch.float32 and done.dtype == torch.bool
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import unittest.mock
        with unittest.mock.patch.object(torch.cuda, "is_available",
                                        lambda: False):
            trl.CartPole()


# -- policies ------------------------------------------------------------------

POLICIES = {
    "mlp": lambda m, **kw: m.MLPPolicy(6, 3, hidden=(8, 8), **kw),
    "mlp-gauss": lambda m, **kw: m.MLPPolicy(5, 2, discrete=False,
                                             hidden=(8,), **kw),
    "conv": lambda m, **kw: m.ConvPolicy(
        (7, 6, 2), 4, hidden=(8,), conv_filters=((4, 3, 1), (3, 2, 2)),
        **kw),
}


def _pair(kind):
    """(JAX policy, port policy, JAX init params, the same converted)."""
    jpol, tpol = POLICIES[kind](jrl), POLICIES[kind](trl, device="cpu")
    jparams = jpol.init(jax.random.PRNGKey(0))
    return jpol, tpol, jparams, policy_params_from_numpy(tpol, _np(jparams))


@pytest.mark.parametrize("kind", list(POLICIES))
def test_policy_forward_logp_and_sampling_match_jax(kind):
    jpol, tpol, jparams, tparams = _pair(kind)
    b = 9
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(b, jpol.obs_size if kind != "conv" else 84)
                     ).astype(np.float32)
    pi, v = jax.jit(jax.vmap(lambda o: jpol.forward(jparams, o)))(obs)
    tpi, tv = tpol.forward(tparams, _t(obs))
    _close(tpi, pi)
    _close(tv, v)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    act, logp, val = jax.jit(jax.vmap(
        lambda o, k: jpol.sample_action(jparams, o, k)))(obs, keys)
    if jpol.discrete:
        noise = _gumbel(keys, jpol.action_size)
    else:
        noise = _t(jax.vmap(lambda k: jax.random.normal(
            k, (jpol.action_size,)))(keys))
    tact, tlogp, tval = tpol.sample_action(tparams, _t(obs), noise=noise)
    if jpol.discrete:
        assert tact.tolist() == np.asarray(act).tolist()
    else:
        _close(tact, act)
    _close(tlogp, logp)
    _close(tval, val)
    lp, ent, v2 = jax.jit(jax.vmap(
        lambda o, a: jpol.log_prob(jparams, o, a)))(obs, act)
    tlp, tent, tv2 = tpol.log_prob(tparams, _t(obs), _t(act))
    for got, want in ((tlp, lp), (tent, ent), (tv2, v2)):
        _close(got, want)


def test_gaussian_head_clips_log_std():
    pol = trl.MLPPolicy(2, 1, discrete=False, hidden=(4,), device="cpu")
    params = pol.init(torch.Generator().manual_seed(0))
    params["pi"]["b"] = torch.tensor([0.0, 9.0])
    _, ent, _ = pol.log_prob(params, torch.zeros(3, 2), torch.zeros(3, 1))
    want = 2.0 + 0.5 * math.log(2 * math.pi * math.e)
    _close(ent[0], want, atol=1e-3)


def test_conv_weights_convert_and_features_flatten_in_nhwc_order():
    jpol, tpol, jparams, tparams = _pair("conv")
    assert tparams["convs"][0]["w"].shape == (4, 2, 3, 3)
    assert np.asarray(jparams["convs"][0]["w"]).shape == (3, 3, 2, 4)
    obs = np.random.default_rng(2).normal(size=(3, 84)).astype(np.float32)
    x = jnp.asarray(obs).reshape((3,) + jpol.obs_shape)
    for layer, (_o, _k, s) in zip(jparams["convs"], jpol.conv_filters):
        x = jnp.tanh(jax.lax.conv_general_dilated(
            x, layer["w"], (s, s), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + layer["b"])
    want = np.asarray(x).reshape(3, -1)
    t = _t(obs).reshape((3,) + tpol.obs_shape).permute(0, 3, 1, 2)
    for layer, (_o, _k, s) in zip(tparams["convs"], tpol.conv_filters):
        t = torch.tanh(torch.nn.functional.conv2d(t, layer["w"], layer["b"],
                                                  stride=s))
    _close(t.permute(0, 2, 3, 1).reshape(3, -1), want)
    with pytest.raises(ValueError, match="shape"):
        bad = _np(jparams)
        bad["convs"][0]["w"] = bad["convs"][0]["w"][:2]
        policy_params_from_numpy(tpol, bad)
    with pytest.raises(ValueError, match="keys"):
        policy_params_from_numpy(tpol, {"torso": _np(jparams)["torso"]})


def test_lstm_policy_over_a_sequence_matches_jax():
    """The cell's gate order and forget-gate bias, the recurrent sampling
    (one key for the batch), and the replay over a sequence with resets."""
    jpol = jrl.LSTMPolicy(5, 3, hidden=(8,), lstm_size=6)
    tpol = trl.LSTMPolicy(5, 3, hidden=(8,), lstm_size=6, device="cpu")
    jparams = jpol.init(jax.random.PRNGKey(3))
    tparams = policy_params_from_numpy(tpol, _np(jparams))
    t_len, b = 5, 4
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(t_len, b, 5)).astype(np.float32)
    done = rng.random((t_len, b)) < 0.3
    jstate, tstate = jpol.initial_state(b), tpol.initial_state(b)
    key = jax.random.PRNGKey(4)
    acts = []
    for t in range(t_len):
        key, sub = jax.random.split(key)
        a, lp, v, jstate = jpol.sample_action_recurrent(jparams, obs[t],
                                                        jstate, sub)
        noise = _t(jax.random.gumbel(sub, (b, 3)))
        ta, tlp, tv, tstate = tpol.sample_action_recurrent(
            tparams, _t(obs[t]), tstate, noise=noise)
        assert ta.tolist() == np.asarray(a).tolist()
        for got, want in ((tlp, lp), (tv, v), (tstate[0], jstate[0]),
                          (tstate[1], jstate[1])):
            _close(got, want)
        acts.append(np.asarray(a))
    acts = np.stack(acts)
    init = (np.full((b, 6), 0.1, np.float32), np.full((b, 6), -0.2,
                                                      np.float32))
    want = jax.jit(lambda p, *a: jpol.log_prob_seq(p, *a))(
        jparams, obs, acts, done, init)
    got = tpol.log_prob_seq(tparams, _t(obs), _t(acts), _t(done),
                            (_t(init[0]), _t(init[1])))
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(TypeError, match="recurrent state"):
        tpol.forward(tparams, _t(obs[0]))


# -- connectors ----------------------------------------------------------------

def _conn_pair(name):
    if name == "normalizer":
        return jconn.ObsNormalizer(3), tconn.ObsNormalizer(3)
    if name == "framestack":
        return jconn.FrameStack(3, k=2), tconn.FrameStack(3, k=2)
    if name == "clip_reward":
        return jconn.ClipReward(-0.5, 0.5), tconn.ClipReward(-0.5, 0.5)
    if name == "clip_actions":
        return jconn.ClipActions(0.7), tconn.ClipActions(0.7)
    return jconn.UnsquashActions(2.0), tconn.UnsquashActions(2.0)


def _to_port(state):
    return jax.tree_util.tree_map(lambda x: _t(x), _np(state))


@pytest.mark.parametrize("name", ["normalizer", "framestack", "clip_reward",
                                  "clip_actions", "unsquash"])
def test_connector_matches_jax_alone_and_batched(name):
    """Each connector on one stream (three calls, the state carried), and
    over a batch of envs as the JAX package's ``jax.vmap`` runs it."""
    jc, tc = _conn_pair(name)
    rng = np.random.default_rng(4)
    shape = (3,) if name == "framestack" else (5, 3)
    jstate, tstate = jc.init_state(), tc.init_state("cpu")
    for _ in range(3):
        x = rng.normal(size=shape).astype(np.float32) * 2
        jstate, jout = jc(jstate, jnp.asarray(x))
        tstate, tout = tc(tstate, _t(x))
        _close(tout, jout)
        jax.tree_util.tree_map(lambda w, g: _close(g, w), _np(jstate),
                               jax.tree_util.tree_map(
                                   lambda t: t.numpy(), tstate))
    n = 4
    jpipe, tpipe = jconn.ConnectorPipeline([jc]), tconn.ConnectorPipeline(
        [tc])
    jstates, tstates = jpipe.init_state_batch(n), tpipe.init_state_batch(
        n, "cpu")
    batched = tpipe.vmapped(n)
    for _ in range(3):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        jstates, jout = jax.vmap(jpipe)(jstates, jnp.asarray(x))
        tstates, tout = batched(tstates, _t(x))
        _close(tout, jout)
    jax.tree_util.tree_map(lambda w, g: _close(g, w), _np(jstates),
                           jax.tree_util.tree_map(lambda t: t.numpy(),
                                                  tstates))
    assert tpipe.out_size(3) == jpipe.out_size(3)


def test_pipeline_resets_only_what_resets_on_done():
    n = 4
    mk = [lambda m: m.FrameStack(2, k=3), lambda m: m.ObsNormalizer(6)]
    jpipe = jconn.ConnectorPipeline([f(jconn) for f in mk])
    tpipe = tconn.ConnectorPipeline([f(tconn) for f in mk])
    js, ts = jpipe.init_state_batch(n), tpipe.init_state_batch(n, "cpu")
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    js, _ = jax.vmap(jpipe)(js, jnp.asarray(x))
    ts, _ = tpipe.batched(ts, _t(x))
    done = np.array([True, False, True, False])
    js = jpipe.reset_where(js, jnp.asarray(done))
    ts = tpipe.reset_where(ts, _t(done))
    jax.tree_util.tree_map(lambda w, g: _close(g, w), _np(js),
                           jax.tree_util.tree_map(lambda t: t.numpy(), ts))
    assert float(ts[0][0].abs().sum()) == 0 and float(
        ts[0][1].abs().sum()) > 0
    with pytest.raises(ValueError, match="accepts only 'obs'"):
        tconn.ConnectorPipeline([tconn.ClipReward()]).validate_kind(
            "obs", "PPOConfig.connectors")


# -- GAE and the updates -------------------------------------------------------

def test_compute_gae_matches_jax():
    rng = np.random.default_rng(5)
    t_len, b = 7, 5
    traj = {"reward": rng.normal(size=(t_len, b)).astype(np.float32),
            "value": rng.normal(size=(t_len, b)).astype(np.float32),
            "done": rng.random((t_len, b)) < 0.25}
    last = rng.normal(size=b).astype(np.float32)
    adv, ret = jppo.compute_gae(traj, jnp.asarray(last), 0.99, 0.95)
    tadv, tret = tppo.compute_gae({k: _t(v) for k, v in traj.items()},
                                  _t(last), 0.99, 0.95)
    _close(tadv, adv)
    _close(tret, ret)


def _perms(key, epochs, n):
    perms = []
    for _ in range(epochs):
        key, pkey = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pkey, n)))
    return _t(np.stack(perms)).long()


def _opt_state_close(tstate, jstate, tparams):
    """The port's Adam state against optax's (the chain's second state)."""
    adam = jstate[1][0]
    assert tstate["count"] == int(adam.count)
    _tree_close(tstate["mu"], _np(adam.mu), UPD_RTOL, UPD_ATOL)
    _tree_close(tstate["nu"], _np(adam.nu), UPD_RTOL, 1e-10)


@pytest.mark.parametrize("max_grad_norm", [0.5, 1e3])
def test_make_update_fn_matches_jax(max_grad_norm):
    """Two epochs of two minibatches from the same params, batch and
    permutations: the loss parts, the params and the Adam state.  At 0.5
    the global-norm clip scales the gradients, at 1e3 it does not."""
    cfg = jrl.PPOConfig(num_sgd_epochs=2, num_minibatches=2, lr=1e-2,
                        max_grad_norm=max_grad_norm)
    jpol, tpol, jparams, tparams = _pair("mlp")
    n = 32
    rng = np.random.default_rng(6)
    flat = {"obs": rng.normal(size=(n, 6)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "logp": np.log(rng.uniform(0.2, 0.5, n)).astype(np.float32),
            "adv": rng.normal(size=n).astype(np.float32),
            "ret": rng.normal(size=n).astype(np.float32)}
    jopt = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                       optax.adam(cfg.lr))
    key = jax.random.PRNGKey(7)
    jout = jax.jit(jppo.make_update_fn(jpol, jopt, cfg, n))(
        jparams, jopt.init(jparams), flat, key)
    topt = tppo.ClippedAdam(cfg.max_grad_norm, cfg.lr)
    tstate = topt.init(tparams)
    _, _, metrics = tppo.make_update_fn(tpol, topt, cfg, n)(
        tparams, tstate, {k: _t(v) for k, v in flat.items()}, None,
        perms=_perms(key, 2, n))
    _tree_close(tparams, _np(jout[0]), UPD_RTOL, UPD_ATOL)
    _opt_state_close(tstate, jout[1], tparams)
    for k, v in jout[3].items():
        _close(metrics[k], v, UPD_RTOL, UPD_ATOL)


def test_make_recurrent_update_fn_matches_jax():
    cfg = jrl.PPOConfig(num_sgd_epochs=2, num_minibatches=3, lr=1e-2)
    jpol = jrl.LSTMPolicy(4, 2, hidden=(8,), lstm_size=5)
    tpol = trl.LSTMPolicy(4, 2, hidden=(8,), lstm_size=5, device="cpu")
    jparams = jpol.init(jax.random.PRNGKey(8))
    tparams = policy_params_from_numpy(tpol, _np(jparams))
    t_len, n = 6, 4          # 3 minibatches do not divide 4 envs: 2 of 2
    rng = np.random.default_rng(8)
    batch = {"obs": rng.normal(size=(t_len, n, 4)).astype(np.float32),
             "action": rng.integers(0, 2, (t_len, n)).astype(np.int32),
             "logp": np.log(rng.uniform(0.3, 0.7, (t_len, n))).astype(
                 np.float32),
             "done": rng.random((t_len, n)) < 0.2,
             "adv": rng.normal(size=(t_len, n)).astype(np.float32),
             "ret": rng.normal(size=(t_len, n)).astype(np.float32)}
    init = (rng.normal(size=(n, 5)).astype(np.float32),
            rng.normal(size=(n, 5)).astype(np.float32))
    jopt = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                       optax.adam(cfg.lr))
    key = jax.random.PRNGKey(9)
    jout = jax.jit(jppo.make_recurrent_update_fn(jpol, jopt, cfg, n))(
        jparams, jopt.init(jparams), batch, init, key)
    topt = tppo.ClippedAdam(cfg.max_grad_norm, cfg.lr)
    tstate = topt.init(tparams)
    _, _, metrics = tppo.make_recurrent_update_fn(tpol, topt, cfg, n)(
        tparams, tstate, {k: _t(v) for k, v in batch.items()},
        (_t(init[0]), _t(init[1])), None, perms=_perms(key, 2, n))
    _tree_close(tparams, _np(jout[0]), UPD_RTOL, UPD_ATOL)
    _opt_state_close(tstate, jout[1], tparams)
    for k, v in jout[3].items():
        _close(metrics[k], v, UPD_RTOL, UPD_ATOL)


# -- a whole iteration ---------------------------------------------------------

def _iteration_draws(algo, env_name, n_actions, steps, epochs, batch):
    """The draws a JAX PPO iteration makes from its key: per step the
    Gumbel noise and the envs' reset draws, then the epochs'
    permutations."""
    key = algo.key
    n = algo.config.num_envs
    draws = []
    for _ in range(steps):
        key, akey, skey = jax.random.split(key, 3)
        draws.append({"noise": _gumbel(jax.random.split(akey, n), n_actions),
                      "reset": _reset_draws(env_name,
                                            jax.random.split(skey, n))})
    return draws, _perms(key, epochs, batch)


@pytest.mark.parametrize("env_name,env_chunk", [("CartPole", None),
                                                ("GridTarget", 4)])
def test_a_ppo_iteration_from_the_same_draws_matches_jax(env_name,
                                                         env_chunk):
    """One PPO iteration (8 envs x 8 steps, 2 epochs x 2 minibatches) of the
    JAX package's PPO and the port's from the JAX init, the JAX reset and
    the iteration's draws: trajectory-driven state, metrics and params.
    GridTarget takes the conv policy, and the port bounds each forward to
    4 envs."""
    kw = dict(num_envs=8, rollout_length=8, num_sgd_epochs=2,
              num_minibatches=2, lr=3e-3, seed=0, hidden=(8,),
              model=({"hidden": (8,), "conv_filters": ((4, 3, 1),)}
                     if env_name == "GridTarget" else None))
    jalgo = jrl.PPOConfig(env=getattr(jrl, env_name), **kw).build()
    talgo = tppo.PPOConfig(env=getattr(trl, env_name), device="cpu",
                           env_chunk=env_chunk, **kw).build()
    # the JAX init and reset: PRNGKey(seed) -> (key, params key, env key)
    _, _, ekey = jax.random.split(jax.random.PRNGKey(0), 3)
    talgo.params = policy_params_from_numpy(talgo.policy,
                                            _np(jalgo.params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    talgo.env_states, talgo.obs = talgo.env.reset_given(
        _reset_draws(env_name, jax.random.split(ekey, 8)))
    _close(talgo.obs, jalgo.obs)
    draws, perms = _iteration_draws(jalgo, env_name,
                                    jalgo.env.action_size, 8, 2, 64)
    jres = jalgo.train()
    tres = talgo.training_step(draws=draws, perms=perms)
    _close(talgo.obs, jalgo.obs)
    for k, v in _np(jalgo.env_states).items():
        _close(talgo.env_states[k], v)
    _close(tres["reward_sum"], jres["reward_sum"])
    assert talgo._ep_done_returns == pytest.approx(jalgo._ep_done_returns)
    for k in ("pi_loss", "vf_loss", "entropy"):
        _close(tres[k], jres[k], UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)


def test_a_chunked_rollout_equals_the_flat_one():
    env = trl.CartPole(device="cpu")
    pol = trl.MLPPolicy(4, 2, hidden=(8,), device="cpu")
    params = pol.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    state, obs = env.reset(8, gen)
    draws = [{"noise": pol.draw_noise(8, gen),
              "reset": env.reset_draws(8, gen)} for _ in range(5)]
    outs = [tppo.make_rollout_fn(env, pol, 8, 5, env_chunk=c)(
        params, state, obs, (), None, draws) for c in (None, 2)]
    # the same draws give the same actions; values and log-probs differ
    # only in the products' summation order over other block shapes
    for k in ("obs", "action", "reward", "done"):
        assert torch.equal(outs[0][0][k], outs[1][0][k]), k
    for k in ("logp", "value"):
        _close(outs[1][0][k], outs[0][0][k].numpy())
    _close(outs[1][4], outs[0][4].numpy())


def test_env_chunk_and_worker_guards():
    cp = dict(env=trl.CartPole, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tppo.PPOConfig(num_envs=10, env_chunk=4, **cp).build()
    with pytest.raises(ValueError, match="positive"):
        tppo.PPOConfig(num_envs=8, env_chunk=-1, **cp).build()
    with pytest.raises(ValueError, match="feedforward"):
        tppo.PPOConfig(num_envs=8, env_chunk=4, model={"use_lstm": True},
                       **cp).build()
    with pytest.raises(ValueError, match="recurrent policies"):
        tppo.make_rollout_fn(trl.CartPole(device="cpu"),
                             trl.LSTMPolicy(4, 2, device="cpu"), 8, 4)
    with pytest.raises(ValueError, match="env required"):
        tppo.PPOConfig(device="cpu").build()
    with pytest.raises(NotImplementedError, match="item 10"):
        tppo.PPOConfig(num_workers=2, **cp).build()
    with pytest.raises(NotImplementedError, match="item 10"):
        trl.PPO.to_trainable(tppo.PPOConfig(**cp))


def test_a2c_is_the_jax_presets_ppo():
    want = {f.name: f.default for f in dataclasses.fields(jrl.A2CConfig)}
    got = {f.name: f.default for f in dataclasses.fields(trl.A2CConfig)}
    for k in ("num_sgd_epochs", "num_minibatches", "clip_eps", "lr",
              "gamma", "gae_lambda", "entropy_coeff", "vf_coeff"):
        assert got[k] == want[k], k
    res = trl.A2CConfig(env=trl.CartPole, num_envs=4, rollout_length=8,
                        device="cpu").build().train()
    assert res["env_steps_this_iter"] == 32 and np.isfinite(res["pi_loss"])


def test_recurrent_ppo_trains_on_memorycue():
    algo = tppo.PPOConfig(env=trl.MemoryCue, num_envs=8, rollout_length=16,
                          num_minibatches=2, model={"use_lstm": True,
                                                    "hidden": (8,),
                                                    "lstm_cell_size": 8},
                          device="cpu").build()
    assert isinstance(algo.policy, trl.LSTMPolicy)
    res = algo.train()
    assert np.isfinite(res["pi_loss"]) and res["env_steps_this_iter"] == 128


# -- catalog, checkpoints, the trainer -----------------------------------------

def test_catalog_choices_and_guards():
    cp, grid = trl.CartPole(device="cpu"), trl.GridTarget(device="cpu")
    assert type(trl.build_policy(cp, device="cpu")) is trl.MLPPolicy
    conv = trl.build_policy(grid, device="cpu")
    assert type(conv) is trl.ConvPolicy and conv.obs_shape == (5, 5, 2)
    assert conv.conv_filters == ((16, 3, 1), (32, 3, 1))
    # a connector that resizes the image keeps the MLP path
    assert type(trl.build_policy(grid, obs_size_override=100,
                                 device="cpu")) is trl.MLPPolicy
    lstm = trl.build_policy(cp, {"use_lstm": True, "lstm_cell_size": 7},
                            device="cpu")
    assert type(lstm) is trl.LSTMPolicy and lstm.lstm_size == 7
    with pytest.raises(ValueError, match="conv torso"):
        trl.build_policy(grid, {"use_lstm": True}, device="cpu")
    with pytest.raises(ValueError, match="not registered"):
        trl.build_policy(cp, {"custom_model": "nope"}, device="cpu")
    with pytest.raises(ValueError, match="use_lstm is not supported"):
        trl.build_policy(cp, {"custom_model": "x", "use_lstm": True},
                         device="cpu")
    seen = {}

    def factory(obs_size, action_size, discrete, device, width):
        seen.update(obs=obs_size, width=width)
        return trl.MLPPolicy(obs_size, action_size, hidden=(width,),
                             device=device)

    trl.register_custom_model("port-test", factory)
    pol = trl.build_policy(cp, {"custom_model": "port-test",
                                "custom_model_config": {"width": 5}},
                           device="cpu")
    assert seen == {"obs": 4, "width": 5} and pol.hidden == (5,)


def test_checkpoint_round_trips(tmp_path):
    data = {"a": np.arange(3), "b": {"c": 1.5}}
    for ck in (Checkpoint.from_dict(data),
               Checkpoint.from_bytes(Checkpoint.from_dict(data).to_bytes()),
               Checkpoint.from_directory(
                   Checkpoint.from_dict(data).to_directory(
                       str(tmp_path / "d")))):
        out = ck.to_dict()
        assert out["b"] == {"c": 1.5} and out["a"].tolist() == [0, 1, 2]
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "f.txt").write_bytes(b"x")
    ck = Checkpoint.from_bytes(Checkpoint.from_directory(str(raw)).to_bytes())
    assert ck.to_dict() == {"__files__": {"f.txt": b"x"}}
    back = Checkpoint.from_dict(ck.to_dict()).to_directory(
        str(tmp_path / "back"))
    assert (tmp_path / "back" / "f.txt").read_bytes() == b"x" and back
    with pytest.raises(ValueError, match="exactly one"):
        Checkpoint()
    with pytest.raises(ValueError, match="not a directory"):
        Checkpoint.from_directory(str(tmp_path / "missing"))


def test_rltrainer_fit_stops_and_its_checkpoint_restores():
    cfg = tppo.PPOConfig(env=trl.CartPole, num_envs=4, rollout_length=16,
                         connectors=[trl.ObsNormalizer(4)], device="cpu")
    seen = []
    result = RLTrainer(cfg, iterations=5, stop={"training_iteration": 2},
                       on_result=seen.append).fit()
    assert isinstance(result, Result) and len(seen) == 2
    assert result.metrics["training_iteration"] == 2
    algo = cfg.build()
    algo.restore(result.checkpoint)
    state = result.checkpoint.to_dict()
    assert algo.iteration == 2
    for got, want in zip(trl.policy.tree_leaves(algo.params),
                         trl.policy.tree_leaves(state["params"])):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(algo.conn_state[0]["count"].numpy(),
                          state["conn_state"][0]["count"])
    # the update changes params in place: a saved state must not follow it
    saved = algo.save().to_dict()
    before = [w.copy() for w in trl.policy.tree_leaves(saved["params"])]
    algo.train()
    assert all(np.array_equal(a, b) for a, b in zip(
        before, trl.policy.tree_leaves(saved["params"])))
    assert not all(np.array_equal(a, b.numpy()) for a, b in zip(
        before, trl.policy.tree_leaves(algo.params)))


def test_ppo_learns_cartpole():
    """As the JAX package's test_rl.py:31: untrained CartPole averages about
    20 a episode; a learning policy clears 50 in 15 iterations."""
    algo = tppo.PPOConfig(env=trl.CartPole, num_envs=16, rollout_length=64,
                          lr=1e-3, num_sgd_epochs=4, seed=0,
                          device="cpu").build()
    rewards = [algo.train()["episode_reward_mean"] for _ in range(15)]
    assert rewards[-1] > 50, rewards
    assert algo._total_env_steps == 15 * 16 * 64
