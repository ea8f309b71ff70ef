"""The port's IMPALA / APPO (inline), multi-agent RL (SpreadLine,
IndependentPPO, QMIX, MADDPG), offline RL (datasets, BC, MARWIL, CQL, CRR,
importance sampling) and contextual bandits (LinUCB, LinTS) against the
JAX package's on the CPU.

``jax.random`` streams cannot be reproduced, so each comparison gives both
packages the same draws: the test follows the JAX code's split chain from
its key and turns each key into the values it would draw (the envs' reset
draws, the Gumbel noise of ``jax.random.categorical``, the explorer's
uniform and randint, the replay's indices, Gaussian exploration noise, the
epochs' permutations, the bandit's normals), and the port takes those
values as arguments.  Weights are the JAX init carried over with
`convert.policy_params_from_numpy`.  Each JAX algorithm is built and run
once per module (module-scoped fixtures), since its jitted iteration
compiles on the first call.

Tolerances (fp32), each stated where it is used: forwards, env steps,
V-trace, mixers, returns and targets within rtol 1e-5 / atol 1e-6
(summation order only); a few Adam steps within rtol 1e-4 / atol 1e-6;
integers (actions, dones, indices, cursor, size) exactly; the bandits'
posteriors after 64 sequential solves within rtol 1e-4.
"""

import dataclasses
import functools
import types
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import rl as jrl
from ray_tpu.rl import offline as joff
from ray_tpu.rl import qmix as jqmix
from ray_tpu_torch import rl as trl
from ray_tpu_torch.convert import policy_params_from_numpy
from ray_tpu_torch.rl import qmix as tqmix

RTOL, ATOL = 1e-5, 1e-6          # forwards, env steps, targets
UPD_RTOL, UPD_ATOL = 1e-4, 1e-6  # a few Adam steps
BANDIT_RTOL = 1e-4               # 64 sequential ridge solves


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


def _adam_close(tstate, jstate):
    """The port's Adam state against optax's (found inside a chain)."""
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    assert np.all(np.asarray(adam.count) == tstate["count"])
    _tree_close(tstate["mu"], _np(adam.mu), UPD_RTOL, UPD_ATOL)
    _tree_close(tstate["nu"], _np(adam.nu), UPD_RTOL, 1e-10)


def _buffer_equal(tbuf, jbuf, exact=("action", "done")):
    """Cursor, size and the ``exact`` columns exactly; computed floats
    (observations, rewards, continuous actions) within the env-step
    bound."""
    assert tbuf["cursor"] == int(jbuf["cursor"])
    assert tbuf["size"] == int(jbuf["size"])
    for k, v in _np(jbuf["data"]).items():
        if k in exact:
            _equal(tbuf["data"][k], v)
        else:
            _close(tbuf["data"][k], v)


def _train(algo, draws=None, **kw):
    """`Algorithm.train` with the iteration's draws."""
    algo.iteration += 1
    res = algo.training_step(draws=draws, **kw) if draws is not None \
        else algo.training_step(**kw)
    algo._total_env_steps += res["env_steps_this_iter"]
    return res


def dev(module):
    return {"device": "cpu"} if module is trl else {}



# -- the JAX side's draws -----------------------------------------------------

def _spread_reset_one(n_agents, key):
    pkey, _ = jax.random.split(key)
    return jax.random.uniform(pkey, (n_agents,), minval=-1.0, maxval=1.0)


@functools.lru_cache(maxsize=None)
def _jitted(what, *args):
    """One jitted JAX draw function per kind and shape, compiled once."""
    if what == "cartpole":
        return jax.jit(jax.vmap(lambda k: jax.random.uniform(
            k, (4,), minval=-0.05, maxval=0.05)))
    if what == "spread":
        return jax.jit(jax.vmap(functools.partial(_spread_reset_one,
                                                  args[0])))
    if what == "gumbel":
        return jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (args[0],))))
    if what == "eps":                  # EpsilonGreedy's two draws
        shape, a = args

        def eps(key):
            k_choice, k_rand = jax.random.split(key)
            return (jax.random.uniform(k_choice, shape),
                    jax.random.randint(k_rand, shape, 0, a))
        return jax.jit(eps)
    raise ValueError(what)


def _cartpole_reset(keys):
    return {"obs": _t(_jitted("cartpole")(keys))}


def _spread_reset(keys, n_agents):
    return {"pos": _t(_jitted("spread", n_agents)(keys))}


def _gumbel(keys, n_actions):
    return _t(_jitted("gumbel", n_actions)(keys))


def _idx_draw(key, batch, size):
    return {"idx": _t(jax.random.randint(key, (batch,), 0,
                                         max(size, 1))).long()}


def _rollout_draws(key, steps, n, n_actions):
    """PPO's rollout draws over CartPole: per step ``key, akey, skey``, a
    Gumbel draw per env key, the reset draws per env key."""
    draws = []
    for _ in range(steps):
        key, akey, skey = jax.random.split(key, 3)
        draws.append({"noise": _gumbel(jax.random.split(akey, n), n_actions),
                      "reset": _cartpole_reset(jax.random.split(skey, n))})
    return draws


# -- IMPALA / APPO ------------------------------------------------------------

def _jax_vtrace_inputs(seed, T=7, B=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        behavior_logp=rng.normal(-1.0, 0.5, (T, B)).astype(f),
        target_logp=rng.normal(-1.0, 0.5, (T, B)).astype(f),
        values=rng.normal(size=(T, B)).astype(f),
        last_value=rng.normal(size=(B,)).astype(f),
        rewards=rng.normal(size=(T, B)).astype(f),
        dones=rng.random((T, B)) < 0.25)


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (0.8, 0.5),
                                           (5.0, 5.0)])
def test_vtrace_matches_jax(rho_bar, c_bar):
    """Ratios around 1 (logp difference of std 0.7), so both clips bind
    on many entries; dones cut the trace."""
    inputs = _jax_vtrace_inputs(1)
    kw = dict(gamma=0.9, rho_bar=rho_bar, c_bar=c_bar)
    want = jax.jit(functools.partial(jrl.impala.vtrace, **kw))(
        *(jnp.asarray(v) for v in inputs.values()))
    got = trl.vtrace(*(_t(v) for v in inputs.values()), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    if min(rho_bar, c_bar) < 1.0:
        return
    # on-policy (target == behaviour, no done) and unclipped: vs is the
    # discounted return bootstrapped from the last value (lambda = 1)
    inputs["target_logp"] = inputs["behavior_logp"]
    inputs["dones"][:] = False
    vs, _ = trl.vtrace(*(_t(v) for v in inputs.values()), **kw)
    ret = _t(inputs["last_value"]).double()
    for t in reversed(range(7)):
        ret = _t(inputs["rewards"][t]).double() + 0.9 * ret
        _close(vs[t], ret)


@functools.lru_cache(maxsize=None)
def _impala_run(cls_name):
    """One iteration of the JAX algorithm and of the port from its init,
    reset and draws; the pair and both results."""
    kw = dict(num_envs=8, rollout_length=8, hidden=(8,), seed=0)
    jalgo = getattr(jrl, cls_name)(env=jrl.CartPole, **kw).build()
    talgo = getattr(trl, cls_name)(env=trl.CartPole, device="cpu",
                                   **kw).build()
    talgo.params = policy_params_from_numpy(talgo.policy, _np(jalgo.params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    _, _, ekey = jax.random.split(jax.random.PRNGKey(0), 3)
    talgo.env_states, talgo.obs = talgo.env.reset_given(
        _cartpole_reset(jax.random.split(ekey, 8)))
    draws = _rollout_draws(jalgo.key, 8, 8, 2)
    jres = jalgo.train()
    tres = _train(talgo, draws)
    return jalgo, talgo, jres, tres


@pytest.mark.parametrize("cls_name", ["ImpalaConfig", "APPOConfig"])
def test_impala_iteration_matches_jax(cls_name):
    """One inline iteration (CartPole 8 x 8): the envs, the loss parts and
    the params and Adam state after the clipped-Adam step; rho is 1 (the
    behaviour policy is the target) within 1e-6."""
    jalgo, talgo, jres, tres = _impala_run(cls_name)
    _close(talgo.obs, jalgo.obs)
    for k in ("pi_loss", "vf_loss", "entropy", "mean_rho"):
        _close(tres[k], jres[k], UPD_RTOL, UPD_ATOL)
    assert abs(tres["mean_rho"] - 1.0) <= 1e-6
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    _adam_close(talgo.opt_state, jalgo.opt_state)
    assert talgo._ep_done_returns == pytest.approx(jalgo._ep_done_returns)


def test_impala_loss_parts_and_clipped_gradients_match_jax():
    """The V-trace loss of a batch away from the behaviour policy (rho
    and c clipped): vs and pg_adv against JAX's `vtrace` on JAX's
    log-probs, the loss parts, and the gradients before and after the
    global-norm clip (bound 0.05, under their norm).  The JAX gradients
    are what its learn function adds to the params with the optimizer
    swapped for the identity, so they carry the params' rounding: atol
    1e-6; optax's clip of them is the reference for the port's."""
    import optax

    jalgo, talgo, _, _ = _impala_run("ImpalaConfig")
    rng = np.random.default_rng(3)
    T, B = 6, 8
    batch = {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
             "action": rng.integers(0, 2, (T, B)).astype(np.int32),
             "logp": rng.normal(-0.7, 0.3, (T, B)).astype(np.float32),
             "reward": np.ones((T, B), np.float32),
             "done": rng.random((T, B)) < 0.2,
             "last_value": rng.normal(size=(B,)).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jalgo.params
    params = policy_params_from_numpy(talgo.policy, _np(jparams))
    _, aux, grads = trl.learner.value_and_grad(
        talgo.loss, params, {k: _t(v) for k, v in batch.items()})
    logp, _, value = jax.vmap(
        lambda o, a: jalgo.policy.log_prob(jparams, o, a))(
            jbatch["obs"].reshape(T * B, -1), jbatch["action"].reshape(-1))
    vs, pg_adv = jrl.impala.vtrace(
        jbatch["logp"], logp.reshape(T, B), value.reshape(T, B),
        jbatch["last_value"], jbatch["reward"], jbatch["done"], gamma=0.99,
        rho_bar=1.0, c_bar=1.0)
    _close(aux["vs"], vs)
    _close(aux["pg_adv"], pg_adv)
    assert float(torch.sqrt(sum((g * g).sum() for g in grads))) > 0.05
    saved = jalgo.optimizer
    jalgo.optimizer = optax.identity()
    try:
        new, _, jm = jax.jit(jalgo._make_learn_fn())(jparams, (), jbatch)
    finally:
        jalgo.optimizer = saved
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a)
                                    - np.asarray(b), new, jparams)
    jclipped, _ = optax.clip_by_global_norm(0.05).update(jgrads, ())
    for got, want in ((grads, jgrads),
                      (trl.ppo.clip_by_global_norm(grads, 0.05), jclipped)):
        for g, w in zip(got, jax.tree_util.tree_leaves(want)):
            _close(g, w, UPD_RTOL, ATOL)
    for k in ("pi_loss", "vf_loss", "entropy", "mean_rho"):
        _close(aux[k], jm[k], UPD_RTOL, UPD_ATOL)


def test_impala_refuses_remote_workers():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        trl.ImpalaConfig(env=trl.CartPole, num_workers=2,
                         device="cpu").build()


# -- multi-agent envs ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["SpreadLine", "SpreadLineContinuous"])
def test_spread_line_resets_and_steps_match_jax(kind):
    """Reset, then 7 steps of random actions over a horizon of 3, so
    every env auto-resets twice from the step's reset draws: state, obs,
    rewards within the env-step bound, dones and t exactly."""
    n, agents = 6, 4
    jenv = getattr(jrl, kind)(n_agents=agents, horizon=3)
    tenv = getattr(trl, kind)(n_agents=agents, horizon=3, device="cpu")
    key = jax.random.PRNGKey(4)
    key, rkey = jax.random.split(key)
    keys = jax.random.split(rkey, n)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    tstate, tobs = tenv.reset_given(_spread_reset(keys, agents))
    _close(tobs, jobs)
    rng = np.random.default_rng(5)
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(7):
        if tenv.discrete:
            act = rng.integers(0, 3, (n, agents)).astype(np.int32)
        else:
            act = rng.uniform(-1.5, 1.5, (n, agents, 1)).astype(np.float32)
        key, skey = jax.random.split(key)
        keys = jax.random.split(skey, n)
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(act), keys)
        tstate, tobs, trew, tdone = tenv.step_given(
            tstate, _t(act), _spread_reset(keys, agents))
        _close(tobs, jobs)
        _close(trew, jrew)
        _equal(tdone, jdone)
        _equal(tstate["t"], jstate["t"])
        _close(tstate["pos"], jstate["pos"])
    assert tenv.discrete == (kind == "SpreadLine")


# -- IndependentPPO -----------------------------------------------------------

def _ippo_draws(jalgo):
    """The iteration's draws: per rollout step ``key, akey, skey``, a
    Gumbel draw per (env, agent) key of ``split(akey, B * N)``, the reset
    draws per env key; then ``key, ukey``, a key per agent from ukey, and
    per epoch ``key_a, pkey`` and ``permutation(pkey, T * B)``."""
    cfg, n_agents = jalgo.config, jalgo.env.n_agents
    b, a = cfg.num_envs, jalgo.env.action_size
    key, draws = jalgo.key, []
    for _ in range(cfg.rollout_length):
        key, akey, skey = jax.random.split(key, 3)
        draws.append({
            "noise": _gumbel(jax.random.split(akey, b * n_agents),
                             a).reshape(b, n_agents, a),
            "reset": _spread_reset(jax.random.split(skey, b), n_agents)})
    key, ukey = jax.random.split(key)
    agent_keys = list(jax.random.split(ukey, n_agents))
    perms = []
    for _ in range(cfg.num_sgd_epochs):
        rows = []
        for i in range(n_agents):
            agent_keys[i], pkey = jax.random.split(agent_keys[i])
            rows.append(np.asarray(jax.random.permutation(
                pkey, cfg.rollout_length * b)))
        perms.append(torch.from_numpy(np.stack(rows)).long())
    return draws, perms


@functools.lru_cache(maxsize=None)
def _ippo_run(share):
    kw = dict(num_envs=4, rollout_length=6, hidden=(8,), num_sgd_epochs=2,
              share_parameters=share, seed=0)
    jalgo = jrl.IndependentPPOConfig(env=lambda: jrl.SpreadLine(3),
                                     **kw).build()
    talgo = trl.IndependentPPOConfig(
        env=lambda device: trl.SpreadLine(3, device=device), device="cpu",
        **kw).build()
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    _, _, ekey = jax.random.split(jax.random.PRNGKey(0), 3)
    talgo.env_states, talgo.obs = talgo.env.reset_given(
        _spread_reset(jax.random.split(ekey, 4), 3))
    _close(talgo.obs, jalgo.obs)
    draws, perms = _ippo_draws(jalgo)
    jres = jalgo.train()
    tres = _train(talgo, draws, perms=perms)
    return jalgo, talgo, jres, tres


@pytest.mark.parametrize("share", [False, True])
def test_independent_ppo_iteration_matches_jax(share):
    """One iteration (SpreadLine(3), 4 envs x 6 steps, 2 full-batch
    epochs per agent on its own permutations): the envs, each agent's
    loss and mean reward, the stacked params and Adam state.  Shared
    parameters start as copies and part after the update (an aliased
    expand would have stepped one tensor three times)."""
    jalgo, talgo, jres, tres = _ippo_run(share)
    _close(talgo.obs, jalgo.obs)
    _close(tres["reward_mean_per_agent"], jres["reward_mean_per_agent"])
    _close(tres["loss_per_agent"], jres["loss_per_agent"], UPD_RTOL,
           UPD_ATOL)
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    _adam_close(talgo.opt_state, jalgo.opt_state)
    assert tres["env_steps_this_iter"] == jres["env_steps_this_iter"] == 72
    w = talgo.params["torso"][0]["w"]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    if share:
        fresh = trl.IndependentPPOConfig(
            env=lambda device: trl.SpreadLine(3, device=device),
            share_parameters=True, hidden=(8,), device="cpu").build()
        w0 = fresh.params["torso"][0]["w"]
        # equal copies, each its own memory (an expand has stride 0)
        assert torch.equal(w0[0], w0[1]) and w0.stride(0) > 0


# -- QMIX ---------------------------------------------------------------------

def _mixer_pair(seed, state_size=6, n_agents=3, embed=4):
    jp = jax.jit(functools.partial(jqmix.mixer_init, state_size=state_size,
                                   n_agents=n_agents, embed=embed))(
        jax.random.PRNGKey(seed))
    shapes = types.SimpleNamespace(
        param_shapes=lambda: tqmix.mixer_shapes(state_size, n_agents, embed),
        device=torch.device("cpu"))
    return jp, policy_params_from_numpy(shapes, _np(jp))


def test_mixer_matches_jax_and_is_monotonic():
    """Q_tot within rtol 1e-5 on [5, 2] leading axes; its gradient in
    every agent's Q is >= 0, and raising one agent's Q never lowers
    Q_tot."""
    jp, tp = _mixer_pair(7)
    rng = np.random.default_rng(8)
    q = rng.normal(size=(5, 2, 3)).astype(np.float32)
    state = rng.normal(size=(5, 2, 6)).astype(np.float32)
    want = jax.jit(jqmix.mixer_apply)(jp, jnp.asarray(q), jnp.asarray(state))
    tq = _t(q).requires_grad_(True)
    got = trl.mixer_apply(tp, tq, _t(state))
    _close(got, want)
    (grad,) = torch.autograd.grad(got.sum(), tq)
    assert bool((grad >= 0).all())
    for a in range(3):
        bumped = _t(q).clone()
        bumped[..., a] += 0.5
        assert bool((trl.mixer_apply(tp, bumped, _t(state))
                     >= got.detach() - 1e-6).all())


def _qmix_draws(jalgo, size_after):
    """Per collect step ``key, akey, skey`` (the explorer's uniform and
    randint over [B, N] from ``split(akey)``, the reset draws per env
    key); then, past the gate, per update ``key, skey`` and the replay's
    randint."""
    cfg, n_agents = jalgo.config, jalgo.n_agents
    b, a = cfg.num_envs, jalgo.env.action_size
    key, collect = jalgo.key, []
    for _ in range(cfg.rollout_steps):
        key, akey, skey = jax.random.split(key, 3)
        u, r = _jitted("eps", (b, n_agents), a)(akey)
        collect.append({"uniform": _t(u), "random": _t(r).long(),
                        "reset": _spread_reset(jax.random.split(skey, b),
                                               n_agents)})
    updates = []
    if size_after >= cfg.learn_start:
        for _ in range(cfg.num_updates):
            key, skey = jax.random.split(key)
            updates.append(_idx_draw(skey, cfg.batch_size,
                                     min(size_after, cfg.buffer_capacity)))
    return {"collect": collect, "updates": updates}


QMIX_KW = dict(num_envs=4, rollout_steps=4, buffer_capacity=64,
               batch_size=8, num_updates=2, mixing_embed=4, learn_start=20,
               eps_decay_steps=40, hidden=(8,), seed=0)


@pytest.fixture(scope="module")
def qmix_run():
    """Three QMIX iterations from the JAX init, reset and draws: 16 rows
    (below learn_start 20: no update), 32 and 48 (2 updates each); the
    pair and each iteration's results and states."""
    jalgo = jrl.QMIXConfig(env=lambda: jrl.SpreadLine(3), **QMIX_KW).build()
    talgo = trl.QMIXConfig(
        env=lambda device: trl.SpreadLine(3, device=device), device="cpu",
        **QMIX_KW).build()
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    talgo.target_params = policy_params_from_numpy(
        talgo, _np(jalgo.target_params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    *_, ekey = jax.random.split(jax.random.PRNGKey(0), 4)
    talgo.env_states, talgo.obs = talgo.env.reset_given(
        _spread_reset(jax.random.split(ekey, 4), 3))
    steps = []
    for it in range(3):
        draws = _qmix_draws(jalgo, 16 * (it + 1))
        jres = jalgo.train()
        tres = _train(talgo, draws)
        steps.append((jres, tres, _np(jalgo.params), _np(jalgo.buffer)))
        _tree_close(talgo.params, steps[-1][2], UPD_RTOL, UPD_ATOL)
    return jalgo, talgo, steps


def test_qmix_iterations_across_the_gate_match_jax(qmix_run):
    """Epsilon from the env steps before each iteration (1.0, 0.62,
    0.24), the buffer rows, the loss (0 below the gate), params, targets
    and Adam state."""
    jalgo, talgo, steps = qmix_run
    eps = []
    for it, (jres, tres, _, _) in enumerate(steps):
        assert tres["epsilon"] == pytest.approx(jres["epsilon"], rel=1e-6)
        assert tres["buffer_size"] == jres["buffer_size"] == 16 * (it + 1)
        if it == 0:
            assert tres["td_loss"] == 0.0 == jres["td_loss"]
        else:
            assert tres["td_loss"] > 0
            _close(tres["td_loss"], jres["td_loss"], UPD_RTOL, UPD_ATOL)
        eps.append(tres["epsilon"])
    assert eps[0] > eps[1] > eps[2]
    _buffer_equal(talgo.buffer, jalgo.buffer)
    _tree_close(talgo.target_params, _np(jalgo.target_params), UPD_RTOL,
                UPD_ATOL)
    _adam_close(talgo.opt_state, jalgo.opt_state)
    assert talgo.opt_state["count"] == 4


# -- MADDPG -------------------------------------------------------------------

MADDPG_KW = dict(num_envs=4, rollout_steps=4, buffer_capacity=64,
                 batch_size=8, num_updates=2, learn_start=20, hidden=(8,),
                 seed=0)


def _maddpg_draws(jalgo, size_after):
    """Per collect step ``key, nkey, skey`` (the exploration normal over
    [B, N, act], the reset draws per env key); past the gate, per update
    ``key, skey`` and the replay's randint."""
    cfg, n_agents = jalgo.config, jalgo.n_agents
    b = cfg.num_envs
    key, collect = jalgo.key, []
    for _ in range(cfg.rollout_steps):
        key, nkey, skey = jax.random.split(key, 3)
        collect.append({
            "normal": _t(jax.random.normal(nkey, (b, n_agents, 1))),
            "reset": _spread_reset(jax.random.split(skey, b), n_agents)})
    updates = []
    if size_after >= cfg.learn_start:
        for _ in range(cfg.num_updates):
            key, skey = jax.random.split(key)
            updates.append(_idx_draw(skey, cfg.batch_size, size_after))
    return {"collect": collect, "updates": updates}


@pytest.fixture(scope="module")
def maddpg_run():
    """Three MADDPG iterations (SpreadLineContinuous(3), 4 envs x 4
    steps; 2 updates from the second on) from the JAX init, reset and
    draws."""
    jalgo = jrl.MADDPGConfig(env=lambda: jrl.SpreadLineContinuous(3),
                             **MADDPG_KW).build()
    talgo = trl.MADDPGConfig(
        env=lambda device: trl.SpreadLineContinuous(3, device=device),
        device="cpu", **MADDPG_KW).build()
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    talgo.targets = policy_params_from_numpy(talgo, _np(jalgo.targets))
    talgo.aopt_state = talgo.actor_opt.init(talgo.params["actor"])
    talgo.copt_state = talgo.critic_opt.init(talgo.params["critic"])
    *_, ekey = jax.random.split(jax.random.PRNGKey(0), 4)
    talgo.env_states, talgo.obs = talgo.env.reset_given(
        _spread_reset(jax.random.split(ekey, 4), 3))
    init = _np(jalgo.params)
    steps = []
    for it in range(3):
        draws = _maddpg_draws(jalgo, 16 * (it + 1))
        steps.append((jalgo.train(), _train(talgo, draws)))
    return jalgo, talgo, steps, init


def test_maddpg_act_and_critics_match_jax(maddpg_run):
    """`act` and `q_all` (stacked actors and centralized critics) on a
    [5] batch from the JAX init."""
    jalgo, talgo, _, init = maddpg_run
    rng = np.random.default_rng(9)
    obs = rng.normal(size=(5, 3, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (5, 3, 1)).astype(np.float32)
    params = policy_params_from_numpy(talgo, init)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    _close(talgo.act(params["actor"], _t(obs)),
           jalgo._act(jp["actor"], jnp.asarray(obs)))
    _close(talgo.q_all(params["critic"], _t(obs), _t(act)),
           jalgo._q_all(jp["critic"], jnp.asarray(obs), jnp.asarray(act)))


def test_maddpg_actor_gradient_reaches_each_actor_through_its_own_slot(
        maddpg_run):
    """The actor loss's gradients equal JAX's; actor j's gradient does not
    move when agent j's sampled action changes (critic j sees actor j's
    fresh action in slot j) nor when another agent's critic changes,
    while the other actors' gradients do move."""
    jalgo, talgo, _, init = maddpg_run
    rng = np.random.default_rng(10)
    batch = {"obs": rng.normal(size=(8, 3, 3)).astype(np.float32),
             "action": rng.uniform(-1, 1, (8, 3, 1)).astype(np.float32)}
    params = policy_params_from_numpy(talgo, init)
    jp = jax.tree_util.tree_map(jnp.asarray, init)

    def jax_actor_loss(ap, cp, b):
        my_act = jalgo._act(ap, b["obs"])
        eye = jnp.eye(3)[None, :, :, None]
        joint = b["action"][:, None] * (1 - eye) + my_act[:, None] * eye
        q = jax.vmap(lambda c, ja: jrl.td3._relu_mlp(c, jnp.concatenate(
            [b["obs"].reshape(8, -1), ja.reshape(8, -1)], -1))[..., 0],
            in_axes=(0, 1))(cp, joint)
        return -jnp.mean(q)

    def grads(p, b):
        tb = {k: _t(v) for k, v in b.items()}
        return trl.learner.value_and_grad(talgo.actor_loss, p["actor"],
                                          p["critic"], tb)[2]

    base = grads(params, batch)
    want = jax.grad(jax_actor_loss)(jp["actor"], jp["critic"],
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    for g, w in zip(base, jax.tree_util.tree_leaves(want)):
        _close(g, w, UPD_RTOL, ATOL)
    moved = dict(batch, action=batch["action"].copy())
    moved["action"][:, 1] += 0.3                      # agent 1's own slot
    other = grads(params, moved)
    for g, o in zip(base, other):
        assert torch.equal(g[1], o[1])
        assert not torch.equal(g[0], o[0]) or not torch.equal(g[2], o[2])
    critic = trl.policy.tree_map(torch.clone, params["critic"])
    for layer in critic:
        layer["w"][2] += 0.1                          # agent 2's critic
    other = grads({"actor": params["actor"], "critic": critic}, batch)
    for g, o in zip(base, other):
        assert torch.equal(g[0], o[0]) and torch.equal(g[1], o[1])


def test_maddpg_iterations_match_jax(maddpg_run):
    """Losses (0 below the gate), buffer rows, params, targets and both
    Adam states after 3 iterations (4 updates)."""
    jalgo, talgo, steps, _ = maddpg_run
    _buffer_equal(talgo.buffer, jalgo.buffer, exact=("done",))
    for it, (jres, tres) in enumerate(steps):
        assert tres["buffer_size"] == jres["buffer_size"]
        for k in ("critic_loss", "actor_loss"):
            if it == 0:
                assert tres[k] == 0.0 == jres[k]
            else:
                assert tres[k] != 0
                _close(tres[k], jres[k], UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.targets, _np(jalgo.targets), UPD_RTOL, UPD_ATOL)
    _adam_close(talgo.aopt_state, jalgo.aopt_state)
    _adam_close(talgo.copt_state, jalgo.copt_state)


# -- offline RL ---------------------------------------------------------------

def _jax_expert(obs, key):
    """The scripted CartPole expert of tests/test_offline_rl.py."""
    return (obs[2] + obs[3] > 0).astype(jnp.int32)


def _port_expert(obs, draws):
    return (obs[:, 2] + obs[:, 3] > 0).int()


def _dataset_draws(seed, n_steps, num_envs):
    """`collect_dataset`'s draws: ``key, ekey`` and a reset per env key,
    then per step ``key, akey, skey`` (the expert draws nothing)."""
    key, ekey = jax.random.split(jax.random.PRNGKey(seed))
    first = _cartpole_reset(jax.random.split(ekey, num_envs))
    steps = []
    for _ in range(-(-n_steps // num_envs)):
        key, _, skey = jax.random.split(key, 3)
        steps.append({"policy": None, "reset": _cartpole_reset(
            jax.random.split(skey, num_envs))})
    return {"reset": first, "steps": steps}


@pytest.fixture(scope="module")
def dataset():
    """150 rows from 4 envs (38 steps, cut), collected by both packages
    from the same draws."""
    want = joff.collect_dataset(jrl.CartPole, _jax_expert, n_steps=150,
                                num_envs=4, seed=3)
    got = trl.collect_dataset(trl.CartPole, _port_expert, n_steps=150,
                              num_envs=4, seed=3, device="cpu",
                              draws=_dataset_draws(3, 150, 4))
    return want, got


def test_collect_dataset_layout_and_npz_files_both_ways(dataset, tmp_path):
    """Env-major columns cut to n_steps, env_id marking the 38-row
    blocks, the JAX package's dtypes; a file either package saves loads
    in the other unchanged."""
    want, got = dataset
    assert set(got) == set(want) == {"obs", "action", "reward", "done",
                                     "next_obs", "env_id"}
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        if k in ("obs", "next_obs"):
            _close(got[k], want[k])
        else:
            _equal(got[k], want[k])
    _equal(got["env_id"][36:40], [0, 0, 1, 1])
    assert got["reward"].sum() == 150
    for saver, loader, data in ((trl.save_dataset, joff.load_dataset, got),
                                (joff.save_dataset, trl.load_dataset,
                                 want)):
        path = str(tmp_path / f"{saver.__module__}.npz")
        saver(path, data)
        back = loader(path)
        for k in data:
            assert back[k].dtype == data[k].dtype
            _equal(back[k], data[k])


def _epoch_perms(key, n, epochs):
    """Each epoch's ``key, pkey`` and ``permutation(pkey, n)``."""
    perms = []
    for _ in range(epochs):
        key, pkey = jax.random.split(key)
        perms.append(_t(jax.random.permutation(pkey, n)).long())
    return perms


OFFLINE = {"BC": dict(epochs_per_iter=2), "MARWIL": {}, "CQL": {},
           "CRR-binary": dict(weight_fn="binary"),
           "CRR-exp": dict(weight_fn="exp", beta=0.5)}


def _offline_run(name, want):
    """One iteration of an offline algorithm (batch 32 over the dataset's
    128 whole-minibatch rows) from the JAX init and permutations."""
    cls = name.split("-")[0]
    kw = dict(dataset=want, batch_size=32, hidden=(8,), seed=1,
              **OFFLINE[name])
    jalgo = getattr(jrl, f"{cls}Config")(env=jrl.CartPole, **kw).build()
    talgo = getattr(trl, f"{cls}Config")(env=trl.CartPole, device="cpu",
                                         **kw).build()
    jstate = jalgo.get_state()
    net = {"BC": talgo.policy if cls == "BC" else None,
           "CQL": getattr(talgo, "q", None)}.get(cls) or talgo
    talgo.params = policy_params_from_numpy(net, jstate["params"])
    if cls == "CQL":
        talgo.target_params = policy_params_from_numpy(
            talgo.q, jstate["target_params"])
    if cls == "CRR":
        talgo.target_q = policy_params_from_numpy(talgo.q,
                                                  jstate["target_q"])
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    perms = _epoch_perms(jalgo.key, 128, talgo.config.epochs_per_iter)
    jres = jalgo.train()
    tres = _train(talgo, perms=perms)
    return jalgo, talgo, jres, tres


@pytest.fixture(scope="module")
def offline(dataset):
    """``offline(name)``: `_offline_run` on the JAX dataset, once."""
    runs = {}

    def run(name):
        if name not in runs:
            runs[name] = _offline_run(name, dataset[0])
        return runs[name]
    return run


@pytest.mark.parametrize("name", list(OFFLINE))
def test_offline_iteration_matches_jax(offline, name):
    """The epoch's mean losses (and MARWIL's running RMS, CRR's accepted
    fraction), params, targets and Adam state within the few-Adam-steps
    bound; CRR's binary weights are taken where |A| > 1e-4 (an advantage
    that close to 0 could flip between the two libraries)."""
    jalgo, talgo, jres, tres = offline(name)
    for k, v in jres.items():
        if k == "accepted_fraction" and name == "CRR-binary":
            assert tres[k] == pytest.approx(v, abs=1 / 32)
        elif isinstance(v, float):
            _close(tres[k], v, UPD_RTOL, UPD_ATOL)
    jstate = jalgo.get_state()
    _tree_close(talgo.params, jstate["params"], UPD_RTOL, UPD_ATOL)
    if "target_params" in jstate:
        _tree_close(talgo.target_params, jstate["target_params"],
                    UPD_RTOL, UPD_ATOL)
    if "target_q" in jstate:
        _tree_close(talgo.target_q, jstate["target_q"], UPD_RTOL, UPD_ATOL)
    _adam_close(talgo.opt_state, jalgo.opt_state)
    if name == "CRR-binary":
        data = {k: v[:32] for k, v in talgo._data.items()}
        _, adv = talgo.weights(talgo.params, data)
        assert float(adv.abs().min()) > 1e-4


def test_offline_action_fns_match_jax(offline):
    """CQL and CRR act greedily; BC and MARWIL sample, as the JAX
    ``action_fn`` does for an MLPPolicy (Gumbel noise from each obs's
    key)."""
    obs = np.random.default_rng(11).normal(size=(6, 4)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(12), 6)
    for name in ("BC", "MARWIL", "CQL", "CRR-exp"):
        jalgo, talgo, _, _ = offline(name)
        jact = jalgo.action_fn()
        want = [int(jact(jnp.asarray(o), k)) for o, k in zip(obs, keys)]
        got = talgo.action_fn()(_t(obs), noise=_gumbel(keys, 2)) \
            if name in ("BC", "MARWIL") else talgo.action_fn()(_t(obs))
        assert got.tolist() == want, name


@pytest.mark.parametrize("weighted", [True, False])
def test_importance_sampling_estimate_matches_jax(dataset, weighted):
    """(W)IS over the dataset's first 90 rows cut into episodes of 13
    (the expert's own episodes outlast 90 steps), the target policy a JAX
    init, random behaviour log-probs: the float64
    host products within rtol 1e-5 of JAX's."""
    want_ds, _ = dataset
    episodes = {k: v[:90] for k, v in want_ds.items()}
    episodes["done"] = np.arange(90) % 13 == 12   # 6 episodes and a tail
    jpol = jrl.MLPPolicy(4, 2, discrete=True, hidden=(8,))
    jp = jax.jit(jpol.init)(jax.random.PRNGKey(13))
    tpol = trl.MLPPolicy(4, 2, discrete=True, hidden=(8,), device="cpu")
    blogp = np.log(np.random.default_rng(14).uniform(0.3, 0.7, 90))
    want = joff.importance_sampling_estimate(jpol, jp, episodes, blogp,
                                             gamma=0.9, weighted=weighted)
    got = trl.importance_sampling_estimate(
        tpol, policy_params_from_numpy(tpol, _np(jp)), episodes, blogp,
        gamma=0.9, weighted=weighted)
    assert got["num_episodes"] == want["num_episodes"] > 1
    for k in ("v_target", "v_behavior", "mean_ratio"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


# -- bandits ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bandit_run(cls_name):
    """64 steps of LinUCB / LinTS on the JAX bandit's weights (d 8, K 4)
    from the JAX key chain: per step ``key, ck, sk, rk`` (the context's
    normal, TS's [K, d] normal, the reward's normal)."""
    cfg = dict(steps_per_iter=64, seed=0)
    jalgo = getattr(jrl, cls_name)(env=jrl.LinearContextBandit,
                                   **cfg).build()
    weights = np.asarray(jalgo.env.weights)
    talgo = getattr(trl, cls_name)(
        env=lambda device: trl.LinearContextBandit(weights=weights,
                                                   device=device),
        device="cpu", **cfg).build()
    key, keys = jalgo.key, []
    for _ in range(64):
        key, *sub = jax.random.split(key, 4)
        keys.append(sub)
    ck, sk, rk = (jnp.stack(k) for k in zip(*keys))
    draws = {"context": _t(jax.vmap(lambda k: jax.random.normal(
        k, (8,)))(ck)), "noise": _t(jax.vmap(jax.random.normal)(rk))}
    if cls_name == "LinTSConfig":
        draws["z"] = _t(jax.vmap(lambda k: jax.random.normal(
            k, (4, 8)))(sk))
    return jalgo, talgo, jalgo.train(), _train(talgo, draws)


@pytest.mark.parametrize("cls_name", ["LinUCBConfig", "LinTSConfig"])
def test_bandit_iteration_matches_jax(cls_name):
    """The posteriors after 64 sequential steps (so every arm choice was
    the same: a different arm would move another A_k by a rank-1 term)
    within rtol 1e-4, the mean reward and regret."""
    jalgo, talgo, jres, tres = _bandit_run(cls_name)
    _close(talgo.A, jalgo.A, BANDIT_RTOL, ATOL)
    _close(talgo.b, jalgo.b, BANDIT_RTOL, ATOL)
    for k in ("episode_reward_mean", "mean_regret"):
        _close(tres[k], jres[k], BANDIT_RTOL, ATOL)
    counts = np.diagonal(np.asarray(jalgo.A), axis1=1, axis2=2).sum(1) - 8
    assert (np.round(counts) > 0).sum() >= 2     # several arms were tried


# -- refusals, checkpoints, configs -------------------------------------------

def _ds(module, rows=10):
    return dict(dataset={"obs": np.zeros((rows, 4), np.float32),
                         "action": np.zeros(rows, np.int32),
                         "reward": np.zeros(rows, np.float32),
                         "next_obs": np.zeros((rows, 4), np.float32),
                         "done": np.zeros(rows, bool)})


def _spread(m, cls):
    if m is trl:
        return lambda device: getattr(m, cls)(3, device=device)
    return lambda: getattr(m, cls)(3)


REFUSALS = [
    (lambda m: m.QMIXConfig(env=_spread(m, "SpreadLineContinuous"),
                            **dev(m)), "discrete actions only"),
    (lambda m: m.MADDPGConfig(env=_spread(m, "SpreadLine"), **dev(m)),
     "deterministic-gradient"),
    (lambda m: m.QMIXConfig(**dev(m)), "env required"),
    (lambda m: m.MADDPGConfig(**dev(m)), "env required"),
    (lambda m: m.IndependentPPOConfig(**dev(m)), "env required"),
    (lambda m: m.ImpalaConfig(**dev(m)), "env required"),
    (lambda m: m.LinTSConfig(**dev(m)), "env required"),
    (lambda m: m.BCConfig(env=m.CartPole, **dev(m)), "required"),
    (lambda m: m.MARWILConfig(env=m.CartPole, **_ds(m), **dev(m)),
     "10 rows < batch_size=256"),
    (lambda m: m.CRRConfig(env=m.CartPole, **_ds(m), **dev(m)),
     "10 rows < batch_size=256"),
    (lambda m: m.CQLConfig(env=m.Pendulum, **_ds(m), **dev(m)),
     "discrete-action"),
    (lambda m: m.CRRConfig(env=m.Pendulum, **_ds(m, 256), **dev(m)),
     "discrete-action"),
    (lambda m: m.CRRConfig(env=m.CartPole, weight_fn="soft", **_ds(m, 256),
                           **dev(m)), "weight_fn='soft'"),
] + [(lambda m, c=c: getattr(m, c)(env=m.CartPole, epochs_per_iter=0,
                                   **_ds(m, 256), **dev(m)),
      "epochs_per_iter") for c in ("BCConfig", "MARWILConfig", "CQLConfig",
                                   "CRRConfig")]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_refusals_match_jax(case):
    make, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match) as want:
        make(jrl).build()
    with pytest.raises(ValueError, match=match) as got:
        make(trl).build()
    assert str(got.value) == str(want.value)


def _greedy_pairs(name, runs):
    """(the JAX algorithm, a port algorithm restored from its
    ``get_state()``, a function of an algorithm and its package giving
    greedy actions on fixed inputs); ``runs`` the module's trained
    pairs."""
    rng = np.random.default_rng(15)
    jalgo, talgo = runs[name]
    fresh = dataclasses.replace(talgo.config).build()
    fresh.set_state(jalgo.get_state())
    if name in ("Impala", "BC", "MARWIL"):
        obs = rng.normal(size=(6, 4)).astype(np.float32)
        key = "pi" if name == "MARWIL" else None

        def act(a, m):
            p = a.params[key] if key else a.params
            x = jnp.asarray(obs) if m is jrl else _t(obs)
            pi = a.policy.forward(p, x)[0]
            return np.asarray(pi.argmax(-1) if m is trl
                              else jnp.argmax(pi, -1))
    elif name == "IndependentPPO":
        obs = rng.normal(size=(3, 5, 3)).astype(np.float32)

        def act(a, m):
            if m is jrl:
                pi = jax.vmap(a.policy.forward)(a.params, jnp.asarray(obs))
                return np.asarray(jnp.argmax(pi[0], -1))
            view = trl.multi_agent.agent_view(a.params)
            return a.policy.forward(view, _t(obs))[0].argmax(-1).numpy()
    elif name == "QMIX":
        obs = rng.normal(size=(5, 3, 3)).astype(np.float32)

        def act(a, m):
            if m is jrl:
                return np.asarray(jnp.argmax(jrl.policy.mlp_apply(
                    a.params["q"], jnp.asarray(obs)), -1))
            return trl.mlp_apply(a.params["q"], _t(obs)).argmax(-1).numpy()
    elif name == "MADDPG":
        obs = rng.normal(size=(5, 3, 3)).astype(np.float32)

        def act(a, m):
            if m is jrl:
                return np.round(np.asarray(a._act(a.params["actor"],
                                                  jnp.asarray(obs))), 5)
            return np.round(a.act(a.params["actor"], _t(obs)).numpy(), 5)
    elif name == "LinUCB":
        ctx = rng.normal(size=(6, 8)).astype(np.float32)

        def act(a, m):
            if m is jrl:
                return [int(jrl.bandit._select_ucb(a.A, a.b, jnp.asarray(x),
                                                   1.0, None)) for x in ctx]
            return [int(trl.bandit._select_ucb(a.A, a.b, _t(x), 1.0, None))
                    for x in ctx]
    else:                                         # CQL, CRR: action_fn
        obs = rng.normal(size=(6, 4)).astype(np.float32)

        def act(a, m):
            if m is jrl:
                f = a.action_fn()
                return [int(f(jnp.asarray(o), None)) for o in obs]
            return a.action_fn()(_t(obs)).tolist()
    return jalgo, fresh, act


@pytest.mark.parametrize("name", ["Impala", "IndependentPPO", "QMIX",
                                  "MADDPG", "BC", "MARWIL", "CQL", "CRR-exp",
                                  "LinUCB"])
def test_set_state_takes_the_jax_checkpoint_and_serves_its_actions(
        name, qmix_run, maddpg_run, offline):
    """A fresh port algorithm restored from the trained JAX algorithm's
    ``get_state()`` serves the same greedy actions (MADDPG: the same
    actions to 1e-5) and keeps its counters."""
    runs = {"Impala": _impala_run("ImpalaConfig")[:2],
            "IndependentPPO": _ippo_run(False)[:2], "QMIX": qmix_run[:2],
            "MADDPG": maddpg_run[:2],
            "LinUCB": _bandit_run("LinUCBConfig")[:2]}
    if name not in runs:
        runs[name] = offline(name)[:2]
    jalgo, fresh, act = _greedy_pairs(name, runs)
    assert np.array_equal(np.asarray(act(fresh, trl)),
                          np.asarray(act(jalgo, jrl)))
    assert fresh.iteration == jalgo.iteration
    if name in ("QMIX", "MADDPG"):
        assert fresh._total_env_steps == jalgo._total_env_steps == 48


def test_converter_takes_stacked_and_mixer_trees_and_refuses_a_mismatch(
        qmix_run, maddpg_run):
    """The JAX package's stacked (MADDPG, IndependentPPO) and mixer (QMIX)
    trees convert as they are; a tree stacked for another agent count or
    a mixer of another embedding is refused, naming the path."""
    for (jalgo, talgo, *_) in (qmix_run, maddpg_run, _ippo_run(False)):
        got = policy_params_from_numpy(talgo, _np(jalgo.params))
        _tree_close(got, _np(jalgo.params), 0, 0)
    four = trl.IndependentPPOConfig(
        env=lambda device: trl.SpreadLine(4, device=device), hidden=(8,),
        device="cpu").build()
    with pytest.raises(ValueError, match="torso/0/w: shape"):
        policy_params_from_numpy(_ippo_run(False)[1],
                                 four.get_state()["params"])
    wide = dict(QMIX_KW, mixing_embed=5)
    other = trl.QMIXConfig(env=lambda device: trl.SpreadLine(3,
                                                            device=device),
                           device="cpu", **wide).build()
    with pytest.raises(ValueError, match="mix/hw1/0/w: shape"):
        policy_params_from_numpy(other, _np(qmix_run[0].params))


CONFIGS = ("ImpalaConfig", "APPOConfig", "IndependentPPOConfig",
           "QMIXConfig", "MADDPGConfig", "BCConfig", "MARWILConfig",
           "CQLConfig", "CRRConfig", "LinUCBConfig", "LinTSConfig")


def test_configs_mirror_the_jax_fields_and_defaults():
    for name in CONFIGS:
        want = {f.name: f.default for f in dataclasses.fields(
            getattr(jrl, name))}
        got = {f.name: f.default for f in dataclasses.fields(
            getattr(trl, name))}
        assert set(got) - set(want) == {"device"}, name
        for k, v in want.items():
            assert got[k] == v, (name, k)


def test_entry_points_raise_without_cuda_and_device(dataset):
    with unittest.mock.patch.object(torch.cuda, "is_available",
                                    lambda: False):
        for cfg in (trl.ImpalaConfig(env=trl.CartPole),
                    trl.IndependentPPOConfig(env=trl.SpreadLine),
                    trl.QMIXConfig(env=trl.SpreadLine),
                    trl.MADDPGConfig(env=trl.SpreadLineContinuous),
                    trl.BCConfig(env=trl.CartPole, dataset=dataset[0]),
                    trl.LinTSConfig(env=trl.LinearContextBandit)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cfg.build()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trl.collect_dataset(trl.CartPole, _port_expert, n_steps=8)
