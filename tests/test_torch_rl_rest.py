"""The port's ES / ARS, MAML, Dreamer, Decision Transformer, AlphaZero and
SlateQ against the JAX package's on the CPU.

``jax.random`` streams cannot be reproduced, so each comparison gives both
packages the same draws: the test follows the JAX code's split chain from
its key and turns each key into the values it would draw (the envs' reset
draws, sampling noise, Gumbel noise of ``jax.random.categorical``, Dirichlet
root noise, replay indices, permutations), and the port takes those values
as arguments.  Weights are the JAX init carried over with
`convert.policy_params_from_numpy`.  Where the JAX package keeps a function
inside a closure (Dreamer's posterior, model loss and λ-returns, DT's loss,
the MCTS tree), the test reaches it through the closure's cells or by
recording the value the JAX code computes; nothing of the JAX package is
changed.  Each JAX algorithm is built and run once (``lru_cache``d
runners), since its jitted iteration compiles on first use.

Tolerances (fp32), each stated where it is used: forwards, env steps,
returns, the MCTS values and the meta-gradient within rtol 1e-5 / atol
1e-6 (summation order only); a few Adam steps within rtol 1e-4 / atol
1e-6; integers (actions, picks, visit counts, children, dones, returns of
CartPole episodes) exactly.
"""

import functools
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import rl as jrl
from ray_tpu.rl import alpha_zero as jaz
from ray_tpu.rl import dreamer as jdreamer
from ray_tpu.rl import dt as jdt
from ray_tpu.rl import es as jes
from ray_tpu.rl import maml as jmaml
from ray_tpu.rl import slateq as jslateq
from ray_tpu_torch import rl as trl
from ray_tpu_torch.convert import policy_params_from_numpy
from ray_tpu_torch.rl import dt as tdt
from ray_tpu_torch.rl.learner import value_and_grad
from ray_tpu_torch.rl.policy import tree_map

RTOL, ATOL = 1e-5, 1e-6          # forwards, env steps, returns, gradients
UPD_RTOL, UPD_ATOL = 1e-4, 1e-6  # a few Adam steps


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


def _cells(fn):
    """A closure's free variables by name."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _train(algo, draws, **kw):
    """`Algorithm.train` with the iteration's draws."""
    algo.iteration += 1
    res = algo.training_step(draws=draws, **kw)
    algo._total_env_steps += res["env_steps_this_iter"]
    return res


def _cartpole_one(key):
    return jax.random.uniform(key, (4,), minval=-0.05, maxval=0.05)


@functools.lru_cache(maxsize=None)
def _jitted(what, *args):
    """One jitted JAX draw function per kind and shape, compiled once."""
    if what == "es_eval":                 # make_eval_fn's draws
        n, horizon = args

        def f(key):
            reset = jax.vmap(_cartpole_one)(jax.random.split(key, n))

            def step(key, _):
                key, skey = jax.random.split(key)
                return key, jax.vmap(_cartpole_one)(
                    jax.random.split(skey, n))

            _, steps = jax.lax.scan(step, key, None, length=horizon)
            return reset, steps
        return jax.jit(f)
    if what == "maml_rollout":            # one task's rollout's draws
        E, T = args

        def rollout(key):
            key, ekey = jax.random.split(key)
            reset = jax.vmap(jax.random.normal)(jax.random.split(ekey, E))

            def step(key, _):
                key, akey, skey = jax.random.split(key, 3)
                noise = jax.vmap(lambda k: jax.random.normal(k, (1,)))(
                    jax.random.split(akey, E))
                steps = jax.vmap(lambda k: jax.random.normal(
                    jax.random.split(k)[0]))(jax.random.split(skey, E))
                return key, (noise, steps)

            _, (noise, steps) = jax.lax.scan(step, key, None, length=T)
            return {"reset": reset, "noise": noise, "steps": steps}
        return jax.jit(rollout)
    if what == "maml":                    # one meta step's draws
        M, E, T, inner = args
        rollout = _jitted("maml_rollout", E, T)

        def per_task(key):
            key, akey, okey = jax.random.split(key, 3)
            inner_draws = []
            for _ in range(inner):
                akey, rkey = jax.random.split(akey)
                inner_draws.append(rollout(rkey))
            return inner_draws, rollout(okey)

        def f(key):
            key, tkey, rkey = jax.random.split(key, 3)
            tasks = jnp.where(jax.random.bernoulli(tkey, shape=(M, 1)),
                              1.0, -1.0)
            inner_draws, post = jax.vmap(per_task)(
                jax.random.split(rkey, M))
            return tasks, inner_draws, post
        return jax.jit(f)
    raise ValueError(what)


# -- ES / ARS -----------------------------------------------------------------

ES_KW = dict(num_perturbations=3, episodes_per_eval=2, horizon=25,
             hidden=(8,), seed=1)


def _es_eval_draws(key, n, horizon):
    reset, steps = _jitted("es_eval", n, horizon)(key)
    return {"reset": {"obs": _t(reset)}, "steps": {"obs": _t(steps)}}


def _es_iteration_draws(algo):
    """The draws of the port's next iteration: per pair from the key the
    JAX package makes of its seed sequence, then the final evaluation's
    from ``PRNGKey(iteration seed)``."""
    cfg = algo.config
    it = algo._iter_seed + 1
    pairs = [_es_eval_draws(jax.random.PRNGKey(int(
        np.random.SeedSequence([cfg.seed, it, i]).generate_state(1)[0])),
        cfg.episodes_per_eval, cfg.horizon)
        for i in range(cfg.num_perturbations)]
    final = _es_eval_draws(jax.random.PRNGKey(it), cfg.episodes_per_eval,
                           cfg.horizon)
    return {"pairs": pairs, "final": final}


@functools.lru_cache(maxsize=None)
def _es_pair(cls_name):
    kw = dict(ES_KW, top_k=2) if cls_name == "ARSConfig" else ES_KW
    jalgo = getattr(jes, cls_name)(env=jrl.CartPole, **kw).build()
    talgo = getattr(trl, cls_name)(env=trl.CartPole, device="cpu",
                                   **kw).build()
    talgo.flat = policy_params_from_numpy(talgo, np.asarray(jalgo.flat))
    return jalgo, talgo


def test_es_batched_returns_equal_one_evaluation_per_pair():
    """All 2n perturbed policies evaluated as one batch give each pair's
    returns of two evaluations of its own (bitwise: CartPole returns are
    step counts)."""
    _, talgo = _es_pair("ESConfig")
    draws = _es_iteration_draws(talgo)["pairs"]
    saved = talgo._iter_seed
    seeds, eps, r_pos, r_neg = talgo._evaluate_directions(draws)
    talgo._iter_seed = saved
    sigma = talgo.config.sigma
    for i, d in enumerate(draws):
        e = torch.from_numpy(eps[i])
        for sign, want in ((1.0, r_pos[i]), (-1.0, r_neg[i])):
            got = talgo.evaluate_flat((talgo.flat + sign * sigma * e)[None],
                                      [d])
            assert float(got[0]) == want
    assert len(set(np.concatenate([r_pos, r_neg]))) > 1   # not degenerate


@pytest.mark.parametrize("cls_name", ["ESConfig", "ARSConfig"])
def test_es_iteration_matches_jax(cls_name):
    """The returns of every pair equal (CartPole step counts), then one
    update from equal returns: the numpy noise and ranks are the same in
    both packages, the flat vectors within rtol 1e-5 (one fp32 axpy)."""
    jalgo, talgo = _es_pair(cls_name)
    draws = _es_iteration_draws(talgo)
    saved = talgo._iter_seed
    _, _, t_pos, t_neg = talgo._evaluate_directions(draws["pairs"])
    _, j_pos, j_neg = jalgo._evaluate_directions()
    _equal(t_pos, j_pos)
    _equal(t_neg, j_neg)
    talgo._iter_seed = jalgo._iter_seed = saved
    jres = jalgo.train()
    tres = _train(talgo, draws)
    _close(talgo.flat, jalgo.flat)
    assert tres["episode_reward_mean"] == jres["episode_reward_mean"]
    if cls_name == "ARSConfig":
        assert tres["return_std"] == jres["return_std"]
    # a JAX checkpoint resumes the noise stream where it left off
    state = jalgo.get_state()
    fresh = getattr(trl, cls_name)(env=trl.CartPole, device="cpu",
                                   **ES_KW).build()
    fresh.set_state(state)
    _close(fresh.flat, state["flat"], 0, 0)
    assert fresh._iter_seed == jalgo._iter_seed


def test_es_refuses_remote_workers():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        trl.ESConfig(env=trl.CartPole, num_workers=2, device="cpu").build()


# -- MAML ---------------------------------------------------------------------

MAML_KW = dict(meta_batch_size=3, num_envs=2, rollout_length=5,
               hidden=(8,), seed=0)


def _maml_draws(key, cfg):
    tasks, inner, post = _jitted(
        "maml", cfg.meta_batch_size, cfg.num_envs, cfg.rollout_length,
        cfg.inner_steps)(key)

    def rollout(d):   # [M, T, E, ...] -> the port's [T, M, E, ...]
        return {"reset": {"x": _t(d["reset"])},
                "noise": _t(np.swapaxes(d["noise"], 0, 1)),
                "steps": {"x": _t(np.swapaxes(d["steps"], 0, 1))}}

    return {"tasks": _t(tasks), "inner": [rollout(d) for d in inner],
            "post": rollout(post)}


@functools.lru_cache(maxsize=None)
def _maml_run():
    """One JAX meta step with the clip lifted (max_grad_norm 1e9), so its
    Adam's first moment is (1 - b1) x the meta-gradient."""
    kw = dict(MAML_KW, max_grad_norm=1e9)
    jalgo = jmaml.MAMLConfig(**kw).build()
    talgo = trl.MAMLConfig(device="cpu", **kw).build()
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    draws = _maml_draws(jalgo.key, talgo.config)
    jres = jalgo.train()
    adam = jalgo.opt_state[1][0]
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                    adam.mu)
    return jalgo, talgo, draws, jres, jgrads


def test_maml_meta_gradient_matches_jax():
    """The meta-loss, the pre / post-adaptation rewards and the
    second-order meta-gradient, which runs through the inner and post
    rollouts' actions, rewards and returns (rtol 1e-5 / atol 1e-6).  A
    port whose rollouts were detached (the trajectory held constant in
    the outer gradient) is refused by the same check."""
    _, talgo, draws, jres, jgrads = _maml_run()
    loss, pre, post, grads = talgo.meta_gradient(draws)
    _close(loss, jres["meta_loss"])
    _close(pre, jres["pre_adapt_reward_mean"])
    _close(post, jres["post_adapt_reward_mean"])
    want = jax.tree_util.tree_leaves(jgrads)
    for g, w in zip(grads, want):
        _close(g, w)
    detached = talgo._rollout

    def rollout(*args):
        return tree_map(torch.Tensor.detach, detached(*args))

    with unittest.mock.patch.object(talgo, "_rollout", rollout):
        _, _, _, bad = talgo.meta_gradient(draws)
    with pytest.raises(AssertionError):
        for g, w in zip(bad, want):
            _close(g, w)


def test_maml_step_and_inner_adaptation_match_jax():
    """The meta step's clipped-Adam update, then `adapt_to_task` (the
    inner step alone) on JAX's next key: adapted params within rtol 1e-5;
    a JAX checkpoint loads."""
    jalgo, talgo, draws, _, _ = _maml_run()
    fresh = trl.MAMLConfig(device="cpu", **dict(MAML_KW, max_grad_norm=1e9)
                           ).build()
    fresh.params = tree_map(torch.clone, talgo.params)
    _train(fresh, draws)
    _tree_close(fresh.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    fresh.set_state(jalgo.get_state())
    # the adaptation rollout's draws, as one task's rollout, from the key
    # adapt_to_task splits off, and its inner step from the JAX package's
    # own rollout and loss, jitted (adapt_to_task runs them op by op)
    _, rkey = jax.random.split(jalgo.key)
    d = _jitted("maml_rollout", 2, 5)(rkey)
    tdraws = [{"reset": {"x": _t(d["reset"])[None]},
               "noise": _t(d["noise"])[:, None],
               "steps": {"x": _t(d["steps"])[:, None]}}]
    rollout, pg_loss = jalgo._task_machinery()
    lr = jalgo.config.inner_lr

    @jax.jit
    def adapt(p, task, key):
        g = jax.grad(pg_loss)(p, rollout(p, task, key))
        return jax.tree_util.tree_map(lambda w, gi: w - lr * gi, p, g)

    want = adapt(jalgo.params, jnp.asarray([1.0]), rkey)
    got = fresh.adapt_to_task([1.0], tdraws)
    _tree_close(got, _np(want))


# -- Dreamer ------------------------------------------------------------------

DREAMER_KW = dict(num_envs=3, seq_len=4, buffer_capacity=16, batch_size=2,
                  model_updates=2, ac_updates=2, horizon=3, deter_size=8,
                  stoch_size=4, hidden=8, learn_start=6, seed=0)


def _dreamer_jax_draws(key, cfg, n_act, size):
    """One iteration's draws and the key after it, along the JAX split
    chain (the updates consume keys only past the gate)."""
    E, S, T, B = cfg.num_envs, cfg.stoch_size, cfg.seq_len, cfg.batch_size
    collect = []
    for _ in range(T):
        key, zkey, akey, skey = jax.random.split(key, 4)
        collect.append({
            "z": _t(jax.random.normal(zkey, (E, S))),
            "gumbel": _t(jax.random.gumbel(akey, (E, n_act))),
            "reset": {"obs": _t(jax.vmap(_cartpole_one)(
                jax.random.split(skey, E)))}})
    size = min(size + E, cfg.buffer_capacity)
    if size < cfg.learn_start:
        return {"collect": collect, "learn": None}, key
    model = []
    for _ in range(cfg.model_updates):
        key, skey, lkey = jax.random.split(key, 3)
        _, sskey = jax.random.split(skey)
        model.append({"idx": _t(jax.random.randint(sskey, (B,), 0, size)
                                ).long(),
                      "z": _dreamer_observe_noise(lkey, B, T, S)})
    ac = []
    N = B * T
    for _ in range(cfg.ac_updates):
        key, ikey = jax.random.split(key)
        g, z = [], []
        for _ in range(cfg.horizon):
            ikey, akey, zkey = jax.random.split(ikey, 3)
            g.append(jax.random.gumbel(akey, (N, n_act)))
            z.append(jax.random.normal(zkey, (N, S)))
        ac.append({"gumbel": _t(np.stack(g)), "z": _t(np.stack(z))})
    return {"collect": collect, "learn": {"model": model, "ac": ac}}, key


def _dreamer_observe_noise(lkey, B, T, S):
    """The posterior noise [B, T, S] of the JAX model loss's key."""
    def per_seq(key):
        def step(key, _):
            key, zkey = jax.random.split(key)
            return key, jax.random.normal(zkey, (S,))
        return jax.lax.scan(step, key, None, length=T)[1]
    return _t(jax.vmap(per_seq)(jax.random.split(lkey, B)))


def _dreamer_port(jalgo):
    talgo = trl.DreamerConfig(env=trl.CartPole, device="cpu",
                              **DREAMER_KW).build()
    conv = policy_params_from_numpy(talgo, {
        "model": _np(jalgo.params), "actor": _np(jalgo.actor_params),
        "critic": _np(jalgo.critic_params)})
    talgo.params, talgo.actor_params = conv["model"], conv["actor"]
    talgo.critic_params = conv["critic"]
    talgo.critic_target = tree_map(torch.clone, conv["critic"])
    for name in ("model", "actor", "critic"):
        opt = getattr(talgo, f"{name}_opt")
        tree = talgo.params if name == "model" else \
            getattr(talgo, f"{name}_params")
        setattr(talgo, f"{name}_opt_state", opt.init(tree))
    talgo.env_states = {k: _t(v) for k, v in _np(jalgo.env_states).items()}
    talgo.obs = _t(jalgo.obs)
    return talgo


@functools.lru_cache(maxsize=None)
def _dreamer_run():
    """Two iterations of each side: the first below the gate (3 sequences
    < learn_start 6), the second past it."""
    jalgo = jdreamer.DreamerConfig(env=jrl.CartPole, **DREAMER_KW).build()
    talgo = _dreamer_port(jalgo)
    cells = _cells(jalgo._make_train_iter())
    cells["init"] = {"model": _np(jalgo.params),
                     "actor": _np(jalgo.actor_params),
                     "critic": _np(jalgo.critic_params)}
    out = []
    key = jalgo.key
    for _ in range(2):
        draws, key = _dreamer_jax_draws(key, talgo.config, 2,
                                        talgo.buffer["size"])
        out.append((jalgo.train(), _train(talgo, draws)))
    return jalgo, talgo, cells, out


def test_dreamer_observe_and_model_loss_match_jax():
    """The RSSM posterior over replayed sequences (h, z, the balanced KL,
    rtol 1e-5), the model loss and its gradient (rtol 1e-5 / atol 1e-6)
    from the JAX init, on sequences with a done inside."""
    jalgo, talgo, cells, _ = _dreamer_run()
    jparams = cells["init"]["model"]
    params = policy_params_from_numpy(talgo, cells["init"])["model"]
    rng = np.random.default_rng(0)
    B, T = 2, 4
    batch = {"obs": rng.normal(size=(B, T, 4)).astype(np.float32),
             "action": rng.integers(0, 2, (B, T)).astype(np.int32),
             "reward": np.ones((B, T), np.float32),
             "done": np.array([[0, 1, 0, 0], [0, 0, 0, 1]], np.float32)}
    key = jax.random.PRNGKey(7)
    z = _dreamer_observe_noise(key, B, T, 4)
    model_loss = cells["model_loss"]
    observe_seq = _cells(model_loss)["observe_seq"]
    jh, jz, jkl = jax.jit(jax.vmap(observe_seq, in_axes=(None, 0, 0, 0, 0)))(
        jparams, *(jnp.asarray(batch[k]) for k in
                        ("obs", "action", "done")),
        jax.random.split(key, B))
    tb = {k: _t(v) for k, v in batch.items()}
    tb["action"] = tb["action"].long()
    h, zs, kl = talgo.observe(params, tb["obs"], tb["action"], tb["done"], z)
    for got, want in ((h, jh), (zs, jz), (kl, jkl)):
        _close(got, want)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(model_loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    loss, _, grads = value_and_grad(talgo.model_loss, params, tb, z)
    _close(loss, jloss)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        _close(g, w)


def test_dreamer_lambda_returns_match_jax():
    jalgo, talgo, cells, _ = _dreamer_run()
    lambda_returns = _cells(cells["actor_loss"])["lambda_returns"]
    rng = np.random.default_rng(1)
    H, N = 5, 6
    r = rng.normal(size=(H, N)).astype(np.float32)
    c = rng.random((H, N)).astype(np.float32)
    v = rng.normal(size=(H + 1, N)).astype(np.float32)
    want = lambda_returns(*(jnp.asarray(x) for x in (r, c, v)))
    _close(talgo.lambda_returns(_t(r), _t(c), _t(v)), want)


def test_dreamer_iterations_each_side_of_the_gate_match_jax():
    """Below the gate: the collected sequences and the buffer, losses 0
    and no update.  Past it: the model, actor and critic losses, the
    imagined return and the params of all three nets and the slow target
    after 2 + 2 clipped-Adam steps (rtol 1e-4 / atol 1e-6)."""
    jalgo, talgo, _, ((j0, t0), (j1, t1)) = _dreamer_run()
    for k in ("model_loss", "actor_loss", "critic_loss", "imagined_return"):
        assert t0[k] == 0.0 and j0[k] == 0.0
        _close(t1[k], j1[k], UPD_RTOL, UPD_ATOL)
    assert t1["buffer_size"] == j1["buffer_size"] == 6
    data = _np(jalgo.buffer["data"])
    for k in ("action", "done"):
        _equal(talgo.buffer["data"][k], data[k])
    _close(talgo.buffer["data"]["obs"], data["obs"])
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.actor_params, _np(jalgo.actor_params), UPD_RTOL,
                UPD_ATOL)
    _tree_close(talgo.critic_params, _np(jalgo.critic_params), UPD_RTOL,
                UPD_ATOL)
    _tree_close(talgo.critic_target, _np(jalgo.critic_target), UPD_RTOL,
                UPD_ATOL)
    _close(talgo.h, jalgo.h, UPD_RTOL, UPD_ATOL)
    fresh = _dreamer_port(jalgo)
    fresh.set_state(jalgo.get_state())
    _tree_close(fresh.critic_target, _np(jalgo.critic_target), 0, 0)


# -- Decision Transformer -----------------------------------------------------

DT_KW = dict(context_len=4, d_model=16, n_layers=2, n_heads=2, d_ff=32,
             batch_size=8, steps_per_iter=2, seed=0)


@functools.lru_cache(maxsize=None)
def _dt_dataset():
    """A short CartPole dataset with done marks and env_id junctions."""
    rng = np.random.default_rng(0)
    n = 90
    done = np.zeros(n, np.float32)
    done[[11, 30, 52, 70]] = 1.0
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 2, n).astype(np.int64),
            "reward": np.ones(n, np.float32), "done": done,
            "env_id": np.repeat(np.arange(3), 30)}


class _JaxShortCartPole(jrl.CartPole):
    max_episode_steps = 60


class _ShortCartPole(trl.CartPole):
    max_episode_steps = 60


@functools.lru_cache(maxsize=None)
def _dt_pair():
    """DT on CartPole with its episodes cut to 60 steps (the evaluation
    runs every one of them)."""
    ds = _dt_dataset()
    jalgo = jdt.DTConfig(env=_JaxShortCartPole, dataset=ds, **DT_KW).build()
    talgo = trl.DTConfig(env=_ShortCartPole, dataset=ds, device="cpu",
                         **DT_KW).build()
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    return jalgo, talgo


def test_dt_returns_to_go_and_episodes_match_jax():
    rng = np.random.default_rng(2)
    r = rng.normal(size=9).astype(np.float32)
    for gamma in (1.0, 0.9):
        _close(tdt._returns_to_go(r, gamma), jdt._returns_to_go(r, gamma))
    ds = _dt_dataset()
    for cols in (ds, {k: v for k, v in ds.items() if k != "env_id"}):
        got, want = tdt.episodes_from_columns(cols), \
            jdt.episodes_from_columns(cols)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                _equal(g[k], w[k])


def test_dt_windows_logits_and_loss_match_jax():
    """The host windows exactly (rtg / scale within rtol 1e-5), the
    interleaved logits and the masked cross-entropy with its gradient
    within rtol 1e-5 / atol 1e-6 (head dim 8: reference attention on both
    sides)."""
    jalgo, talgo = _dt_pair()
    jw = _np(jalgo._windows)
    for k in ("obs", "action", "mask"):
        _equal(talgo._windows[k], jw[k])
    _close(talgo._windows["rtg"], jw["rtg"])
    batch = {k: v[:6] for k, v in jw.items()}
    tb = {k: v[:6] for k, v in talgo._windows.items()}
    want = jax.jit(jalgo._logits)(jalgo.params, batch["rtg"], batch["obs"],
                                  batch["action"])
    got = talgo._logits(talgo.params, tb["rtg"], tb["obs"], tb["action"])
    _close(got, want)
    loss_fn = _cells(jalgo._make_update())["loss_fn"]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jalgo.params, batch)
    loss, _, grads = value_and_grad(talgo.loss, talgo.params, tb)
    _close(loss, jloss)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        _close(g, w)


def test_dt_adamw_steps_and_eval_return_match_jax():
    """``steps_per_iter`` (2) optax-AdamW steps on JAX's minibatches: the
    mean loss and every leaf (biases and norms decayed too) within rtol
    1e-4 / atol 1e-6; then one 60-step evaluation episode from JAX's key
    returns the same CartPole return; a JAX checkpoint loads."""
    jalgo, talgo = _dt_pair()
    W = talgo._windows["obs"].shape[0]
    key, draws = jalgo.key, []
    for _ in range(talgo.config.steps_per_iter):
        key, bkey = jax.random.split(key)
        draws.append(_t(jax.random.randint(bkey, (8,), 0, W)).long())
    jres = jalgo.train()
    tres = _train(talgo, draws)
    _close(tres["action_ce_loss"], jres["action_ce_loss"], UPD_RTOL,
           UPD_ATOL)
    # The key projection's bias adds q·b_k to every score of a row, which
    # the softmax cancels: its true gradient is 0 and both packages compute
    # rounding noise (about 1e-10), which Adam scales to a step of about lr
    # in either direction.  That third of the qkv bias is held to the Adam
    # steps' bound (steps x lr); everything else to rtol 1e-4 / atol 1e-6.
    want = _np(jalgo.params)
    d, lr = talgo.config.d_model, talgo.config.lr
    got_b = talgo.params["trunk"]["layers"]["qkv"]["b"]
    want_b = want["trunk"]["layers"]["qkv"].pop("b")
    _close(got_b[:, d:2 * d], want_b[:, d:2 * d], 0,
           talgo.config.steps_per_iter * lr * 1.001)
    for part in (slice(0, d), slice(2 * d, 3 * d)):
        _close(got_b[:, part], want_b[:, part], UPD_RTOL, UPD_ATOL)
    got = tree_map(lambda x: x, talgo.params)
    got["trunk"]["layers"]["qkv"] = {"w": got["trunk"]["layers"]["qkv"]["w"]}
    _tree_close(got, want, UPD_RTOL, UPD_ATOL)
    talgo.set_state(jalgo.get_state())
    _, ekey = jax.random.split(jalgo.key)
    key, rkey = jax.random.split(ekey)
    steps = []
    for _ in range(60):
        key, skey = jax.random.split(key)
        steps.append(skey)
    reset = _cartpole_one(rkey)
    step_draws = jax.jit(jax.vmap(_cartpole_one))(jnp.stack(steps))
    want = jalgo.evaluate(1, target_return=150.0)
    got = talgo.evaluate(1, target_return=150.0, draws=[{
        "reset": {"obs": _t(reset)[None]},
        "steps": {"obs": _t(step_draws)[:, None]}}])
    assert got == want


def test_dt_refusals():
    ds = _dt_dataset()
    with pytest.raises(ValueError, match="not divisible"):
        trl.DTConfig(env=trl.CartPole, dataset=ds, d_model=10, n_heads=3,
                     device="cpu").build()
    with pytest.raises(ValueError, match="discrete-action"):
        trl.DTConfig(env=trl.Pendulum, dataset=ds, device="cpu").build()
    with pytest.raises(ValueError, match="discrete-action"):
        trl.DreamerConfig(env=trl.Pendulum, device="cpu").build()


# -- AlphaZero ----------------------------------------------------------------

def _random_positions(n, moves, seed):
    """Boards after ``moves`` random legal plies (flipped as the game
    flips them), none of them finished."""
    rng = np.random.default_rng(seed)
    game = jaz.TicTacToe()
    out = []
    while len(out) < n:
        state = game.initial_state()
        for _ in range(moves):
            legal = np.flatnonzero(np.asarray(game.legal_mask(state)))
            state = game.step(state, int(rng.choice(legal)))
        if not bool(state["terminal"]):
            out.append(_np(state))
    return {k: np.stack([s[k] for s in out]) for k in out[0]}


def test_tictactoe_step_matches_jax():
    """Random boards with wins, draws and terminal states: every legal
    and illegal move's board, terminal flag and winner exactly."""
    rng = np.random.default_rng(3)
    boards = rng.integers(-1, 2, (64, 9)).astype(np.int8)
    terminal = rng.random(64) < 0.2
    state = {"board": boards, "terminal": terminal,
             "winner": np.zeros(64, np.float32)}
    action = rng.integers(0, 9, 64)
    want = jax.vmap(jaz.TicTacToe().step)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(action))
    got = trl.TicTacToe(device="cpu").step(
        {k: _t(v) for k, v in state.items()}, _t(action))
    for k in want:
        _equal(got[k], want[k])
    _equal(trl.TicTacToe(device="cpu").legal_mask(
        {k: _t(v) for k, v in state.items()}),
        jax.vmap(jaz.TicTacToe().legal_mask)(
            {k: jnp.asarray(v) for k, v in state.items()}))


AZ_KW = dict(num_simulations=6, games_per_iter=3, batch_size=9,
             epochs_per_iter=2, hidden=(16,), seed=0)


@functools.lru_cache(maxsize=None)
def _az_pair():
    jalgo = jaz.AlphaZeroConfig(**AZ_KW).build()
    talgo = trl.AlphaZeroConfig(device="cpu", **AZ_KW).build()
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    return jalgo, talgo


def test_mcts_search_matches_jax():
    """One search of 6 simulations from 4 positions (the opening and
    positions after 2 to 5 random plies, where terminal leaves are
    reached): the tree's children and visit counts exactly, priors and
    values within rtol 1e-5 / atol 1e-6, the visit distribution and root
    value.  The JAX tree is the final carry of its simulation loop."""
    jalgo, talgo = _az_pair()
    game = jaz.TicTacToe()
    mcts = jaz.make_mcts(game, jalgo._net, 6, 1.5)
    roots = {k: np.concatenate([
        np.asarray(v)[None], _random_positions(3, 4, 5)[k]])
        for k, v in game.initial_state().items()}
    roots["board"][1] = _random_positions(1, 2, 6)["board"][0]
    real = jax.lax.fori_loop

    def search(state, key):
        captured = {}

        def spy(lo, hi, body, init):
            out = real(lo, hi, body, init)
            if len(init) == 6:
                captured["carry"] = out
            return out

        with unittest.mock.patch.object(jax.lax, "fori_loop", spy):
            pi, value = mcts(jalgo.params, state, key, 0.25, 0.6)
        return pi, value, captured["carry"][:5]

    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    jpi, jv, (jstate, P, N, W, children) = jax.jit(jax.vmap(search))(
        {k: jnp.asarray(v) for k, v in roots.items()}, keys)
    noise = jax.vmap(lambda k: jax.random.dirichlet(
        jax.random.split(k)[1], jnp.full((9,), 0.6)))(keys)
    tmcts = trl.make_mcts(talgo.game, talgo._net, 6, 1.5)
    params = policy_params_from_numpy(talgo, _np(jalgo.params))
    pi, value, tree = tmcts(params, {k: _t(v) for k, v in roots.items()},
                            _t(noise), 0.25)
    _equal(tree["children"], children)
    _equal(tree["N"], N)
    _close(tree["P"], P)
    _close(tree["W"], W)
    _equal(tree["state"]["board"], jstate["board"])
    _close(pi, jpi)
    _close(value, jv)
    assert int((np.asarray(children) >= 0).sum()) > 10


def test_alphazero_selfplay_and_update_match_jax():
    """One self-play of 3 games (6 simulations a move, the first 2 moves
    sampled by visits) and 2 epochs of Adam minibatches: the visit
    distributions, outcomes and live masks exactly, the losses and params
    within rtol 1e-4 / atol 1e-6; then the pit against a random player
    (AlphaZero alternating sides) on JAX's draws; a JAX checkpoint
    loads."""
    jalgo, talgo = _az_pair()
    key, skey = jax.random.split(jalgo.key)
    G, T, A = 3, 9, 9

    def game_draws(k):
        def move(key, _):
            key, mkey, akey = jax.random.split(key, 3)
            return key, (jax.random.dirichlet(
                jax.random.split(mkey)[1], jnp.full((A,), 0.6)),
                jax.random.gumbel(akey, (A,)))
        return jax.lax.scan(move, k, None, length=T)[1]

    dirichlet, gumbel = jax.vmap(game_draws)(jax.random.split(skey, G))
    selfplay = [{"dirichlet": _t(dirichlet[:, t]),
                 "gumbel": _t(gumbel[:, t])} for t in range(T)]
    perms = []
    for _ in range(2):
        key, pkey = jax.random.split(key)
        perms.append(_t(jax.random.permutation(pkey, G * T)).long())
    games = talgo.selfplay(selfplay)
    jgames = jalgo._selfplay(jalgo.params, skey)
    for k in ("z", "live"):
        _equal(games[k], jgames[k])
    _close(games["pi"], jgames["pi"])
    jres = jalgo.train()
    tres = _train(talgo, {"selfplay": selfplay, "perms": perms})
    for k in ("total_loss", "policy_ce"):
        _close(tres[k], jres[k], UPD_RTOL, UPD_ATOL)
    for k in ("p1_win_rate", "draw_rate", "moves_per_game"):
        assert tres[k] == jres[k]
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    talgo.set_state(jalgo.get_state())
    _, gkey = jax.random.split(jalgo.key)

    def pit_draws(k):
        def move(key, _):
            key, mkey, rkey = jax.random.split(key, 3)
            return key, (jax.random.dirichlet(
                jax.random.split(mkey)[1], jnp.full((A,), 0.6)),
                jax.random.gumbel(rkey, (A,)))
        return jax.lax.scan(move, k, None, length=T)[1]

    dirichlet, gumbel = jax.vmap(pit_draws)(jax.random.split(gkey, 4))
    want = jalgo.play_vs_random(4, az_first=False)
    got = talgo.play_vs_random(4, az_first=False, draws=[
        {"dirichlet": _t(dirichlet[:, t]), "gumbel": _t(gumbel[:, t])}
        for t in range(T)])
    assert got == want


# -- SlateQ -------------------------------------------------------------------

SLATE_KW = dict(num_envs=4, rollout_steps=4, buffer_capacity=64,
                batch_size=8, num_updates=2, learn_start=16, hidden=(16,),
                eps_start=0.5, seed=0)


def _slate_step_draws(key, env):
    """The draws of `RecSlateEnv.step` for one env key."""
    ckey, dkey, rkey = jax.random.split(key, 3)
    tkey, qkey = jax.random.split(dkey)
    return {"choice": jax.random.gumbel(ckey, (env.slate_size + 1,)),
            "u0": jax.random.normal(jax.random.split(rkey)[0],
                                    (env.n_topics,)),
            "topics": jax.random.normal(tkey, (env.n_candidates,
                                               env.n_topics)),
            "quality": jax.random.uniform(qkey, (env.n_candidates,))}


@functools.lru_cache(maxsize=None)
def _slate_draws_fn(n):
    env = jslateq.RecSlateEnv()
    return jax.jit(jax.vmap(lambda k: _slate_step_draws(k, env)))


def _slate_env_draws(keys):
    return {k: _t(v) for k, v in _slate_draws_fn(len(keys))(keys).items()}


@functools.lru_cache(maxsize=None)
def _slate_pair():
    jalgo = jslateq.SlateQConfig(**SLATE_KW).build()
    talgo = trl.SlateQConfig(device="cpu", **SLATE_KW).build()
    talgo.params = policy_params_from_numpy(talgo, _np(jalgo.params))
    talgo.target_params = tree_map(torch.clone, talgo.params)
    talgo.opt_state = talgo.optimizer.init(talgo.params)
    talgo.env_states = {k: _t(v) for k, v in
                        _np(jalgo.env_states).items()}
    talgo.obs = {k: _t(v) for k, v in _np(jalgo.obs).items()}
    return jalgo, talgo


def test_slate_env_step_matches_jax():
    """Three steps over a horizon of 2 from random slates: users, fresh
    documents, rewards within rtol 1e-5 / atol 1e-6; picks and dones
    exactly (every env auto-resets once)."""
    jenv = jslateq.RecSlateEnv(horizon=2)
    tenv = trl.RecSlateEnv(horizon=2, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    jstate, _ = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate = {k: _t(v) for k, v in _np(jstate).items()}
    rng = np.random.default_rng(4)
    jstep = jax.jit(jax.vmap(jenv.step))
    key = jax.random.PRNGKey(2)
    for _ in range(3):
        slate = np.stack([rng.choice(16, 3, replace=False)
                          for _ in range(4)]).astype(np.int32)
        key, skey = jax.random.split(key)
        keys = jax.random.split(skey, 4)
        jstate, jobs, jrew, jdone, jpick = jstep(jstate, jnp.asarray(slate),
                                                 keys)
        tstate, tobs, trew, tdone, tpick = tenv.step_given(
            tstate, _t(slate).long(), _slate_env_draws(keys))
        _equal(tpick, jpick)
        _equal(tdone, jdone)
        _close(trew, jrew)
        for k in ("u", "topics", "quality"):
            _close(tstate[k], jstate[k])


def test_best_slate_and_slate_value_match_jax():
    """The exact argmax over all 560 slates (identical slates; the values
    within rtol 1e-5, a near-tie would print its gap) and the decomposed
    value of given slates."""
    jalgo, talgo = _slate_pair()
    rng = np.random.default_rng(6)
    B = 32
    q = rng.normal(size=(B, 16)).astype(np.float32)
    user = rng.normal(size=(B, 8)).astype(np.float32)
    user /= np.linalg.norm(user, axis=-1, keepdims=True)
    topics = rng.normal(size=(B, 16, 8)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=-1, keepdims=True)
    jbest = jax.jit(jalgo._best_slate)(q, user, topics)
    tbest = talgo._best_slate(_t(q), _t(user), _t(topics))
    _equal(tbest, jbest)
    slate = np.stack([rng.choice(16, 3, replace=False)
                      for _ in range(B)]).astype(np.int64)
    _close(talgo._slate_value(_t(q), _t(user), _t(topics), _t(slate)),
           jax.jit(jalgo._slate_value)(q, user, topics, slate))


def test_slateq_iteration_past_the_gate_matches_jax():
    """One iteration (4 envs x 4 steps = 16 rows = learn_start, so the 2
    updates run): the buffer (slates, picks, dones exactly; users, topics,
    rewards within rtol 1e-5), the TD loss and the params and target after
    2 Adam steps (rtol 1e-4 / atol 1e-6); a JAX checkpoint loads."""
    jalgo, talgo = _slate_pair()
    cfg = talgo.config
    E, C = cfg.num_envs, 16
    key, collect = jalgo.key, []
    for _ in range(cfg.rollout_steps):
        key, ekey, rkey, skey = jax.random.split(key, 4)
        collect.append({"uniform": _t(jax.random.uniform(ekey, (E,))),
                        "rand": _t(jax.random.uniform(rkey, (E, C))),
                        "env": _slate_env_draws(jax.random.split(skey, E))})
    updates = []
    for _ in range(cfg.num_updates):
        key, skey = jax.random.split(key)
        updates.append({"idx": _t(jax.random.randint(skey, (8,), 0, 16)
                                  ).long()})
    jres = jalgo.train()
    tres = _train(talgo, {"collect": collect, "updates": updates})
    data = _np(jalgo.buffer["data"])
    for k in ("slate", "pick", "done"):
        _equal(talgo.buffer["data"][k], data[k])
    for k in ("user", "topics", "reward", "next_user"):
        _close(talgo.buffer["data"][k], data[k])
    assert tres["buffer_size"] == int(jres["buffer_size"]) == 16
    _close(tres["td_loss"], jres["td_loss"], UPD_RTOL, UPD_ATOL)
    assert tres["td_loss"] > 0
    _tree_close(talgo.params, _np(jalgo.params), UPD_RTOL, UPD_ATOL)
    _tree_close(talgo.target_params, _np(jalgo.target_params), UPD_RTOL,
                UPD_ATOL)
    talgo.set_state(jalgo.get_state())
    assert talgo._total_env_steps == jalgo._total_env_steps


def test_slateq_refuses_too_many_slates():
    with pytest.raises(ValueError, match="too many"):
        trl.SlateQConfig(env=lambda device: trl.RecSlateEnv(
            n_candidates=40, slate_size=5, device=device),
            device="cpu").build()


def test_converter_names_the_path_on_a_mismatch():
    jalgo, talgo = _az_pair()
    tree = _np(jalgo.params)
    tree["pi"][0]["w"] = tree["pi"][0]["w"][:, :4]
    with pytest.raises(ValueError, match="/pi/0/w"):
        policy_params_from_numpy(talgo, tree)
    del tree["v"]
    with pytest.raises(ValueError, match="keys"):
        policy_params_from_numpy(talgo, tree)
    _, es = _es_pair("ESConfig")
    with pytest.raises(ValueError, match="shape"):
        policy_params_from_numpy(es, np.zeros(3, np.float32))


def test_entry_points_raise_without_cuda_and_device(monkeypatch):
    """With no device given and no CUDA, every new algorithm raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (trl.ESConfig(env=trl.CartPole).build,
                 trl.MAMLConfig().build,
                 trl.DreamerConfig(env=trl.CartPole).build,
                 trl.DTConfig(env=trl.CartPole, dataset=_dt_dataset()).build,
                 trl.AlphaZeroConfig().build, trl.SlateQConfig().build):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
