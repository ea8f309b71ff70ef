"""The port's pipeline (`ray_tpu_torch.parallel.pipeline`), expert-sharded
MoE training and DD-PPO against the JAX package's, on four gloo ranks held
against JAX on the same mesh shapes over ``jax.devices()[:4]``, from the
same numpy weights and tokens (fp32, the tiny llama of
tests/test_pipeline_moe.py).

* the pipelined forward (pp=2 x fsdp=2) is JAX's pipelined forward and
  the port's plain one, within 1e-5;
* a stack placed with layers="pp" is held as each stage's slab alone, and
  gives the outputs and gradients of the whole stack given to every stage;
* a train step with pp=2 x fsdp=2 (weights placed with layers="pp") and a
  MoE step with fsdp=2 x ep=2 give the plain step's loss (1e-5 relative)
  and gradients (1e-5 of each one's norm), and the plain loss is JAX's;
* MoE with pp=2 x ep=2 gives JAX's pipelined loss (1e-5 relative) and
  gradients (1e-5 absolute, test_torch_moe.py's bound; each microbatch
  routes and balances its own rows, in both packages);
* one DD-PPO iteration of 2 learners (dp=2 x fsdp=2: two ranks a learner)
  from JAX's init, resets and draws gives JAX's params, metrics and
  episodes, within test_torch_rl.py's update tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu import rl as jrl
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsh
from torch_rank_checks import B1, B2, EPS, LR, WD, run_ranks

WORLD = 4
TOL = 1e-5
MOE_GRAD_TOL = 1e-5                        # test_torch_moe.py's GRAD_TOL
UPD_RTOL, UPD_ATOL = 1e-4, 1e-6          # test_torch_rl.py's
DENSE = dict(max_seq_len=32, attention_impl="reference")
PIPE = dict(DENSE, pp_stages=2, pp_microbatches=2)
PIPE_MESH = dict(fsdp=2, pp=2)
MOE = dict(DENSE, n_experts=4, expert_top_k=2)
MOE_MESH = dict(fsdp=2, ep=2)
PIPE_MOE = dict(DENSE, n_experts=2, expert_top_k=1, pp_stages=2,
                pp_microbatches=2)
PIPE_MOE_MESH = dict(fsdp=1, pp=2, ep=2)
DDPPO = dict(num_envs=8, rollout_length=8, num_sgd_epochs=2,
             num_minibatches=2, lr=3e-3, seed=0, hidden=(8,))
TOKENS = np.random.default_rng(1).integers(0, 256, (4, 32), dtype=np.int32)
# a stack of 4 layers [L, d, d] and 2 microbatches of 3 rows
SLAB_W = (np.random.default_rng(2).normal(size=(4, 8, 8)) * 0.4).astype(
    np.float32)
SLAB_X = np.random.default_rng(3).normal(size=(2, 3, 8)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model(kw):
    cfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, **dict(kw))
    params, axes = jtr.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, axes


def _np_params(kw):
    return jax.tree_util.tree_map(np.asarray, _jax_model(
        tuple(sorted(kw.items())))[1])


def _jax_mesh(**spec):
    return jmesh.create_mesh(jmesh.MeshSpec(**spec),
                             devices=jax.devices()[:WORLD])


def _rows(rank, spec):
    """This rank's rows of TOKENS: the batch splits over dp x fsdp."""
    sizes = jmesh.MeshSpec(**spec).resolve(WORLD)
    coord = np.unravel_index(rank, [sizes[a] for a in jmesh.MESH_AXES])
    shard = coord[0] * sizes["fsdp"] + coord[1]
    n = TOKENS.shape[0] // (sizes["dp"] * sizes["fsdp"])
    return slice(shard * n, (shard + 1) * n)


# -- the JAX side's DD-PPO draws -----------------------------------------------

def _cartpole_reset(keys):
    return {"obs": np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (4,), minval=-0.05, maxval=0.05))(keys))}


def _ddppo_draws(n_learners):
    """The draws a JAX DD-PPO iteration makes, per learner: the resets from
    the env key, per step the Gumbel noise and the reset draws, then the
    epochs' permutations."""
    cfg = DDPPO
    key = jax.random.PRNGKey(cfg["seed"])
    key, _, ekey = jax.random.split(key, 3)
    ekeys = jax.random.split(ekey, n_learners * cfg["num_envs"])
    gumbel = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (2,))))
    resets, draws, perms = [], [], []
    for i, lkey in enumerate(jax.random.split(key, n_learners)):
        n = cfg["num_envs"]
        resets.append(_cartpole_reset(ekeys[i * n:(i + 1) * n]))
        steps = []
        for _ in range(cfg["rollout_length"]):
            lkey, akey, skey = jax.random.split(lkey, 3)
            steps.append({"noise": np.asarray(gumbel(jax.random.split(
                akey, n))), "reset": _cartpole_reset(jax.random.split(
                    skey, n))})
        draws.append(steps)
        mine = []
        for _ in range(cfg["num_sgd_epochs"]):
            lkey, pkey = jax.random.split(lkey)
            mine.append(np.asarray(jax.random.permutation(
                pkey, n * cfg["rollout_length"])))
        perms.append(np.stack(mine))
    return resets, draws, perms


@pytest.fixture(scope="module")
def jax_ddppo():
    algo = jrl.DDPPOConfig(env=jrl.CartPole, num_learners=2,
                           **DDPPO).build()
    params = jax.tree_util.tree_map(np.asarray, algo.params)
    result = algo.train()
    return params, algo, result


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_ddppo):
    resets, draws, perms = _ddppo_draws(2)
    train = dict(tokens=TOKENS, rules="FSDP_TP_RULES", steps=1)
    checks = [
        ("forward", dict(cfg_kw=PIPE, params=_np_params(PIPE),
                         tokens=TOKENS, spec=PIPE_MESH)),
        ("slab", dict(spec=PIPE_MESH, w=SLAB_W, x=SLAB_X)),
        ("train", dict(train, cfg_kw=PIPE, params=_np_params(PIPE),
                       spec=PIPE_MESH, overrides={"layers": "pp"},
                       plain=True)),
        ("train:moe", dict(train, cfg_kw=MOE, params=_np_params(MOE),
                           spec=MOE_MESH, plain=True)),
        ("train:pipe_moe", dict(train, cfg_kw=PIPE_MOE,
                                params=_np_params(PIPE_MOE),
                                spec=PIPE_MOE_MESH,
                                overrides={"layers": "pp"})),
        ("ddppo", dict(spec=dict(dp=2, fsdp=2), cfg_kw=DDPPO,
                       params=jax_ddppo[0], resets=resets, draws=draws,
                       perms=perms)),
    ]
    return run_ranks(tmp_path_factory.mktemp("pipeline"), WORLD, checks)


def _assert_norm_close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.linalg.norm(np.asarray(g) - np.asarray(w)) / max(
            np.linalg.norm(np.asarray(w)), 1e-30)
        assert err <= tol, f"{what} leaf {i}: {err:.3e} of its norm"


def test_pipelined_forward_matches_jax_and_the_plain_forward(ranks):
    cfg, params, _ = _jax_model(tuple(sorted(PIPE.items())))
    with jax.set_mesh(_jax_mesh(**PIPE_MESH)):
        want, _ = jax.jit(lambda p, t: jtr.forward_with_aux(p, t, cfg))(
            params, TOKENS)
    for r in range(WORLD):
        got = ranks[r]["forward"]
        rows = _rows(r, PIPE_MESH)
        np.testing.assert_allclose(got["logits"], np.asarray(want)[rows],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["logits"], got["plain"][rows],
                                   rtol=TOL, atol=TOL)


def test_placed_stack_is_held_as_each_stages_slab(ranks):
    """pp=2 x fsdp=2: each rank holds and runs only its stage's 2 of the 4
    layers of a stack placed on pp (the whole stack when given whole), and
    both give the chain's outputs and the same gradients."""
    want = SLAB_X
    for wl in SLAB_W:
        want = np.tanh(want @ wl)
    per = (SLAB_W.shape[0] // PIPE_MESH["pp"],) + SLAB_W.shape[1:]
    for r in range(WORLD):
        got = ranks[r]["slab"]
        assert got["placed"]["held"] == per
        assert got["whole"]["held"] == SLAB_W.shape
        for how in ("placed", "whole"):
            assert got[how]["slab"] == per
            np.testing.assert_allclose(got[how]["y"], want, rtol=TOL,
                                       atol=TOL, err_msg=how)
        np.testing.assert_allclose(got["placed"]["grad"],
                                   got["whole"]["grad"], rtol=TOL, atol=TOL)
        assert np.abs(got["placed"]["grad"]).min() > 0


def _jax_loss(kw):
    cfg, params, _ = _jax_model(tuple(sorted(kw.items())))
    return float(jax.jit(lambda p: jtr.lm_loss(
        p, {"tokens": TOKENS}, cfg))(params))


@pytest.mark.parametrize("which,kw", [("train", PIPE), ("train:moe", MOE)])
def test_sharded_step_gives_the_plain_steps_loss_and_gradients(ranks, which,
                                                               kw):
    """pp=2 x fsdp=2 (dense) and fsdp=2 x ep=2 (MoE: the router's
    statistics averaged over both ranks' rows)."""
    want_loss = _jax_loss({**kw, "pp_stages": 1})
    for r in range(WORLD):
        got = ranks[r][which]
        np.testing.assert_allclose(got["plain"]["loss"], want_loss,
                                   rtol=TOL)
        np.testing.assert_allclose(got["mesh"]["loss"],
                                   got["plain"]["loss"], rtol=TOL)
        np.testing.assert_allclose(got["mesh"]["grad_norm"],
                                   got["plain"]["grad_norm"], rtol=TOL)
        _assert_norm_close(got["mesh"]["grads"], got["plain"]["grads"],
                           TOL, f"{which} rank {r}")
        np.testing.assert_allclose(got["mesh"]["losses"],
                                   got["plain"]["losses"], rtol=TOL)


def test_pipelined_moe_step_matches_jax(ranks):
    """pp=2 x ep=2: JAX's pipelined loss and gradients on the same mesh."""
    cfg, params, axes = _jax_model(tuple(sorted(PIPE_MOE.items())))
    mesh = _jax_mesh(**PIPE_MOE_MESH)
    rules = jsh.FSDP_TP_RULES.with_overrides(layers="pp")
    placed = jax.device_put(params, jsh.pytree_shardings(axes, mesh, rules))
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jtr.lm_loss(
            p, {"tokens": TOKENS}, cfg)))(placed)
        opt = optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
        _, _, metrics = jax.jit(jtr.make_train_step(cfg, opt))(
            placed, opt.init(placed), {"tokens": TOKENS})
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    for r in range(WORLD):
        got = ranks[r]["train:pipe_moe"]["mesh"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=TOL)
        # test_torch_moe.py's gradient bound: the router's small gradient
        # goes through the top-k gates and the aux loss in fp32
        for i, (g, w) in enumerate(zip(got["grads"], want)):
            np.testing.assert_allclose(g, w, atol=MOE_GRAD_TOL, rtol=0,
                                       err_msg=f"rank {r} leaf {i}")
        np.testing.assert_allclose(got["losses"][0], float(metrics["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(got["norms"][0],
                                   float(metrics["grad_norm"]), rtol=TOL)


def _tree_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _tree_close(g, w)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=UPD_RTOL,
                                   atol=UPD_ATOL)


def test_ddppo_two_learners_match_jax(ranks, jax_ddppo):
    _, jalgo, jres = jax_ddppo
    jparams = jax.tree_util.tree_map(np.asarray, jalgo.params)
    jobs = np.asarray(jalgo.obs)
    n = DDPPO["num_envs"]
    for r in range(WORLD):
        got = ranks[r]["ddppo"]
        assert got["learner"] == r // 2
        res = got["metrics"]
        assert res["num_learners"] == 2
        assert res["env_steps_this_iter"] == jres["env_steps_this_iter"]
        np.testing.assert_allclose(res["reward_sum"], jres["reward_sum"],
                                   rtol=1e-6)
        for k in ("pi_loss", "vf_loss", "entropy"):
            np.testing.assert_allclose(res[k], jres[k], rtol=UPD_RTOL,
                                       atol=UPD_ATOL, err_msg=k)
        _tree_close(got["params"], jparams)
        i = got["learner"]
        np.testing.assert_allclose(got["obs"], jobs[i * n:(i + 1) * n],
                                   rtol=1e-5, atol=1e-6)
        assert got["done_returns"] == pytest.approx(jalgo._ep_done_returns)
        assert set(got["state"]) == {"params", "iteration"}
