"""The port's sequence-parallel attention (`ray_tpu_torch.ops.ring_attention`)
and the ring-attention model path against the JAX package's, on four gloo
ranks (sp=4; the model on sp=2 x fsdp=2) held against JAX on the same mesh
shapes over ``jax.devices()[:4]``, from the same numpy inputs and weights.

Tolerances are the JAX tests' own (tests/test_ring_attention.py): outputs
atol 2e-5 / rtol 2e-4, gradients atol 1e-4 / rtol 1e-3.  The model (fp32):
the first loss within 1e-5 relative and each first gradient within 1e-5
of its norm; four AdamW steps (test_torch_train.py's pinned
hyperparameters) must lower the loss, and their losses and the final
weights stay within the drift the Adam steps allow (ADAM_DRIFT).  Under
full remat the gradients are the same whether the backward runs inside
the `use_mesh` block or after it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as JP

from ray_tpu.models import transformer as jtr
from ray_tpu.ops.ring_attention import (make_ring_attention,
                                        make_ulysses_attention,
                                        ring_attention_shard)
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsh
from torch_rank_checks import B1, B2, EPS, LR, WD, run_ranks

WORLD = 4
OUT_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
FIRST_TOL = 1e-5
# four AdamW steps at lr 1e-2 and eps 1e-3: a gradient difference of d
# moves a weight by at most lr / eps * d = 10 d a step.  Measured on this
# CPU: first gradients 1.4e-6 of their norm apart, the four losses 2.4e-7
# relative, the grad norms 1.3e-6, the final weights 4.6e-6 absolute; the
# bounds are about ten times those
ADAM_DRIFT = dict(loss=1e-5, params=5e-5)
STEPS = 4
MODEL = dict(attention_impl="ring", max_seq_len=64)
MODEL_MESH = dict(sp=2, fsdp=2)
# experts under ring attention: each rank's block of the sequence, the
# experts' capacity over whole rows and the aux loss over every rank's rows
MOE_MODEL = dict(MODEL, n_experts=4, expert_top_k=2)
MOE_GRAD_TOL = 1e-5                        # test_torch_moe.py's GRAD_TOL


def _qkv(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))


# name, kind, causal, gradients, (b, s, h, hkv, d)
CASES = [("causal", "ring", True, False, (2, 64, 4, 4, 16)),
         ("noncausal", "ring", False, False, (2, 64, 4, 4, 16)),
         ("gqa", "ring", True, False, (2, 64, 4, 2, 16)),
         ("ulysses", "ulysses", True, False, (2, 64, 8, 8, 16)),
         ("ring_grads", "ring", True, True, (1, 32, 2, 2, 8)),
         ("ulysses_grads", "ulysses", True, True, (1, 32, 4, 4, 8))]


def _jax_mesh(**spec):
    return jmesh.create_mesh(jmesh.MeshSpec(**spec),
                             devices=jax.devices()[:WORLD])


def _jax_attention(kind, causal, mesh):
    if kind == "ulysses":
        return make_ulysses_attention(mesh)
    if causal:
        return make_ring_attention(mesh)
    spec = JP(None, "sp", None, None)
    return jax.jit(jax.shard_map(
        functools.partial(ring_attention_shard, axis_name="sp",
                          axis_size=WORLD, causal=False),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))


def _jax_model(kw=MODEL):
    cfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, **kw)
    params, axes = jtr.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 64),
                                               dtype=np.int32)
    return cfg, params, axes, tokens


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [(name, kind, causal, grads, *_qkv(i, *shape))
             for i, (name, kind, causal, grads, shape) in enumerate(CASES)]
    _, params, _, tokens = _jax_model()
    _, moe_params, _, _ = _jax_model(MOE_MODEL)
    checks = [("attention", dict(spec=dict(sp=WORLD, fsdp=1), cases=cases)),
              ("train", dict(cfg_kw=MODEL, params=jax.tree_util.tree_map(
                  np.asarray, params), tokens=tokens, spec=MODEL_MESH,
                  rules="FSDP_TP_RULES", steps=STEPS, plain=True)),
              ("train:moe", dict(cfg_kw=MOE_MODEL, params=jax.tree_util
                                 .tree_map(np.asarray, moe_params),
                                 tokens=tokens, spec=MODEL_MESH,
                                 rules="FSDP_TP_RULES", steps=0,
                                 plain=True)),
              ("backward_outside", dict(cfg_kw=MODEL, params=jax.tree_util
                                        .tree_map(np.asarray, params),
                                        tokens=tokens, spec=MODEL_MESH)),
              ("backward_outside:moe", dict(
                  cfg_kw=MOE_MODEL, params=jax.tree_util.tree_map(
                      np.asarray, moe_params), tokens=tokens,
                  spec=MODEL_MESH))]
    return cases, run_ranks(tmp_path_factory.mktemp("ring"), WORLD, checks)


@pytest.mark.parametrize("which", range(len(CASES)))
def test_sequence_parallel_attention_matches_jax(ranks, which):
    cases, results = ranks
    name, kind, causal, grads, q, k, v = cases[which]
    mesh = _jax_mesh(sp=WORLD, fsdp=1)
    fn = _jax_attention(kind, causal, mesh)
    want = np.asarray(fn(q, k, v))
    if grads:
        want_grads = jax.grad(lambda *a: (fn(*a) ** 2).sum(),
                              argnums=(0, 1, 2))(q, k, v)
    for r in range(WORLD):
        got = results[r]["attention"][name]
        np.testing.assert_allclose(got["out"], want, **OUT_TOL,
                                   err_msg=f"{name} rank {r}")
        if grads:
            for g, w in zip(got["grads"], want_grads):
                np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                           err_msg=f"{name} rank {r}")


def _flat_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_norm_close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, f"{what} leaf {i}: {err:.3e} of its norm"


@pytest.fixture(scope="module")
def jax_train():
    """JAX's ring model on the same mesh shape: the first loss and
    gradients, then the AdamW steps."""
    cfg, params, axes, tokens = _jax_model()
    mesh = _jax_mesh(**MODEL_MESH)
    params = jax.device_put(params, jsh.pytree_shardings(
        axes, mesh, jsh.FSDP_TP_RULES))
    toks = jax.device_put(tokens, jsh.batch_sharding(mesh,
                                                     jsh.FSDP_TP_RULES))
    opt = optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    state = opt.init(params)
    step = jax.jit(jtr.make_train_step(cfg, opt))
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jtr.lm_loss(p, {"tokens": toks}, cfg)))(params)
        losses, norms = [], []
        for _ in range(STEPS):
            params, state, m = step(params, state, {"tokens": toks})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"loss": float(loss), "grads": _flat_leaves(grads),
            "losses": losses, "norms": norms,
            "params": _flat_leaves(params)}


def test_ring_model_first_step_matches_jax(ranks, jax_train):
    """sp=2 x fsdp=2, weights placed by FSDP_TP_RULES as DTensors: the
    first loss and gradients on every rank are JAX's on the same mesh, and
    the port's own plain step's."""
    _, results = ranks
    for r in range(WORLD):
        got = results[r]["train"]
        for side in ("mesh", "plain"):
            np.testing.assert_allclose(got[side]["loss"], jax_train["loss"],
                                       rtol=FIRST_TOL, err_msg=side)
            _assert_norm_close(got[side]["grads"], jax_train["grads"],
                               FIRST_TOL, f"{side} rank {r}")
        _assert_norm_close(got["mesh"]["grads"], got["plain"]["grads"],
                           FIRST_TOL, f"mesh vs plain rank {r}")


def test_ring_model_trains_like_jax(ranks, jax_train):
    _, results = ranks
    for r in range(WORLD):
        got = results[r]["train"]["mesh"]
        assert got["losses"][-1] < got["losses"][0]
        np.testing.assert_allclose(got["losses"], jax_train["losses"],
                                   rtol=ADAM_DRIFT["loss"])
        np.testing.assert_allclose(got["norms"], jax_train["norms"],
                                   rtol=ADAM_DRIFT["loss"])
        for g, w in zip(got["params"], jax_train["params"]):
            np.testing.assert_allclose(g, w, atol=ADAM_DRIFT["params"],
                                       rtol=0)


def test_ring_model_with_experts_matches_jax(ranks):
    """MoE under ring attention on sp=2 x fsdp=2: the first loss and
    gradients are JAX's on the same mesh and the port's plain step's."""
    _, results = ranks
    cfg, params, axes, tokens = _jax_model(MOE_MODEL)
    mesh = _jax_mesh(**MODEL_MESH)
    params = jax.device_put(params, jsh.pytree_shardings(
        axes, mesh, jsh.FSDP_TP_RULES))
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jtr.lm_loss(
            p, {"tokens": tokens}, cfg)))(params)
    want = _flat_leaves(grads)
    for r in range(WORLD):
        got = results[r]["train:moe"]
        for side in ("mesh", "plain"):
            np.testing.assert_allclose(got[side]["loss"], float(loss),
                                       rtol=FIRST_TOL, err_msg=side)
            for i, (g, w) in enumerate(zip(got[side]["grads"], want)):
                np.testing.assert_allclose(
                    g, w, atol=MOE_GRAD_TOL, rtol=0,
                    err_msg=f"{side} rank {r} leaf {i}")



@pytest.mark.parametrize("which", ["backward_outside",
                                   "backward_outside:moe"])
def test_remat_backward_outside_the_mesh_block_matches_inside(ranks, which):
    """sp=2 x fsdp=2, remat on: the layers recomputed in a backward taken
    after leaving `use_mesh` still run the ring and the experts' statistics
    over the mesh, so each rank's gradients are those of the backward
    taken inside."""
    _, results = ranks
    for r in range(WORLD):
        got = results[r][which]
        assert got["outside"]["loss"] == got["inside"]["loss"]
        for i, (g, w) in enumerate(zip(got["outside"]["grads"],
                                       got["inside"]["grads"])):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r} leaf {i}")
