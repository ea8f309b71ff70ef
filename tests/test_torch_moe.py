"""The port's mixture of experts (`ray_tpu_torch.ops.moe` and the MoE
transformer: forward, loss, training, every generation path) against the
JAX package's on the CPU, on the same numpy inputs and the same weights
(the JAX init, carried over by `ray_tpu_torch.convert.params_from_numpy`).

Routing is fp32 in both packages, but the two libraries sum the router's
products in other orders (about 1e-6 apart), so the combine weights agree
to fp32 rounding and the dispatch (which tokens go where) exactly; with an
all-zero router every gate ties and both agree bitwise.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jtr
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.ops import moe as tmoe

jg = importlib.import_module("ray_tpu.models.generate")
tg = importlib.import_module("ray_tpu_torch.models.generate")
# jitted: op by op, JAX compiles every op of a new shape on its own
j_route = jax.jit(jmoe.route, static_argnums=(2, 3))
j_moe_ffn = jax.jit(jmoe.moe_ffn,
                    static_argnames=("top_k", "capacity_factor"))

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
GPT2 = dict(pos_emb="learned", activation="gelu", norm="layernorm",
            tie_embeddings=True, n_kv_heads=None)
PRESETS = {"swiglu": {}, "gelu": GPT2}
MOE = dict(n_experts=4, expert_top_k=2)
# moe_ffn: out and aux, relative; fp32 differs in summation order only, bf16
# rounds the expert products' outputs at other places
FFN_TOL = {"fp32": 1e-5, "bf16": 2e-2}
# the model, fp32: logits atol = rtol as tests/test_torch_models.py; loss,
# gradients and AdamW as tests/test_torch_train.py
LOGITS_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-4, 1e-5, 1e-5, 1e-4
LR, B1, B2, EPS, WD = 1e-2, 0.9, 0.95, 1e-3, 0.1
MAX_LEN = 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ffn_inputs(seed, b, s, d, f, n_experts, gated, dtype="fp32"):
    """(numpy y, router, w_in, w_out, w_gate or None)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, n_experts)).astype(np.float32) * 0.5
    w = [rng.standard_normal(shape).astype(np.float32) * 0.1
         for shape in ((n_experts, d, f), (n_experts, f, d),
                       (n_experts, d, f))]
    if dtype == "bf16":   # the same bf16 activations on both sides
        y = np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    return y, router, w[0], w[1], (w[2] if gated else None)


def _both(arrs, dtype="fp32"):
    """The same arrays as JAX arrays and as tensors; y (the first) in
    ``dtype``, the weights fp32."""
    jx = [None if a is None else jnp.asarray(a) for a in arrs]
    tx = [None if a is None else torch.from_numpy(a) for a in arrs]
    jx[0], tx[0] = jx[0].astype(JNP[dtype]), tx[0].to(TORCH[dtype])
    return jx, tx


# ------------------------------------------------------------- ops.moe

def test_expert_capacity_matches_jax():
    for args in ((s, e, k, f) for s in (1, 7, 32, 197, 1024)
                 for e in (4, 8) for k in (1, 2)
                 for f in (0.5, 1.0, 1.25, 2.0, 4.0)):
        assert (tmoe.expert_capacity(*args)
                == jmoe.expert_capacity(*args)), args


@pytest.mark.parametrize("s,capacity", [(16, 8), (40, 8)])
def test_route_matches_jax(s, capacity):
    y, router, *_ = _ffn_inputs(0, 2, s, 32, 8, 4, False)
    jd, jc, ja = j_route(jnp.asarray(y), jnp.asarray(router), 2, capacity)
    td, tc, ta = tmoe.route(torch.from_numpy(y), torch.from_numpy(router), 2,
                            capacity)
    assert td.dtype == torch.float32 and tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy() > 0, np.asarray(jc) > 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_all_zero_router_ties_and_overflow_match_jax():
    """Every gate ties: both packages route each token to experts 0 and 1
    (the lower indices), and the tokens past an expert's capacity of 16
    get zero dispatch and combine rows and a zero output
    (tests/test_pipeline_moe.py:88-104)."""
    y, _, w_in, w_out, _ = _ffn_inputs(3, 1, 64, 8, 16, 4, False)
    router = np.zeros((8, 4), np.float32)
    cap = tmoe.expert_capacity(64, 4, 2, 0.5)
    assert cap == jmoe.expert_capacity(64, 4, 2, 0.5) == 16
    jd, jc, ja = j_route(jnp.asarray(y), jnp.asarray(router), 2, cap)
    td, tc, ta = tmoe.route(torch.from_numpy(y), torch.from_numpy(router), 2,
                            cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(ta) == float(ja)
    used = td.numpy()[0].sum(-1)                         # [s, E]
    assert np.all(used[:16] == [1, 1, 0, 0])             # ties to 0 and 1
    assert np.all(used[16:] == 0)                        # overflow: zero rows
    jx, tx = _both((y, router, w_in, w_out))
    jout, _ = j_moe_ffn(*jx, top_k=2, capacity_factor=0.5)
    tout, _ = tmoe.moe_ffn(*tx, top_k=2, capacity_factor=0.5)
    assert torch.all(tout[0, 16:] == 0) and np.all(np.asarray(jout)[0, 16:]
                                                   == 0)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_ffn_matches_jax(gated, dtype):
    # capacity factor 1.0: tokens drop
    arrs = _ffn_inputs(1, 2, 24, 16, 32, 4, gated, dtype)
    (jy, *jw), (ty, *tw) = _both(arrs, dtype)
    jout, jaux = j_moe_ffn(jy, *jw, top_k=2, capacity_factor=1.0)
    tout, taux = tmoe.moe_ffn(ty, *tw, top_k=2, capacity_factor=1.0)
    assert tout.dtype == TORCH[dtype] and taux.dtype == torch.float32
    tol = FFN_TOL[dtype]
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_moe_ffn_matches_the_reference_with_ample_capacity(gated):
    """capacity_factor = E / k: capacity >= s, so no token drops."""
    _, (ty, *tw) = _both(_ffn_inputs(2, 2, 16, 8, 16, 4, gated))
    out, aux = tmoe.moe_ffn(ty, *tw, top_k=2, capacity_factor=4 / 2)
    ref = tmoe.moe_ffn_reference(ty, *tw, top_k=2)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(aux) and float(aux) > 0


@pytest.mark.parametrize("gated", [True, False])
def test_moe_ffn_grads_match_jax(gated):
    arrs = _ffn_inputs(4, 2, 24, 16, 32, 4, gated)
    (jy, *jw), (ty, *tw) = _both(arrs)
    n = 5 if gated else 4
    cot = np.random.default_rng(5).standard_normal(arrs[0].shape).astype(
        np.float32)

    def jloss(*args):
        out, aux = jmoe.moe_ffn(*args[:4], args[4] if gated else None,
                                top_k=2, capacity_factor=1.0)
        return (out * cot).sum() + 3.0 * aux

    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(n))))(
        jy, *jw[:n - 1])
    leaves = [t.clone().requires_grad_(True) for t in [ty, *tw[:n - 1]]]
    out, aux = tmoe.moe_ffn(*leaves[:4], leaves[4] if gated else None,
                            top_k=2, capacity_factor=1.0)
    tgrads = torch.autograd.grad((out * torch.from_numpy(cot)).sum()
                                 + 3.0 * aux, leaves)
    for name, g, w in zip(("y", "router", "w_in", "w_out", "w_gate"),
                          tgrads, jgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------ the model

@functools.lru_cache(maxsize=None)
def _weights(preset):
    kw = dict(PRESETS[preset], **MOE, max_seq_len=MAX_LEN)
    jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32, **kw)
    # jitted: one compile instead of one for each of the init's ops
    jparams = jax.jit(lambda key: jtr.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _models(preset, **kw):
    """(JAX config, JAX params, port config, port params), fp32, on the
    same weights, the configs with ``kw`` (options that leave the weights'
    shapes alone); the weights are shared by the tests, none of which
    writes to them."""
    jcfg, jparams, tcfg, tparams = _weights(preset)
    return (dataclasses.replace(jcfg, **kw), jparams,
            dataclasses.replace(tcfg, **kw), tparams)


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("preset", ["swiglu", "gelu"])
def test_moe_shapes_and_counts_match_jax(preset):
    jcfg, jparams, tcfg, tparams = _models(preset)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert ttr.param_shapes(tcfg) == shapes
    assert ttr.param_shapes(tcfg)["layers"]["w_in"] == (2, 4, 64,
                                                        tcfg.ff_dim)
    assert ttr.count_params(tcfg) == jtr.count_params(jcfg)
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(tparams)) == \
        ttr.count_params(tcfg)
    assert ttr.flops_per_token(tcfg, 32) == jtr.flops_per_token(jcfg, 32)
    assert (ttr.decode_flops_per_token(tcfg, 20)
            == jtr.decode_flops_per_token(jcfg, 20))
    assert (ttr.engine_flops_table(tcfg, 64, draft_cfg=tcfg)
            == jtr.engine_flops_table(jcfg, 64, draft_cfg=jcfg))
    # the port's own init draws the same tree, with every expert
    init = ttr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), init) == shapes


def test_params_from_numpy_checks_the_expert_layout():
    jcfg, jparams, tcfg, _ = _models("swiglu")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    dense = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                       max_seq_len=MAX_LEN)
    with pytest.raises(ValueError, match="router"):
        params_from_numpy(tree, dense, "cpu")
    tree["layers"]["w_in"] = tree["layers"]["w_in"][:, :3]
    with pytest.raises(ValueError, match="w_in"):
        params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("preset", ["swiglu", "gelu"])
def test_moe_forward_with_aux_matches_jax(preset):
    jcfg, jparams, tcfg, tparams = _models(preset)
    toks = _tokens((2, 24), jcfg.vocab_size)
    jlogits, jaux = jax.jit(jtr.forward_with_aux, static_argnums=2)(
        jparams, toks, jcfg)
    tlogits, taux = ttr.forward_with_aux(tparams, torch.from_numpy(toks),
                                         tcfg)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=LOSS_TOL)
    assert float(taux) > 0


def _batch(b, s, vocab, mask=None, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s), dtype=np.int32)}
    if mask is not None:
        batch["mask"] = (np.arange(s)[None, :]
                         < np.asarray(mask)[:, None]).astype(np.int32)
    return batch, {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_leaves_close(got, want, atol):
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=0)


@pytest.mark.parametrize("preset,loss_chunk,mask", [
    ("swiglu", 4, [16, 9]), ("gelu", 0, [5, 16])])
def test_moe_lm_loss_and_grads_match_jax(preset, loss_chunk, mask):
    """The loss carries router_aux_weight times the mean aux, on both the
    chunked and the full branch."""
    jcfg, jparams, tcfg, tparams = _models(preset, loss_chunk=loss_chunk)
    jb, tb = _batch(2, 16, jcfg.vocab_size, mask)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jtr.lm_loss, cfg=jcfg)))(jparams, jb)
    leaves = [p.detach().requires_grad_(True)
              for p in ttr.param_leaves(tparams)]
    loss = ttr.lm_loss(ttr._with_leaves(tparams, leaves), tb, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    _assert_leaves_close(grads, jgrads, GRAD_TOL)
    # the aux term is there: without it the loss is another number
    plain = ttr.lm_loss(tparams, tb, dataclasses.replace(
        tcfg, router_aux_weight=0.0))
    assert float(loss) - float(plain) > 1e-3


def test_moe_adamw_steps_match_optax():
    """Three steps of gpt2's family with experts (the card's MoE model);
    the SwiGLU experts' gradients are held above."""
    jcfg, jparams, tcfg, tparams = _models("gelu")
    opt = optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    jstep = jax.jit(jtr.make_train_step(jcfg, opt))
    state = opt.init(jparams)
    tparams = jax.tree_util.tree_map(torch.clone, tparams)
    topt = torch.optim.AdamW(ttr.param_leaves(tparams), lr=LR,
                             betas=(B1, B2), eps=EPS, weight_decay=WD)
    tstep = ttr.make_train_step(tcfg, topt)
    for seed in (1, 2, 3):
        jb, tb = _batch(2, 16, jcfg.vocab_size, seed=seed)
        jparams, state, jm = jstep(jparams, state, jb)
        tm = tstep(tparams, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=LOSS_TOL, err_msg=key)
    _assert_leaves_close(ttr.param_leaves(tparams), jparams, PARAM_TOL)


# ------------------------------------------------------- generation paths

def test_moe_whole_prompt_generation_matches_jax():
    """At capacity factor 0.5 a prompt's prefill drops tokens that a decode
    step (capacity 8 for one token) or a narrower chunk keeps, so the
    programs give other results, in both packages alike.  (With 4 experts
    and top 2, the default factor 2.0 gives capacity >= s: nothing
    drops.)"""
    jcfg, jp, tcfg, tp = _models("gelu", capacity_factor=0.5)
    prompt = _tokens((2, 20), jcfg.vocab_size, seed=7)
    jtoks = jg.generate(jp, jnp.asarray(prompt), cfg=jcfg, max_new_tokens=6,
                        max_len=MAX_LEN)
    ttoks = tg.generate(tp, prompt, cfg=tcfg, max_new_tokens=6,
                        max_len=MAX_LEN)
    assert ttoks.tolist() == np.asarray(jtoks).tolist()

    @jax.jit
    def j_prefill_decode(p, prompt):
        """prefill, then one decode_step of its greedy token; one compile"""
        logits, cache = jg.prefill(p, prompt, jcfg,
                                   jg.init_kv_cache(jcfg, 2, MAX_LEN))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        return logits, jg.decode_step(p, tok, cache, jcfg)[0]

    jl, jl2 = j_prefill_decode(jp, jnp.asarray(prompt))
    tl, tc = tg.prefill(tp, torch.from_numpy(prompt), tcfg,
                        tg.init_kv_cache(tcfg, 2, MAX_LEN, "cpu"))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGITS_TOL)
    tok = np.asarray(jl).argmax(-1)
    assert tl.argmax(-1).tolist() == tok.tolist()
    tl2, _ = tg.decode_step(tp, torch.from_numpy(tok), tc, tcfg)
    np.testing.assert_allclose(_np(tl2), _np(jl2), rtol=0, atol=LOGITS_TOL)
    assert tl2.argmax(-1).tolist() == np.asarray(jl2).argmax(-1).tolist()

    # the same prompt as [2, 8] chunks (capacity 8) into the same cache
    jcc, tcc = jg.init_kv_cache(jcfg, 2, MAX_LEN), tg.init_kv_cache(
        tcfg, 2, MAX_LEN, "cpu")
    for off in range(0, 16, 8):
        jl3, jcc = jg.prefill_chunk_jit(
            jp, jnp.asarray(prompt[:, off:off + 8]), jcc, cfg=jcfg)
        tl3, tcc = tg.prefill_chunk(tp, torch.from_numpy(
            prompt[:, off:off + 8]), tcc, tcfg)
        np.testing.assert_allclose(_np(tl3), _np(jl3), rtol=0,
                                   atol=LOGITS_TOL)
    # drops: the whole prompt is not its chunks
    whole, _ = tg.prefill(tp, torch.from_numpy(prompt[:, :16]), tcfg,
                          tg.init_kv_cache(tcfg, 2, MAX_LEN, "cpu"))
    assert not torch.allclose(whole, tl3, atol=1e-3)


def test_moe_slot_steps_at_max_len_match_jax():
    """decode_step_slots and a 4-wide verify_step_slots over slots at mid
    cache, the last row, max_len and past it, at the default capacity
    factor (at most 4 tokens of a row reach an expert of capacity 8: no
    factor drops any here)."""
    jcfg, jp, tcfg, tp = _models("swiglu")
    pos = [3, MAX_LEN - 1, MAX_LEN, MAX_LEN - 2]
    active = np.array([True, True, True, False])
    rng = np.random.default_rng(9)
    shape = (jcfg.n_layers, 4, MAX_LEN, jcfg.kv_heads, jcfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")

    def caches():
        return ({"k": jnp.asarray(k), "v": jnp.asarray(v),
                 "pos": jnp.asarray(pos, jnp.int32)},
                {"k": torch.tensor(k), "v": torch.tensor(v),
                 "pos": torch.tensor(pos)})

    tok = rng.integers(0, jcfg.vocab_size, 4)
    jc, tc = caches()
    jl, jc2 = jax.jit(jg.decode_step_slots, static_argnames="cfg")(
        jp, jnp.asarray(tok, jnp.int32), jc, jnp.asarray(active), cfg=jcfg)
    tl, tc2 = tg.decode_step_slots(tp, torch.from_numpy(tok), tc,
                                   torch.from_numpy(active), tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGITS_TOL)
    assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    assert tc2["pos"].tolist() == np.asarray(jc2["pos"]).tolist()
    np.testing.assert_allclose(tc2["k"].numpy(), np.asarray(jc2["k"]),
                               rtol=0, atol=1e-5)

    props = rng.integers(0, jcfg.vocab_size, (4, 3))
    props[:, 0] = np.asarray(jl).argmax(-1)     # one proposal accepted
    fed = np.concatenate([tok[:, None], props], 1)
    jc, tc = caches()
    jgr, jacc, jc2 = jax.jit(jg.verify_step_slots, static_argnames="cfg")(
        jp, jnp.asarray(fed, jnp.int32), jnp.asarray(props, jnp.int32), jc,
        jnp.asarray(active), cfg=jcfg)
    tgr, tacc, tc2 = tg.verify_step_slots(
        tp, torch.from_numpy(fed), torch.from_numpy(props), tc,
        torch.from_numpy(active), tcfg)
    assert tgr.tolist() == np.asarray(jgr).tolist()
    assert tacc.tolist() == np.asarray(jacc).tolist()
    assert tc2["pos"].tolist() == np.asarray(jc2["pos"]).tolist()
    np.testing.assert_allclose(tc2["v"].numpy(), np.asarray(jc2["v"]),
                               rtol=0, atol=1e-5)
