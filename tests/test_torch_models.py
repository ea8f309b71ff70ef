"""The port's models (``ray_tpu_torch.models``) against the JAX package's on
the CPU, on the same weights: the JAX init, carried over by
`ray_tpu_torch.convert.params_from_numpy`, and the same seeded tokens."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtr
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import transformer as ttr

# both packages export a function of the same name as their generate module
jgen = importlib.import_module("ray_tpu.models.generate")
tgen = importlib.import_module("ray_tpu_torch.models.generate")

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
PRESETS = {
    "llama": {},
    "gpt2": dict(pos_emb="learned", activation="gelu", norm="layernorm",
                 tie_embeddings=True, n_kv_heads=None),
    # head_dim 64: the port runs attention through the flash path (its plain
    # version on the CPU), the JAX package through its CPU reference
    "llama-flash": dict(d_model=128, n_heads=2, n_kv_heads=1),
}
# logits atol = rtol.  fp32: both frameworks do the same fp32 arithmetic in
# another order.  bf16: each framework rounds activations to bf16 at its own
# places (fused or not), through two layers; the tiny llama's logits reach
# |4| and differ by up to 0.033.
TOL = {"fp32": 1e-4, "bf16": 0.1}


@functools.lru_cache(maxsize=None)
def _models(preset, dtype):
    """(JAX config, JAX params, port config, port params) on the same
    weights; shared by the tests, none of which writes to the weights."""
    kw = PRESETS[preset]
    jcfg = jtr.TransformerConfig.tiny(dtype=JNP[dtype], **kw)
    tcfg = ttr.TransformerConfig.tiny(
        dtype=TORCH[dtype],
        attention_impl="flash" if preset == "llama-flash" else "auto", **kw)
    jparams, _ = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("preset,dtype", [
    ("llama", "fp32"), ("llama", "bf16"), ("gpt2", "fp32"), ("gpt2", "bf16"),
    ("llama-flash", "fp32")])
def test_forward_prefill_decode_match_jax(preset, dtype):
    jcfg, jparams, tcfg, tparams = _models(preset, dtype)
    tol = TOL[dtype]
    toks = _tokens((2, 12), jcfg.vocab_size)
    ttoks = torch.from_numpy(toks).long()

    jlogits = jax.jit(jtr.forward, static_argnums=2)(jparams, toks, jcfg)
    tlogits = ttr.forward(tparams, ttoks, tcfg)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), atol=tol, rtol=tol)

    jcache = jgen.init_kv_cache(jcfg, 2, 16)
    jl, jcache = jax.jit(jgen.prefill, static_argnums=2)(jparams, toks, jcfg,
                                                         jcache)
    tcache = tgen.init_kv_cache(tcfg, 2, 16, "cpu")
    tl, tcache = tgen.prefill(tparams, ttoks, tcfg, tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=tol)
    assert tcache["pos"] == int(jcache["pos"]) == 12
    for name in ("k", "v"):
        assert tcache[name].dtype == TORCH[dtype]
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   atol=tol, rtol=tol)

    nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    jl2, jcache = jax.jit(jgen.decode_step, static_argnums=3)(
        jparams, nxt, jcache, jcfg)
    tl2, tcache = tgen.decode_step(tparams, torch.from_numpy(nxt).long(),
                                   tcache, tcfg)
    np.testing.assert_allclose(_np(tl2), _np(jl2), atol=tol, rtol=tol)
    assert tcache["pos"] == int(jcache["pos"]) == 13
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("preset", ["llama", "gpt2"])
def test_greedy_generate_gives_jax_tokens(preset):
    jcfg, jparams, tcfg, tparams = _models(preset, "fp32")
    prompt = _tokens((2, 6), jcfg.vocab_size, seed=1)
    jt = jgen.generate(jparams, prompt, cfg=jcfg, max_new_tokens=8)
    tt = tgen.generate(tparams, prompt, cfg=tcfg, max_new_tokens=8)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_decode_past_cache_end_clamps_like_jax():
    """`dynamic_update_slice` clamps: steps past max_len rewrite the last
    cache row, attend over the whole cache, and pos keeps advancing."""
    jcfg, jparams, tcfg, tparams = _models("llama", "fp32")
    toks = _tokens((1, 6), jcfg.vocab_size, seed=2)
    jcache = jgen.init_kv_cache(jcfg, 1, 8)
    jl, jcache = jgen.prefill(jparams, toks, jcfg, jcache)
    tl, tcache = tgen.prefill(tparams, torch.from_numpy(toks).long(), tcfg,
                              tgen.init_kv_cache(tcfg, 1, 8, "cpu"))
    step = jax.jit(jgen.decode_step, static_argnums=3)
    for _ in range(5):                       # positions 6, 7, 8, 9, 10
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        assert int(torch.argmax(tl, dim=-1)[0]) == int(tok[0])
        jl, jcache = step(jparams, tok, jcache, jcfg)
        tl, tcache = tgen.decode_step(tparams, torch.from_numpy(tok).long(),
                                      tcache, tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]),
                                   atol=1e-4, rtol=1e-4)
    assert tcache["pos"] == int(jcache["pos"]) == 11


def test_sampled_generate_stays_in_top_k():
    _, _, tcfg, tparams = _models("llama", "fp32")
    prompt = _tokens((2, 5), tcfg.vocab_size, seed=3)
    greedy = tgen.generate(tparams, prompt, cfg=tcfg, max_new_tokens=6)
    # top_k=1 leaves one candidate: sampling must pick the argmax
    top1 = tgen.generate(tparams, prompt, cfg=tcfg, max_new_tokens=6,
                         temperature=0.7, top_k=1,
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(top1, greedy)
    sampled = tgen.generate(tparams, prompt, cfg=tcfg, max_new_tokens=6,
                            temperature=1.0, top_k=8)
    assert sampled.shape == (2, 6) and sampled.dtype == torch.int32
    assert int(sampled.min()) >= 0 and int(sampled.max()) < tcfg.vocab_size
    with pytest.raises(ValueError):
        tgen.generate(tparams, prompt, cfg=tcfg, max_new_tokens=4,
                      max_len=7)


def test_greedy_sample_breaks_ties_like_jax():
    logits = np.array([[0.5, 3.0, 3.0, -1.0], [2.0, 2.0, 2.0, 2.0]],
                      np.float32)
    want = np.asarray(jgen._sample(jnp.asarray(logits), None, True, 1.0,
                                   None))
    got = tgen._sample(torch.from_numpy(logits), None, True, 1.0, None)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1, 0])   # the first maximal index


@pytest.mark.parametrize("family,size", [
    ("gpt2", "small"), ("gpt2", "xl"), ("llama", "tiny"), ("llama", "1b"),
    ("llama", "8b")])
def test_presets_shapes_and_flops_match_jax(family, size):
    jcfg = getattr(jtr.TransformerConfig, family)(size)
    tcfg = getattr(ttr.TransformerConfig, family)(size)
    abstract = jax.eval_shape(
        lambda k: jtr.init_params(k, jcfg)[0], jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), abstract)
    assert ttr.param_shapes(tcfg) == want
    assert ttr.count_params(tcfg) == jtr.count_params(jcfg)
    assert ttr.flops_per_token(tcfg, 2048) == jtr.flops_per_token(jcfg, 2048)
    assert (ttr.decode_flops_per_token(tcfg, 1000)
            == jtr.decode_flops_per_token(jcfg, 1000))


def test_init_params_and_unported_paths():
    cfg = ttr.TransformerConfig.tiny(param_dtype=torch.bfloat16)
    a = ttr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = ttr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    flat = jax.tree_util.tree_leaves(a)
    assert all(t.dtype == torch.bfloat16 for t in flat)
    assert sum(t.numel() for t in flat) == ttr.count_params(cfg)
    assert all(torch.equal(x, y) for x, y in
               zip(flat, jax.tree_util.tree_leaves(b)))
    assert torch.all(a["layers"]["attn_norm"] == 1)
    # the parallel paths build: ring attention and pipeline stages
    for kw in (dict(pp_stages=2, pp_microbatches=2),
               dict(attention_impl="ring")):
        built = ttr.TransformerConfig.tiny(**kw)
        assert all(getattr(built, k) == v for k, v in kw.items())


def test_params_from_numpy_copies_bf16_bits_and_checks_layout():
    jcfg, jparams, _, _ = _models("llama", "fp32")
    tcfg = ttr.TransformerConfig.tiny(param_dtype=torch.bfloat16)
    # np.asarray of a bf16 JAX array has ml_dtypes' bfloat16 dtype
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(jnp.bfloat16), jparams)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    wq = tparams["layers"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        tree["layers"]["wq"].view(np.int16))
    bad = dict(tree, final_norm=np.ones((3,), np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(bad, tcfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(missing, tcfg, "cpu")
