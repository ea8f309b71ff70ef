"""The port's slot-cache, chunked-prefill and speculative functions
(`ray_tpu_torch.models.generate`) against their JAX twins on the CPU.

Same weights (the JAX init carried over with `params_from_numpy`), same
numpy inputs, tiny fp32 llama, ``max_len`` 16.  Logits and the K/V
rows a call writes are held to a max-abs tolerance of 1e-5: both are fp32
products that the two libraries sum in other orders (about 2e-6 apart
here).  Tokens, ``pos``, ``accepted`` and every K/V row a call does not
write (dropped writes included) are compared exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JConfig
from ray_tpu.models import engine_flops_table as j_flops_table
from ray_tpu.models import init_params as jinit
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import TransformerConfig as TConfig
from ray_tpu_torch.models import engine_flops_table as t_flops_table
from ray_tpu_torch.serve.step_graph import FusedDecodeStep

jg = importlib.import_module("ray_tpu.models.generate")
tg = importlib.import_module("ray_tpu_torch.models.generate")
# jitted once: the JAX functions scan over the layers, and an un-jitted
# scan compiles again on every call
j_decode = jax.jit(jg.decode_step_slots, static_argnames=("cfg",))
j_verify = jax.jit(jg.verify_step_slots, static_argnames=("cfg",))
j_draft = jax.jit(jg.draft_propose_slots, static_argnames=("cfg", "k"))

ATOL = 1e-5
MAX_LEN = 16
SLOTS = 4


@pytest.fixture(scope="module")
def twins():
    """(jcfg, jparams, tcfg, tparams): fp32 tiny llama twins."""
    jcfg = JConfig.tiny(dtype=jnp.float32)
    tcfg = TConfig.tiny(dtype=torch.float32)
    jparams, _ = jinit(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _kv(seed, batch, cfg, max_len=MAX_LEN):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]


def _slot_caches(seed, cfg, pos):
    k, v = _kv(seed, len(pos), cfg)
    pos = np.asarray(pos)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v),
             "pos": jnp.asarray(pos, jnp.int32)},
            {"k": torch.tensor(k), "v": torch.tensor(v),
             "pos": torch.tensor(pos, dtype=torch.long)}, (k, v))


def _check_cache(jc, tc, before, written):
    """K/V: rows in ``written`` (a bool [batch, max_len] mask) within
    ATOL, every other row bitwise the input's in both packages."""
    for name, old in zip("kv", before):
        j, t = np.asarray(jc[name]), tc[name].numpy()
        keep = ~written
        np.testing.assert_array_equal(j[:, keep], old[:, keep])
        np.testing.assert_array_equal(t[:, keep], old[:, keep])
        np.testing.assert_allclose(t[:, written], j[:, written], rtol=0,
                                   atol=ATOL)


def _rows(pos, width, max_len=MAX_LEN):
    """[batch, max_len] mask of rows pos .. pos + width - 1 below
    max_len: the rows a slot function writes."""
    out = np.zeros((len(pos), max_len), bool)
    for s, p in enumerate(pos):
        out[s, p:min(p + width, max_len)] = True
    return out


# pos per slot: mid-cache, the last row, at max_len (write dropped, angles
# clamped), past it, and 0; inactive slots compute too
DECODE_CASES = [
    ([3, 15, 16, 0], [True, True, True, False]),
    ([0, 7, 18, 15], [False, True, True, True]),
    ([16, 16, 16, 16], [True, False, True, False]),
]


@pytest.mark.parametrize("pos,active", DECODE_CASES)
def test_decode_step_slots_matches_jax(twins, pos, active):
    jcfg, jp, tcfg, tp = twins
    tok = np.random.default_rng(1).integers(0, 256, SLOTS)
    jc, tc, before = _slot_caches(0, jcfg, pos)
    jl, jc2 = j_decode(jp, jnp.asarray(tok, jnp.int32), jc,
                       jnp.asarray(active), cfg=jcfg)
    tl, tc2 = tg.decode_step_slots(tp, torch.tensor(tok), tc,
                                   torch.tensor(active), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    assert tc2["pos"].tolist() == np.asarray(jc2["pos"]).tolist()
    assert tc["pos"].tolist() == pos        # pos is never written in place
    _check_cache(jc2, tc2, before, _rows(pos, 1))


@pytest.mark.parametrize("pos,active", DECODE_CASES)
def test_fused_step_is_decode_step_argmax_and_carry(twins, pos, active):
    """The engine's step (eager on the CPU): decode_step_slots, argmax,
    where(active, next, tok), pos committed in place."""
    _, _, tcfg, tp = twins
    tok = np.random.default_rng(2).integers(0, 256, SLOTS)
    _, tc, (k, v) = _slot_caches(3, tcfg, pos)
    _, ref = _slot_caches(3, tcfg, pos)[:2]
    step = FusedDecodeStep(tp, tc, tcfg)
    out = step.run(tok, np.asarray(active))
    logits, ref2 = tg.decode_step_slots(tp, torch.tensor(tok), ref,
                                        torch.tensor(active), tcfg)
    want = torch.where(torch.tensor(active), logits.argmax(-1),
                       torch.tensor(tok))
    assert out.tolist() == want.tolist()
    assert tc["pos"].tolist() == ref2["pos"].tolist()
    assert torch.equal(step.logits, logits)
    assert torch.equal(tc["k"], ref2["k"]) and torch.equal(tc["v"], ref2["v"])


# (cache pos, chunk width): inside the cache, ending on its last row, and
# overrunning it (written at the start clamped to max_len - c, the mask
# unshifted)
@pytest.mark.parametrize("pos,c", [(0, 5), (4, 4), (11, 5), (14, 5),
                                   (16, 4)])
def test_prefill_chunk_matches_jax(twins, pos, c):
    jcfg, jp, tcfg, tp = twins
    toks = np.random.default_rng(pos).integers(0, 256, (2, c))
    k, v = _kv(5, 2, jcfg)
    jl, jc = jg.prefill_chunk_jit(
        jp, jnp.asarray(toks, jnp.int32),
        {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.int32(pos)},
        cfg=jcfg)
    tl, tc = tg.prefill_chunk(tp, torch.tensor(toks),
                              {"k": torch.tensor(k), "v": torch.tensor(v),
                               "pos": pos}, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == pos + c
    row = min(pos, MAX_LEN - c)
    _check_cache(jc, tc, (k, v), _rows([row, row], c))


@pytest.mark.parametrize("length,chunk", [(13, 4), (8, 4), (3, 8)])
def test_prefill_chunked_and_resume_prefill_match_jax(twins, length, chunk):
    jcfg, jp, tcfg, tp = twins
    toks = np.random.default_rng(length).integers(0, 256, (1, length))
    for jfn, tfn in ((jg.prefill_chunked, tg.prefill_chunked),
                     (jg.resume_prefill, tg.resume_prefill)):
        jl, jc = jfn(jp, jnp.asarray(toks, jnp.int32), jcfg,
                     jg.init_kv_cache(jcfg, 1, MAX_LEN), chunk=chunk)
        tl, tc = tfn(tp, torch.tensor(toks), tcfg,
                     tg.init_kv_cache(tcfg, 1, MAX_LEN, "cpu"), chunk=chunk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        assert tc["pos"] == int(jc["pos"]) == length
        zeros = np.zeros((jcfg.n_layers, 1, MAX_LEN, jcfg.kv_heads,
                          jcfg.head_dim), np.float32)
        _check_cache(jc, tc, (zeros, zeros), _rows([0], length))


def test_prefill_chunked_rejects_a_prompt_longer_than_the_cache(twins):
    _, _, tcfg, tp = twins
    toks = torch.zeros((1, MAX_LEN + 1), dtype=torch.long)
    for fn in (tg.prefill_chunked, tg.resume_prefill):
        with pytest.raises(ValueError, match="exceeds cache capacity"):
            fn(tp, toks, tcfg, tg.init_kv_cache(tcfg, 1, MAX_LEN, "cpu"))


def test_cache_insert_and_gather_slot_match_jax(twins):
    jcfg, _, tcfg, _ = twins
    jc, tc, _ = _slot_caches(7, jcfg, [3, 9, 0, 12])
    k, v = _kv(8, 1, jcfg)
    jc = jg.cache_insert_slot(jc, {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                   "pos": jnp.int32(6)}, jnp.int32(2))
    out = tg.cache_insert_slot(tc, {"k": torch.tensor(k),
                                    "v": torch.tensor(v), "pos": 6}, 2)
    assert out is tc                           # written in place
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jc[name]))
    jg1 = jg.cache_gather_slot(jc, jnp.int32(1), jnp.int32(5))
    tg1 = tg.cache_gather_slot(tc, 1, 5)
    assert tg1["pos"] == int(jg1["pos"]) == 5
    for name in "kv":
        np.testing.assert_array_equal(tg1[name].numpy(),
                                      np.asarray(jg1[name]))
    tg1["k"].fill_(0)                          # a copy: the slot keeps its
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))


def test_init_slot_cache_matches_jax(twins):
    jcfg, _, tcfg, _ = twins
    jc = jg.init_slot_cache(jcfg, SLOTS, MAX_LEN)
    tc = tg.init_slot_cache(tcfg, SLOTS, MAX_LEN, "cpu")
    for name in ("k", "v", "pos"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


@pytest.mark.parametrize("k", [2, 4])
def test_draft_propose_slots_matches_jax(twins, k):
    jcfg, jp, tcfg, tp = twins
    pos = [3, 14, 9, 0]
    active = [True, True, False, True]
    tok = np.random.default_rng(k).integers(0, 256, SLOTS)
    jc, tc, before = _slot_caches(11, jcfg, pos)
    jprops, jc2 = j_draft(jp, jnp.asarray(tok, jnp.int32), jc,
                          jnp.asarray(active), cfg=jcfg, k=k)
    tprops, tc2 = tg.draft_propose_slots(tp, torch.tensor(tok), tc,
                                         torch.tensor(active), tcfg, k)
    assert tprops.tolist() == np.asarray(jprops).tolist()
    assert tc2["pos"].tolist() == np.asarray(jc2["pos"]).tolist()
    written = np.zeros((SLOTS, MAX_LEN), bool)
    for s, p in enumerate(pos):   # inactive slots rewrite their pos row
        written[s, p:min(p + (k if active[s] else 1), MAX_LEN)] = True
    _check_cache(jc2, tc2, before, written)


# per slot pos: room for every fed token, room for 2, 1 and 0 (accepted
# clamped to the room, at least 1; writes past max_len dropped)
@pytest.mark.parametrize("agree", [0, 1, 3])
def test_verify_step_slots_matches_jax_with_the_accepted_clamp(twins,
                                                               agree):
    """``agree`` leading proposals are the target's own greedy chain (so
    acceptance reaches 1 + agree before the clamp)."""
    jcfg, jp, tcfg, tp = twins
    c = 4
    pos = [3, 14, 15, 16]
    active = np.array([True, True, True, False])
    rng = np.random.default_rng(agree)
    tok = rng.integers(0, 256, SLOTS)
    jc, _, before = _slot_caches(13, jcfg, pos)
    # the target's chain from each slot's state, by greedy plain steps
    chain, cc, t = [], jc, jnp.asarray(tok, jnp.int32)
    for _ in range(c - 1):
        logits, cc = j_decode(jp, t, cc, jnp.ones(SLOTS, bool), cfg=jcfg)
        t = jnp.argmax(logits, -1).astype(jnp.int32)
        chain.append(np.asarray(t))
    props = rng.integers(0, 256, (SLOTS, c - 1))
    props[:, :agree] = np.stack(chain, 1)[:, :agree]
    fed = np.concatenate([tok[:, None], props], 1)
    jc, tc, _ = _slot_caches(13, jcfg, pos)
    jgr, jacc, jc2 = j_verify(
        jp, jnp.asarray(fed, jnp.int32), jnp.asarray(props, jnp.int32), jc,
        jnp.asarray(active), cfg=jcfg)
    tgr, tacc, tc2 = tg.verify_step_slots(
        tp, torch.tensor(fed), torch.tensor(props), tc,
        torch.tensor(active), tcfg)
    assert tgr.tolist() == np.asarray(jgr).tolist()
    assert tacc.tolist() == np.asarray(jacc).tolist()
    assert tc2["pos"].tolist() == np.asarray(jc2["pos"]).tolist()
    assert tacc.tolist()[1:] == [min(1 + agree, 2), 1, 1]
    _check_cache(jc2, tc2, before, _rows(pos, c))


@pytest.mark.parametrize("draft", [None, "tiny1"])
@pytest.mark.parametrize("max_len", [64, 2048])
def test_engine_flops_table_matches_jax(draft, max_len):
    jcfg, tcfg = JConfig.llama("1b"), TConfig.llama("1b")
    jd = td = None
    if draft:
        jd, td = JConfig.tiny(n_layers=1), TConfig.tiny(n_layers=1)
    assert t_flops_table(tcfg, max_len, draft_cfg=td) == \
        j_flops_table(jcfg, max_len, draft_cfg=jd)
