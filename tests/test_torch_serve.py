"""The port's `DecodeSessionCore` against the JAX package's
``DecodeSessionCore(engine=False)`` on the CPU, on the same weights: the
same ops in the same order must give the same replies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu.serve.decode_session import DecodeSessionCore as JCore
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import TransformerConfig as TConfig
from ray_tpu_torch.serve import DecodeSessionCore as TCore


def _cores(max_len, max_sessions=64):
    """fp32 tiny llama twins sharing the JAX init's weights."""
    jcfg = JConfig.tiny(dtype=jnp.float32)
    tcfg = TConfig.tiny(dtype=torch.float32)
    jparams, _ = jinit(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return (JCore(jcfg, max_len=max_len, engine=False, params=jparams,
                  max_sessions=max_sessions),
            TCore(tcfg, max_len=max_len, engine=False, params=tparams,
                  max_sessions=max_sessions, device="cpu"))


def _prompt(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).tolist()


def _run(core, prompt, n_next):
    start = core.handle({"op": "start", "prompt": prompt})
    stream = [start["token"]]
    for i in range(n_next):
        op = "next_chunk" if i == 1 else "next"
        out = core.handle({"op": op, "sid": start["sid"]})
        stream.append(out["tokens"] if op == "next_chunk" else out["token"])
    return start["sid"], stream


def test_token_streams_match_jax_including_past_max_len():
    jcore, tcore = _cores(max_len=16)
    # a 10-token prompt with 9 steps runs past max_len = 16: both clamp
    for prompt in (_prompt(10, 0), _prompt((2, 7), 1)):
        jsid, jstream = _run(jcore, prompt, 9)
        tsid, tstream = _run(tcore, prompt, 9)
        assert tstream == jstream
        assert isinstance(tsid, int) and tsid == jsid
        assert tcore.handle({"op": "end", "sid": tsid}) == {"ended": True}
        assert jcore.handle({"op": "end", "sid": jsid}) == {"ended": True}
    assert tcore.handle({"op": "stats"}) == jcore.handle({"op": "stats"})


def test_error_replies_and_lru_eviction():
    jcore, tcore = _cores(max_len=16, max_sessions=2)
    for core in (jcore, tcore):
        sids = [core.handle({"op": "start", "prompt": _prompt(4, s)})["sid"]
                for s in range(2)]
        core.handle({"op": "next", "sid": sids[0]})    # sid 0 most recent
        third = core.handle({"op": "start", "prompt": _prompt(4, 2)})["sid"]
        assert "error" in core.handle({"op": "next", "sid": sids[1]})
        assert "token" in core.handle({"op": "next", "sid": sids[0]})
        assert "token" in core.handle({"op": "next", "sid": third})
        assert "error" in core.handle({"op": "next", "sid": 99})
        assert "error" in core.handle({"op": "next_chunk", "sid": 99})
        assert core.handle({"op": "end", "sid": 99}) == {"ended": False}
        assert core.handle({"op": "end", "sid": third}) == {"ended": True}
        assert "error" in core.handle({"op": "next", "sid": third})
        assert "error" in core.handle({"op": "resume", "prompt": [1, 2]})
        assert core.handle({"op": "stats"})["legacy_sessions"] == 1


def test_the_engine_is_the_default_core():
    """TCore(cfg) serves on the continuous-batching engine, as the JAX
    package's core does; engine=False keeps the eager path."""
    _, tcore = _cores(max_len=16)
    engine_core = TCore(tcore.cfg, max_len=16, params=tcore.params,
                        device="cpu")
    assert engine_core._engine_cfg is not None and tcore._engine_cfg is None
    r = engine_core.handle({"op": "start", "prompt": _prompt(5, 3)})
    assert isinstance(r["sid"], str) and r["proto"] == "chunk"
    assert "engine" in engine_core.handle({"op": "stats"})
    assert engine_core.handle({"op": "end", "sid": r["sid"]}) == \
        {"ended": True}
    engine_core.engine.shutdown()


@pytest.mark.parametrize("prompt_len,chunk", [(10, 8), (16, 8), (5, 8)])
def test_chunked_prefill_core_matches_jax(prompt_len, chunk):
    """prefill_chunk > 0 on engine=False: the prompt in chunks through
    prefill_chunked, as the JAX core does."""
    jbase, tbase = _cores(max_len=32)
    jcore = JCore(jbase.cfg, max_len=32, engine=False, params=jbase.params,
                  prefill_chunk=chunk)
    tcore = TCore(tbase.cfg, max_len=32, engine=False, params=tbase.params,
                  prefill_chunk=chunk, device="cpu")
    prompt = _prompt(prompt_len, prompt_len)
    assert _run(tcore, prompt, 6)[1] == _run(jcore, prompt, 6)[1]


@pytest.mark.parametrize("option", [dict(pp_stages=2)])
def test_unported_options_raise(option):
    """Generation refuses a pipelined config, as the JAX package's
    ``_check_decodable`` does, with its message."""
    import importlib
    # the packages' attribute ``generate`` is the function: import modules
    jgen = importlib.import_module("ray_tpu.models.generate")
    tgen = importlib.import_module("ray_tpu_torch.models.generate")
    tcfg = TConfig.tiny(dtype=torch.float32, **option)
    jcfg = JConfig.tiny(dtype=jnp.float32, **option)
    with pytest.raises(NotImplementedError) as want:
        jgen._check_decodable(jcfg)
    cache = tgen.init_kv_cache(tcfg, 1, 8, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError) as got:
        tgen.prefill({}, tokens, tcfg, cache)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="pipeline mesh"):
        tgen.decode_step({}, tokens[:, :1], cache, tcfg)
