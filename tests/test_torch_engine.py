"""The port's continuous-batching engine (`ray_tpu_torch.serve`) against
the JAX package's engine on the CPU.

Both cores serve the same tiny fp32 llama (the JAX init carried over with
`params_from_numpy`) at ``max_len`` 64, and every scenario runs the same
ops on both: the greedy token streams must be identical.  The scenarios
follow the JAX package's own engine tests (`test_serve_decode_engine.py`,
`test_serve_spec_decode.py`).  Engines of one configuration are shared by
the tests of this module; each test ends its sessions, and the module's
teardown shuts every engine down.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.exceptions import ReplicaUnavailableError as JUnavailable
from ray_tpu.models import TransformerConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu.serve.config import DecodeEngineConfig as JEngine
from ray_tpu.serve.decode_session import DecodeSessionCore as JCore
from ray_tpu.serve.prefix_cache import PrefixIndex as JIndex
from ray_tpu.util.device_profile import DispatchProfiler as JProfiler
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.exceptions import ReplicaUnavailableError as TUnavailable
from ray_tpu_torch.models import TransformerConfig as TConfig
from ray_tpu_torch.serve import DecodeEngineConfig as TEngine
from ray_tpu_torch.serve import DecodeSessionCore as TCore
from ray_tpu_torch.serve import PrefixIndex as TIndex
from ray_tpu_torch.util.device_profile import DispatchProfiler as TProfiler

MAX_LEN = 64
WAIT_S = 60.0


def _reply_before_admission(jcore):
    """Hold each JAX engine session out of the slots until its start
    reply has been read.  The JAX engine's reply reads the session's
    latest token, and under load the loop can decode past the first one
    before the caller wakes (ROADMAP queue 3); admission timing changes no
    stream, so this guards the comparison without changing what it
    compares."""
    eng = jcore.engine
    replied = set()
    start, admit = eng.start, eng._admit_locked

    def start_then_release(*args, **kwargs):
        out = start(*args, **kwargs)
        with eng._cond:
            replied.add(out["sid"])
            eng._cond.notify_all()
        return out

    def admit_replied():
        held = [s for s in eng._pending if s.sid not in replied]
        eng._pending = [s for s in eng._pending if s.sid in replied]
        try:
            return admit()
        finally:
            eng._pending = held + eng._pending

    eng.start = start_then_release
    eng._admit_locked = admit_replied
    return jcore


def _jax_core(cfg, params, **kw):
    return _reply_before_admission(JCore(cfg, max_len=MAX_LEN, params=params,
                                         **kw))


@pytest.fixture(scope="module")
def twins():
    jcfg = JConfig.tiny(max_seq_len=MAX_LEN, attention_impl="reference",
                        dtype=jnp.float32)
    tcfg = TConfig.tiny(max_seq_len=MAX_LEN, dtype=torch.float32)
    jparams, _ = jinit(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def make_pair(twins):
    """make_pair(key, **engine_kwargs) -> (jax core, port core), one pair
    per key for the whole module; every engine is shut down at the end."""
    jcfg, jparams, tcfg, tparams = twins
    pairs = {}

    def make(key, **engine_kw):
        if key not in pairs:
            pairs[key] = (
                _jax_core(jcfg, jparams, engine=JEngine(**engine_kw)),
                TCore(tcfg, max_len=MAX_LEN, params=tparams,
                      engine=TEngine(**engine_kw), device="cpu"))
        return pairs[key]

    yield make
    for pair in pairs.values():
        for core in pair:
            if core._engine is not None:
                core._engine.shutdown()
    for pair in pairs.values():
        for core in pair:
            if core._engine is not None and core._engine._thread:
                core._engine._thread.join(timeout=10)
                assert not core._engine._thread.is_alive()


def _drain(core, sid, toks, want):
    deadline = time.monotonic() + WAIT_S
    while len(toks) < want:
        assert time.monotonic() < deadline, "stream stalled"
        out = core.handle({"op": "next_chunk", "sid": sid,
                           "max_tokens": want - len(toks)})
        assert "error" not in out, out
        toks += out["tokens"]
    return toks


def _stream(core, prompt, want):
    r = core.handle({"op": "start", "prompt": prompt})
    toks = _drain(core, r["sid"], list(r["token"]), want)
    core.handle({"op": "end", "sid": r["sid"]})
    return toks


def _until(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _stats(core):
    return core.handle({"op": "stats"})["engine"]


def _both(pair, fn):
    """fn(core) on the JAX core, then on the port's; → (jax, port)."""
    return fn(pair[0]), fn(pair[1])


# --------------------------------------------------- continuous batching

def _join_leave(core):
    """Staggered joins: s0 decodes alone, s1 joins, s2 joins, s0 leaves,
    s3 joins last (test_serve_decode_engine.py:71)."""
    prompts = [list(range(10)), [5, 6, 7], [9] * 12, [1, 2]]
    want = 12
    r0 = core.handle({"op": "start", "prompt": prompts[0]})
    s0 = _drain(core, r0["sid"], list(r0["token"]), 6)
    r1 = core.handle({"op": "start", "prompt": prompts[1]})
    s1 = _drain(core, r1["sid"], list(r1["token"]), 4)
    r2 = core.handle({"op": "start", "prompt": prompts[2]})
    s2 = list(r2["token"])
    s0 = _drain(core, r0["sid"], s0, want)
    assert core.handle({"op": "end", "sid": r0["sid"]})["ended"]
    r3 = core.handle({"op": "start", "prompt": prompts[3]})
    s3 = list(r3["token"])
    for r, toks in ((r1, s1), (r2, s2), (r3, s3)):
        _drain(core, r["sid"], toks, want)
        core.handle({"op": "end", "sid": r["sid"]})
    return [s0, s1, s2, s3]


def test_engine_mid_stream_join_and_leave_match_jax(make_pair):
    pair = make_pair("default")
    jout, tout = _both(pair, _join_leave)
    assert tout == jout
    st = _stats(pair[1])
    assert st["tokens"] >= 4 * 11 and st["steps"] < 4 * 11   # batched
    assert st["graph_replays"] == 0                          # the CPU: eager


def test_engine_is_the_default_and_streams_match_the_eager_core(twins):
    """engine=True is the default, as in the JAX package; its streams are
    the engine=False core's."""
    _, _, tcfg, tparams = twins
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    streams = []
    for engine in (True, False):
        core = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu",
                     **({} if engine else {"engine": False}))
        streams.append(_stream(core, prompt, 10))
        if engine:
            assert core._engine is not None
            core._engine.shutdown()
        else:
            assert core._engine is None
    assert streams[0] == streams[1]


class _SlowWake(threading.Condition):
    """A condition whose waiters, other than the engine's thread, give up
    the lock for a while after each wake: the loop then admits and steps
    a session before its `start` caller reads the reply."""

    def wait(self, timeout=None):
        woke = super().wait(timeout)
        if not threading.current_thread().name.startswith("decode-engine"):
            self.release()
            time.sleep(0.05)
            self.acquire()
        return woke


def test_start_replies_with_the_prefill_token_however_late_it_wakes(twins):
    """The start reply carries the token the prefill gave, even when the
    loop has decoded past it before the caller wakes (the JAX engine
    replies with the session's latest token there, ROADMAP queue 3)."""
    _, _, tcfg, tparams = twins
    prompt = list(range(10))
    eager = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu",
                  engine=False)
    want = _stream(eager, prompt, 8)
    core = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu")
    core.engine._cond = _SlowWake()
    try:
        r = core.handle({"op": "start", "prompt": prompt})
        assert _stats(core)["steps"] >= 1     # the loop ran ahead
        assert _drain(core, r["sid"], list(r["token"]), 8) == want
    finally:
        core.engine.shutdown()


def _backpressure(core, unavailable):
    """Slot reclamation, backpressure and LRU (test_serve_decode_engine.py
    :123).  → the tokens seen, for the cross-package comparison."""
    seen = []
    a = core.handle({"op": "start", "prompt": [1, 2, 3]})
    b = core.handle({"op": "start", "prompt": [4, 5, 6]})
    seen += a["token"] + b["token"]
    _until(lambda: _stats(core)["occupied_slots"] == 2)
    with pytest.raises(unavailable):
        core.handle({"op": "start", "prompt": [7, 8]})
    assert core.handle({"op": "end", "sid": a["sid"]})["ended"]
    c = None
    deadline = time.monotonic() + WAIT_S
    while c is None:
        assert time.monotonic() < deadline, "the freed slot was never granted"
        try:
            c = core.handle({"op": "start", "prompt": [7, 8]})
        except unavailable:
            time.sleep(0.01)
    seen += _drain(core, c["sid"], list(c["token"]), 4)
    assert "error" in core.handle({"op": "next", "sid": a["sid"]})
    # LRU: b was abandoned; un-pin the queue bound so it runs to the
    # cache's end (its slot is then reclaimed), then push the session
    # table past max_sessions: the abandoned finished session is evicted
    eng = core.engine
    eng.ecfg.token_queue_depth = 64
    with eng._cond:
        eng._cond.notify_all()
    _until(lambda: _stats(core)["occupied_slots"] <= 1)
    eng.ecfg.max_waiting = 2
    for i in range(3):
        seen += core.handle({"op": "start", "prompt": [i + 1]})["token"]
    assert "error" in core.handle({"op": "next_chunk", "sid": b["sid"]})
    assert _stats(core)["sessions"] <= 4
    return seen


def test_engine_backpressure_slot_reclamation_and_lru_match_jax(twins):
    jcfg, jparams, tcfg, tparams = twins
    kw = dict(max_slots=2, max_waiting=0, token_queue_depth=4)
    jcore = _jax_core(jcfg, jparams, max_sessions=4, engine=JEngine(**kw))
    tcore = TCore(tcfg, max_len=MAX_LEN, params=tparams, max_sessions=4,
                  engine=TEngine(**kw), device="cpu")
    try:
        assert _backpressure(tcore, TUnavailable) == \
            _backpressure(jcore, JUnavailable)
    finally:
        jcore.engine.shutdown()
        tcore.engine.shutdown()


def test_replica_unavailable_error_matches_jax():
    t, j = TUnavailable("decode", 2.5), JUnavailable("decode", 2.5)
    assert (t.deployment, t.retry_after_s, str(t)) == \
        (j.deployment, j.retry_after_s, str(j))


# ------------------------------------------------ chunked-prefill admission

def _chunk_boundaries(core):
    """Prompts below, at and above the chunk of 4, one joining while
    another streams (test_serve_spec_decode.py:155)."""
    want = 10
    prompts = [[5, 6, 7], [1, 2, 3, 4], [9, 8, 7, 6, 5], [3] * 8, [4] * 9]
    r0 = core.handle({"op": "start", "prompt": prompts[0]})
    s0 = _drain(core, r0["sid"], list(r0["token"]), 5)
    mids = [core.handle({"op": "start", "prompt": p}) for p in prompts[1:]]
    outs = [_drain(core, r["sid"], list(r["token"]), want) for r in mids]
    s0 = _drain(core, r0["sid"], s0, want)
    for r in (r0, *mids):
        core.handle({"op": "end", "sid": r["sid"]})
    return [s0] + outs


def _resume_shapes(core):
    """A resume mid-stream (two chunk blocks, four tail steps) continues
    the stream and adds no chunk shape (test_serve_spec_decode.py:191)."""
    prompt = [5, 6, 7, 8, 9]
    ref = _stream(core, prompt, 10)
    before = set(_stats(core)["program_shapes"])
    rr = core.handle({"op": "resume", "prompt": prompt,
                      "generated": ref[:7]})
    assert rr["seq"] == 7
    toks = _drain(core, rr["sid"], ref[:7] + list(rr["token"]), 10)
    core.handle({"op": "end", "sid": rr["sid"]})
    assert toks == ref
    new = {s for s in set(_stats(core)["program_shapes"]) - before
           if s.startswith("prefill_chunk")}
    assert not new, f"resume ran new chunk shapes: {new}"
    return toks


def test_chunked_admission_and_resume_match_jax(make_pair):
    pair = make_pair("chunk4", prefill_chunk_tokens=4)
    jout, tout = _both(pair, _chunk_boundaries)
    assert tout == jout
    st = _stats(pair[1])
    assert st["prefill_chunks"] >= 5
    shapes = [s for s in st["program_shapes"] if s.startswith("prefill")]
    assert sorted(shapes) == ["prefill_chunk:1x1", "prefill_chunk:1x4"]
    jout, tout = _both(pair, _resume_shapes)
    assert tout == jout


# --------------------------------------------------- speculative decoding

def _to_the_end(core, prompt):
    """One session drained until the cache is full: its iterations, and
    so what it adds to the speculation counters, do not depend on timing.
    → (tokens, counters added, spec disabled)."""
    keys = ("proposed", "accepted", "fallbacks")
    # ended sessions leave their slot at the loop's next turn, after the
    # last step that counted them
    _until(lambda: _stats(core)["occupied_slots"] == 0)
    before = _stats(core)["spec"]
    r = core.handle({"op": "start", "prompt": prompt})
    toks = list(r["token"])
    while True:
        out = core.handle({"op": "next_chunk", "sid": r["sid"],
                           "max_tokens": 64})
        assert "error" not in out, out
        toks += out["tokens"]
        if out["done"]:
            break
    core.handle({"op": "end", "sid": r["sid"]})
    after = _stats(core)["spec"]
    return toks, [after[k] - before[k] for k in keys], after["disabled"]


def test_spec_decode_shared_draft_matches_jax(make_pair):
    """Self-speculation (test_serve_spec_decode.py:227): streams, and the
    counters of a session run to the cache's end, equal the JAX
    engine's."""
    pair = make_pair("spec-shared", spec_draft="shared", spec_k=4)
    prompts = [[5, 6, 7], list(range(10)), [9] * 6]

    def run(core):
        rs = [core.handle({"op": "start", "prompt": p}) for p in prompts]
        outs = [_drain(core, r["sid"], list(r["token"]), 16) for r in rs]
        for r in rs:
            core.handle({"op": "end", "sid": r["sid"]})
        return outs

    jout, tout = _both(pair, run)
    assert tout == jout
    j1, t1 = _both(pair, lambda core: _to_the_end(core, [2, 7, 1, 8]))
    assert t1[0] == j1[0] and len(t1[0]) == MAX_LEN - 4 + 1
    assert t1[1:] == j1[1:]
    proposed, accepted, fallbacks = t1[1]
    assert accepted >= 0.9 * proposed and fallbacks == 0 and not t1[2]


def _moe_streams(core):
    """A 40-token prompt (a 32-token admission chunk, then 1-token tails),
    a 5-token one and a 33-token one, started together, 12 tokens each."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (40, 5, 33)]
    starts = [core.handle({"op": "start", "prompt": p}) for p in prompts]
    out = [_drain(core, r["sid"], list(r["token"]), 12) for r in starts]
    for r in starts:
        core.handle({"op": "end", "sid": r["sid"]})
    return out


def test_moe_engine_streams_match_jax():
    """A mixture-of-experts model (4 experts, top 2, capacity factor 0.5,
    so a 32-token admission chunk drops tokens that a decode step keeps)
    through both engines, plain and speculating with a shared draft:
    streams identical."""
    moe = dict(max_seq_len=MAX_LEN, n_experts=4, expert_top_k=2,
               capacity_factor=0.5)
    jcfg = JConfig.tiny(attention_impl="reference", dtype=jnp.float32, **moe)
    tcfg = TConfig.tiny(dtype=torch.float32, **moe)
    jparams = jax.jit(lambda key: jinit(key, jcfg)[0])(jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    cores = []
    try:
        for engine_kw in ({}, dict(spec_draft="shared", spec_k=4)):
            pair = (_jax_core(jcfg, jparams, engine=JEngine(**engine_kw)),
                    TCore(tcfg, max_len=MAX_LEN, params=tparams,
                          engine=TEngine(**engine_kw), device="cpu"))
            cores += pair
            jout, tout = _both(pair, _moe_streams)
            assert tout == jout
        assert _stats(pair[1])["spec"]["proposed"] > 0
    finally:
        for core in cores:
            core._engine.shutdown()
        for core in cores:
            core._engine._thread.join(timeout=10)
            assert not core._engine._thread.is_alive()


def test_spec_decode_random_draft_matches_jax(make_pair, twins):
    """A bad draft (an untrained 1-layer model) slows a stream but never
    changes it (test_serve_spec_decode.py:254).  The draft's weights are
    the JAX init's, carried over, so the acceptance counts match too."""
    jdraft = JConfig.tiny(max_seq_len=MAX_LEN, attention_impl="reference",
                          dtype=jnp.float32, n_layers=1)
    tdraft = TConfig.tiny(max_seq_len=MAX_LEN, dtype=torch.float32,
                          n_layers=1)
    jdp, _ = jinit(jax.random.PRNGKey(0), jdraft)
    tdp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jdp), tdraft,
                            "cpu")
    jcfg, jparams, tcfg, tparams = twins
    jcore = _jax_core(jcfg, jparams,
                      engine=JEngine(spec_draft=(jdraft, jdp), spec_k=3))
    tcore = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu",
                  engine=TEngine(spec_draft=(tdraft, tdp), spec_k=3))
    plain = make_pair("default")
    try:
        for prompt in ([5, 6, 7], [1, 2]):
            want = _stream(plain[0], prompt, 12)
            assert _stream(tcore, prompt, 12) == want
            assert _stream(jcore, prompt, 12) == want
        prompt = list(range(40))
        j1, t1 = _to_the_end(jcore, prompt), _to_the_end(tcore, prompt)
        assert t1 == j1
        assert t1[1][0] > 0 and t1[1][2] == 0
    finally:
        jcore.engine.shutdown()
        tcore.engine.shutdown()


def test_resume_into_a_speculating_engine_matches_jax(make_pair):
    """Failover replay into an engine that chunks and speculates, cut
    mid-chunk and mid-speculation (test_serve_spec_decode.py:277)."""
    pair = make_pair("chunk4-spec", prefill_chunk_tokens=4,
                     spec_draft="shared", spec_k=4)
    prompt = [5, 6, 7]
    ref = _stream(make_pair("default")[0], prompt, 16)

    def run(core):
        outs = []
        for cut in (1, 6, 11):
            rr = core.handle({"op": "resume", "prompt": prompt,
                              "generated": ref[:cut]})
            assert "error" not in rr and rr["seq"] == cut
            toks = _drain(core, rr["sid"], ref[:cut] + list(rr["token"]),
                          16)
            core.handle({"op": "end", "sid": rr["sid"]})
            outs.append(toks)
        return outs

    jout, tout = _both(pair, run)
    assert tout == jout == [ref] * 3


def _failing_verify(fail_calls):
    """A stand-in for the verify function that raises on the listed calls
    (1-based) and otherwise verifies: the port's counterpart of the JAX
    package's chaos site serve.spec_verify."""
    from ray_tpu_torch.models import verify_step_slots
    calls = []

    def verify(*args, **kwargs):
        calls.append(1)
        if fail_calls is None or len(calls) in fail_calls:
            raise RuntimeError("injected verify failure")
        return verify_step_slots(*args, **kwargs)

    return verify


@pytest.mark.parametrize("fail_calls,fallbacks,disabled",
                         [(None, 3, True), ({2}, 1, False)])
def test_a_failing_verify_degrades_to_plain_decode(make_pair, twins,
                                                   fail_calls, fallbacks,
                                                   disabled):
    """A verify that raises falls back to a plain step that iteration; a
    persistent fault disables speculation after spec_fail_disable strikes
    (test_serve_spec_decode.py:317).  The stream never changes."""
    _, _, tcfg, tparams = twins
    prompt = [5, 6, 7]
    ref = _stream(make_pair("default")[0], prompt, 16)
    core = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu",
                 engine=TEngine(spec_draft="shared", spec_k=4,
                                spec_fail_disable=3))
    core.engine._verify = _failing_verify(fail_calls)
    try:
        assert _stream(core, prompt, 16) == ref
        spec = _stats(core)["spec"]
        assert spec["fallbacks"] == fallbacks
        assert spec["disabled"] is disabled
    finally:
        core.engine.shutdown()


@pytest.mark.parametrize("match,action,fallbacks,disabled", [
    ({}, "error", 3, True), ({"nth": 2}, "error", 1, False),
    ({}, "delay", 0, False)])
def test_the_chaos_site_degrades_to_plain_decode(make_pair, twins, match,
                                                 action, fallbacks,
                                                 disabled):
    """The chaos site serve.spec_verify armed as the JAX package's test
    arms it (test_serve_spec_decode.py:317): ``error`` on every
    iteration falls back to plain steps until speculation is disabled, on
    the second iteration only for that one; ``delay`` slows every
    speculative iteration by ``delay_s``.  The stream never changes.  The
    rule matches this engine's name only, so the module's other engines
    never meet it."""
    from ray_tpu_torch.util import fault_injection as fi
    from ray_tpu_torch.util import tracing
    _, _, tcfg, tparams = twins
    prompt = [5, 6, 7]
    ref = _stream(make_pair("default")[0], prompt, 16)
    core = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu",
                 engine=TEngine(spec_draft="shared", spec_k=4,
                                spec_fail_disable=3))
    core.engine.name = f"chaos-{action}-{len(match)}"
    fi.arm([{"site": "serve.spec_verify", "action": action, "delay_s": 0.02,
             "match": dict(match, regex=f"^{core.engine.name}$")}])
    try:
        assert _stream(core, prompt, 16) == ref
        # the ended session leaves its slot after the last iteration that
        # counted it: the counters and spans are then settled
        _until(lambda: _stats(core)["occupied_slots"] == 0)
        spec = _stats(core)["spec"]
        fired = fi.injected_counts().get(f"serve.spec_verify|{action}", 0)
        verified = [e for e in tracing.span_events() if e["name"] ==
                    f"serve_spec_verify::{core.engine.name}"]
    finally:
        fi.disarm()
        core.engine.shutdown()
    assert spec["fallbacks"] == fallbacks
    assert spec["disabled"] is disabled
    if action == "delay":
        assert fired == len(verified) > 0
        assert all(e["dur"] >= 0.02e6 for e in verified)
    else:
        assert fired == fallbacks


# ------------------------------------------------------------- the rest

def _prefix_hit(core):
    """A donor holds a slot; a prompt sharing 12 of its tokens is seeded
    from it and prefills only its suffix."""
    donor_prompt = list(range(20, 40))
    r = core.handle({"op": "start", "prompt": donor_prompt})
    _until(lambda: core.engine.sessions[r["sid"]].slot is not None)
    before = _stats(core)["prefix"]["applied_hits"]
    toks = _stream(core, donor_prompt[:12] + [99, 98, 97], 12)
    hits = _stats(core)["prefix"]["applied_hits"] - before
    core.handle({"op": "end", "sid": r["sid"]})
    return toks, hits


def test_a_prefix_hit_gives_the_cold_stream(make_pair, twins):
    _, _, tcfg, tparams = twins
    (jtoks, jhits), (ttoks, thits) = _both(make_pair("default"), _prefix_hit)
    assert ttoks == jtoks and thits == jhits == 1
    cold = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu",
                 engine=TEngine(prefix_cache=False))
    try:
        assert _stream(cold, list(range(20, 32)) + [99, 98, 97], 12) == \
            ttoks
    finally:
        cold.engine.shutdown()


def _group(core):
    """B = 2 prompts: each row an engine session behind one group sid."""
    r = core.handle({"op": "start", "prompt": [[1, 2, 3, 4], [9, 8, 7, 6]]})
    assert r["sid"].startswith("grp:") and len(r["token"]) == 2
    out = [r["token"]]
    out.append(core.handle({"op": "next", "sid": r["sid"]})["token"])
    out.append(core.handle({"op": "next_chunk", "sid": r["sid"]})["tokens"])
    assert core.handle({"op": "stats"})["groups"] == 1
    assert core.handle({"op": "end", "sid": r["sid"]}) == {"ended": True}
    assert "error" in core.handle({"op": "next", "sid": r["sid"]})
    return out


def test_group_start_matches_jax(make_pair):
    jout, tout = _both(make_pair("default"), _group)
    assert tout == jout


def _next_to_the_end(core):
    """`next` on an engine sid, one token a call, until the cache is full:
    the last token carries eos, and a `next` after it is an error."""
    r = core.handle({"op": "start", "prompt": list(range(56))})
    out, last = [r["token"]], {}
    for _ in range(MAX_LEN):
        last = core.handle({"op": "next", "sid": r["sid"]})
        if "error" in last:
            break
        out.append(last["token"])
        if last.get("eos"):
            out.append("eos")
    core.handle({"op": "end", "sid": r["sid"]})
    return out, "finished" in last.get("error", "")


def test_next_until_the_cache_is_full_matches_jax(make_pair):
    jout, tout = _both(make_pair("default"), _next_to_the_end)
    assert tout == jout and tout[1] and tout[0][-1] == "eos"


def _drain_handoff(core, unavailable):
    """begin_drain: buffered tokens are still delivered, flagged
    `migrating`, and new starts are shed."""
    r = core.handle({"op": "start", "prompt": [3, 3, 4]})
    first = _drain(core, r["sid"], list(r["token"]), 4)
    live = core.engine.begin_drain()
    out = core.handle({"op": "next_chunk", "sid": r["sid"],
                       "max_tokens": 4})
    with pytest.raises(unavailable):
        core.handle({"op": "start", "prompt": [1, 2]})
    assert "error" in core.handle({"op": "next_chunk", "sid": r["sid"]})
    return live, out["migrating"], first, core.engine.live_sessions()


def test_begin_drain_hands_sessions_off_as_jax(twins):
    jcfg, jparams, tcfg, tparams = twins
    jcore = _jax_core(jcfg, jparams, engine=JEngine(token_queue_depth=4))
    tcore = TCore(tcfg, max_len=MAX_LEN, params=tparams, device="cpu",
                  engine=TEngine(token_queue_depth=4))
    try:
        jout = _drain_handoff(jcore, JUnavailable)
        assert _drain_handoff(tcore, TUnavailable) == jout
        assert jout[:2] == (1, True)
    finally:
        jcore.engine.shutdown()
        tcore.engine.shutdown()


def test_concurrent_clients_match_jax(make_pair):
    """Six sessions started and drained from their own threads at once:
    each stream equals the JAX engine's for the same prompt."""
    pair = make_pair("default")
    prompts = [list(range(s, s + 3 + 5 * s)) for s in range(6)]

    def run(core):
        outs = [None] * len(prompts)

        def client(i):
            outs[i] = _stream(core, prompts[i], 14)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        return outs

    jout, tout = _both(pair, run)
    assert tout == jout


# --------------------------------------------- host-side twins of the engine

def _index_ops(index):
    out = []
    index.insert([1, 2, 3, 4], "a")
    index.insert([1, 2, 9], "b")
    index.insert([7, 7], "c")
    out.append(index.longest_match([1, 2, 3, 4, 5]))
    out.append(index.longest_match([1, 2, 3, 4, 5], cap=3))
    out.append(index.longest_match([1, 2, 9, 9]))
    out.append(index.longest_match([5]))
    index.insert([1, 2], "a")          # an owner holds one key
    out.append(index.key_of("a"))
    out.append(index.evict("b"))
    out.append(index.evict("b"))
    out.append(index.longest_match([1, 2, 9]))
    out.append(sorted(index.owners()))
    out.append(len(index))
    out.append(index.stats())
    return out


def test_prefix_index_matches_jax():
    assert _index_ops(TIndex()) == _index_ops(JIndex())


def test_prefix_index_empty_keys_and_pruning_match_jax():
    """An empty key holds nothing; evicting the last owner of a branch
    prunes it, so a later lookup misses."""
    def ops(index):
        index.insert([], "e")
        index.insert([4, 5, 6], "x")
        out = [index.key_of("e"), index.longest_match([4, 5])]
        index.evict("x")
        out += [index.longest_match([4, 5]), len(index), index.stats()]
        return out

    assert ops(TIndex()) == ops(JIndex())


def _profile_ops(prof):
    """The same dispatches through both profilers: everything but time."""
    prog = prof.wrap("decode_step", lambda x, cfg=None: x)
    again = prof.wrap("decode_step", prog)          # idempotent re-wrap
    for n in (4, 4, 4, 8, 4, 4, 4, 4, 4, 4, 4, 4):
        again(np.zeros(n), cfg="c")
    prof.note_tokens("decode_step", 48)
    prof.note_tokens("decode_step", 0)
    prof.set_flops_per_token("decode_step", 1e6)
    prof.set_flops_per_token("cache_insert", 0.0)
    prof.wrap("cache_insert", lambda: None)()
    rows = prof.snapshot(peak=1e12)
    keep = ("program", "dispatches", "compiles", "shapes", "tokens")
    return ([{k: r[k] for k in keep} for r in rows],
            [r["mfu"] is None for r in rows],
            sorted(prof.wall_seconds()))


def test_dispatch_profiler_matches_jax():
    """Both sample every 10th dispatch (the JAX package's default)."""
    assert _profile_ops(TProfiler()) == _profile_ops(JProfiler())
    samples = TProfiler()
    _profile_ops(samples)
    assert samples._stats["decode_step"].sampled_n == 1   # dispatch 10


def test_peak_flops_by_device_name(monkeypatch):
    from ray_tpu_torch.util.device_profile import peak_flops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert peak_flops() == 2e11          # the JAX package's CPU figure
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert peak_flops() == 989e12
