"""The port's metrics, trace spans and chaos layer against the JAX
package's, and the decode engine's use of them, on the CPU.

The metric registry (`ray_tpu_torch.metrics`), the serve series
(`core.runtime_metrics`), the process-local tracing (`util.tracing`) and
the fault plan (`util.fault_injection`) are host code copied from the JAX
package: the same calls must give the same exposition lines, the same span
records, the same fire sequences and the same plan lint.  The engine's
counters must equal its `stats()` (as `test_serve_spec_decode.py:359` and
`test_serve_decode_engine.py:433` check in the JAX package).
"""

import time

import pytest
import torch

from ray_tpu import metrics as jmetrics
from ray_tpu.core import runtime_metrics as jseries
from ray_tpu.util import fault_injection as jfi
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch import metrics as tmetrics
from ray_tpu_torch.core import runtime_metrics as tseries
from ray_tpu_torch.util import fault_injection as tfi
from ray_tpu_torch.util import tracing as ttracing

WAIT_S = 60.0


def _lines(text, name):
    return [ln for ln in text.splitlines()
            if ln.split("{")[0].split(" ")[0] in
            (name, f"{name}_bucket", f"{name}_sum", f"{name}_count")
            or ln.startswith((f"# HELP {name} ", f"# TYPE {name} "))]


def _feed(mod, kind, name):
    if kind == "counter":
        m = mod.Counter(name, "a test counter", ("deployment", "phase"))
        m.inc(tags={"deployment": "d", "phase": "p"})
        m.inc(2.5, tags={"deployment": "d"})
    elif kind == "gauge":
        m = mod.Gauge(name, "a test gauge", ("deployment",))
        m.set(3, {"deployment": "a"})
        m.set(0.25, {"deployment": "b"})
    else:
        m = mod.Histogram(name, "a test histogram", (0.5, 1.0, 4.0),
                          ("deployment",))
        for v in (0.1, 0.5, 2.0, 9.0):
            m.observe(v, {"deployment": "d"})
        m.observe(1.0, {"deployment": "e"})


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_a_metric_renders_to_the_same_lines(kind):
    name = f"ray_tpu_port_parity_{kind}"
    _feed(jmetrics, kind, name)
    _feed(tmetrics, kind, name)
    want = _lines(jmetrics.prometheus_text(), name)
    assert len(want) > 3
    assert _lines(tmetrics.prometheus_text(), name) == want


@pytest.mark.parametrize("series", [
    "SERVE_TOKENS", "SERVE_PREFILL_CHUNKS", "SERVE_PREFIX_HITS",
    "SERVE_PREFIX_TOKENS_REUSED", "SERVE_SPEC_PROPOSED",
    "SERVE_SPEC_ACCEPTED", "SERVE_DECODE_OCCUPANCY",
    "SERVE_SPEC_ACCEPTANCE"])
def test_the_serve_series_are_the_jax_packages(series):
    j, t = getattr(jseries, series), getattr(tseries, series)
    assert (t.name, t.description, t.tag_keys, t.kind) == \
        (j.name, j.description, j.tag_keys, j.kind)
    assert getattr(t, "boundaries", None) == getattr(j, "boundaries", None)


# -- tracing -----------------------------------------------------------------

def test_a_span_is_recorded_as_the_jax_package_records_it():
    for mod in (jtracing, ttracing):
        mod.record_span("serve_decode_step::parity", "serve", 100.0,
                        100.25, batch=3, deployment="parity", empty="")
    jev, tev = jtracing.span_events()[-1], ttracing.span_events()[-1]
    assert tev == jev
    assert tev["args"] == {"batch": 3, "deployment": "parity"}
    with ttracing.span("ctx", "test", k=1):
        pass
    assert ttracing.span_events()[-1]["name"] == "ctx"


def test_the_span_buffer_is_bounded_and_can_be_off(monkeypatch):
    monkeypatch.setattr(ttracing, "_spans", None)
    monkeypatch.setattr(ttracing, "TRACE_BUFFER_SIZE", 20)
    for i in range(30):
        ttracing.record_span(f"s{i}", "t", 0.0, 1.0)
    names = [e["name"] for e in ttracing.span_events()]
    assert names == [f"s{i}" for i in range(10, 30)]
    monkeypatch.setattr(ttracing, "TRACE_ENABLED", False)
    ttracing.record_span("off", "t", 0.0, 1.0)
    assert ttracing.span_events()[-1]["name"] == "s29"


def test_profile_events_and_the_chrome_dump(tmp_path):
    import json
    with ttracing.profile("local", "task"):
        pass
    ev = ttracing.chrome_trace_events()[-1]
    assert ev["name"] == "local" and ev["ph"] == "X" and ev["dur"] >= 0
    path = tmp_path / "trace.json"
    ttracing.dump_chrome_trace(str(path))
    assert json.loads(path.read_text())["traceEvents"][-1] == ev


# -- the fault plan ----------------------------------------------------------

PLANS = [
    [{"site": "serve.spec_verify", "action": "error"}],
    [{"site": "serve.spec_verify", "action": "error", "match": {"nth": 2}}],
    [{"site": "serve.spec_verify", "action": "error",
      "match": {"nth": [1, 4, 5]}}],
    [{"site": "serve.spec_verify", "action": "delay", "delay_s": 0.0,
      "match": {"prob": 0.3, "seed": 7}}],
    [{"site": "serve.spec_verify", "action": "error",
      "match": {"regex": "^b"}, "max_fires": 2}],
    [{"site": "serve.spec_verify", "action": "error", "once": True}],
    [{"site": "serve.spec_verify", "action": "error", "proc": "worker"}],
    [{"site": "rpc.send", "action": "drop", "match": {"peer": "ab"}},
     {"site": "serve.spec_verify", "action": "fail", "id": "x",
      "match": {"nth": 3}}],
]


@pytest.mark.parametrize("plan", PLANS)
def test_a_plan_fires_where_the_jax_packages_fires(plan):
    keys = ["a", "b", "ab", "b1", "c"] * 4
    fired = []
    for fi in (jfi, tfi):
        fp = fi.FaultPlan(plan)
        fired.append([fp.point("serve.spec_verify", k) for k in keys]
                     + [fp.point("rpc.send", "x", peer=p)
                        for p in ("ab", "cd")])
    assert fired[1] == fired[0]
    assert any(fired[1]) == (plan[0].get("proc") is None)


BAD_PLANS = [
    {"site": "serve.spec_verify"},
    [{"site": "serve.spec_verfy", "action": "error"}],
    [{"site": "serve.spec_verify", "action": "drop"}],
    [{"site": "serve.spec_verify", "action": "error", "colour": 1}],
    [{"site": "serve.spec_verify", "action": "error",
      "match": {"nth": 2, "prob": 0.5}}],
    [{"site": "serve.spec_verify", "action": "error",
      "match": {"nth": "2", "regex": "("}}],
    [{"site": "serve.spec_verify", "action": "error",
      "match": {"prob": 1.5, "peer": "["}}],
    [{"site": "serve.spec_verify", "action": "delay", "delay_s": -1}],
    [{"site": "serve.spec_verify", "action": "error", "max_fires": 0}],
    [{"site": "serve.spec_verify", "action": "error", "once": True,
      "max_fires": 2}],
    [{"site": "serve.spec_verify", "action": "error", "id": "a"},
     {"site": "serve.spec_verify", "action": "error", "id": "a"}, 3],
    [{"action": "error", "match": []}],
]


@pytest.mark.parametrize("plan", PLANS + BAD_PLANS)
def test_a_plan_lints_as_the_jax_package_lints_it(plan):
    issues = tfi.validate_plan(plan)
    assert issues == jfi.validate_plan(plan)
    assert bool(issues) == (plan in BAD_PLANS)


def test_arming_registers_the_injection_counter_and_disarming_drops_it():
    name = tfi.METRIC_NAME
    tfi.disarm()   # the plans above counted into a counter of their own
    try:
        fp = tfi.arm('[{"site": "serve.spec_verify", "action": "error"}]')
        assert tfi.ACTIVE is fp
        assert fp.point("serve.spec_verify", "k")["action"] == "error"
        assert fp.point("serve.spec_verify", "k")["rule_id"] == \
            "serve.spec_verify#0"
        tfi.count_injection("serve.spec_verify", "error")
        assert tfi.injected_counts() == {"serve.spec_verify|error": 3.0}
        assert f'{name}{{site="serve.spec_verify",action="error"}} 3.0' \
            in tmetrics.prometheus_text()
        chaos = [e for e in ttracing.span_events()
                 if e["name"] == "chaos::serve.spec_verify"]
        assert chaos[-1]["args"]["key"] == "k"
    finally:
        tfi.disarm()
    assert tfi.ACTIVE is None and tfi.injected_counts() == {}
    assert name not in tmetrics.prometheus_text()


# -- the engine --------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    from ray_tpu_torch.models import TransformerConfig, init_params
    cfg = TransformerConfig.tiny(max_seq_len=64, dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(3), "cpu")


def _until(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _drain(core, sid, toks, want):
    deadline = time.monotonic() + WAIT_S
    while len(toks) < want:
        assert time.monotonic() < deadline, "stream stalled"
        out = core.handle({"op": "next_chunk", "sid": sid,
                           "max_tokens": want - len(toks)})
        assert "error" not in out, out
        toks += out["tokens"]
    return toks


def _sample(text, name, deployment, suffix=""):
    line = f'{name}{suffix}{{deployment="{deployment}"}} '
    found = [ln for ln in text.splitlines() if ln.startswith(line)]
    assert len(found) == 1, (line, found)
    return float(found[0][len(line):])


def test_the_engine_feeds_the_serve_series_and_spans(tiny):
    """A speculating engine that chunks its prompts and seeds a sharer from
    a live slot's prefix: every serve series equals the engine's own count,
    and its spans carry the JAX engine's names."""
    from ray_tpu_torch.serve import DecodeEngineConfig, DecodeSessionCore
    cfg, params = tiny
    name = "obs-engine"
    core = DecodeSessionCore(cfg, max_len=64, params=params, device="cpu",
                             engine=DecodeEngineConfig(
                                 prefill_chunk_tokens=4, spec_draft="shared",
                                 spec_k=3))
    core.engine.name = name
    try:
        donor = list(range(20, 40))
        r = core.handle({"op": "start", "prompt": donor})
        _until(lambda: core.engine.sessions[r["sid"]].slot is not None)
        r2 = core.handle({"op": "start", "prompt": donor[:12] + [7, 8, 9]})
        for sid, first in ((r["sid"], r["token"]), (r2["sid"], r2["token"])):
            _drain(core, sid, list(first), 10)
            core.handle({"op": "end", "sid": sid})
        _until(lambda: core.handle({"op": "stats"})["engine"][
            "occupied_slots"] == 0)
        st = core.handle({"op": "stats"})["engine"]
    finally:
        core.engine.shutdown()
    text = tmetrics.prometheus_text()
    assert st["prefix"]["applied_hits"] == 1 and st["spec"]["proposed"] > 0
    for series, want in (
            ("ray_tpu_serve_tokens_total", st["tokens"]),
            ("ray_tpu_serve_prefill_chunks_total", st["prefill_chunks"]),
            ("ray_tpu_serve_prefix_hits_total", st["prefix"]["applied_hits"]),
            ("ray_tpu_serve_prefix_tokens_reused_total",
             st["prefix"]["tokens_reused"]),
            ("ray_tpu_serve_spec_tokens_proposed_total",
             st["spec"]["proposed"]),
            ("ray_tpu_serve_spec_tokens_accepted_total",
             st["spec"]["accepted"]),
            ("ray_tpu_serve_decode_batch_occupancy", st["steps"])):
        suffix = "_count" if series.endswith("occupancy") else ""
        assert _sample(text, series, name, suffix) == want, series
    assert _sample(text, "ray_tpu_serve_spec_acceptance_ratio", name) == \
        pytest.approx(st["spec"]["accepted"] / st["spec"]["proposed"])
    spans = [e for e in ttracing.span_events()
             if e["args"].get("deployment") == name]
    counts = {}
    for e in spans:
        kind = e["name"].split("::")[0]
        counts[kind] = counts.get(kind, 0) + 1
        assert e["name"] == f"{kind}::{name}" and e["cat"] == "serve"
    assert counts["serve_prefill_chunk"] == st["prefill_chunks"]
    assert counts["serve_admission"] == 2
    assert counts.get("serve_spec_verify", 0) + \
        counts.get("serve_decode_step", 0) == st["steps"]
    assert counts["serve_spec_verify"] > 0
    chunk = next(e for e in spans if e["name"].startswith(
        "serve_prefill_chunk"))
    assert chunk["args"]["tokens"] in (1, 4) and chunk["dur"] >= 0
