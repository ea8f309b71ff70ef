"""The port's serve gang (`ray_tpu_torch.serve.gang`) on the CPU: gang
members spawned on the port's actor layer over gloo (``device="cpu"``),
tiny fp32 models, weights placed under FSDP_TP_RULES over a tp=2 mesh.
tests/test_serve_gang.py's assertions, ported, and the gang's answers held
against the JAX package on the same numpy weights; the model's serving
entry points on placed weights, in process, bitwise the plain weights' and
against JAX's Pallas kernel in interpret mode; a sequence gap, a killed
follower, the chaos plan reaching spawned actors, the replica context.
The callables live in `torch_serve_gang_models.py`, which imports no JAX,
so the members never import this module."""

import functools
import importlib
import multiprocessing
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import torch_serve_gang_models as models
from ray_tpu.models import transformer as jtr
from ray_tpu_torch import parallel
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.core import actors
from ray_tpu_torch.exceptions import ActorDiedError, ReplicaUnavailableError
from ray_tpu_torch.models import params_axes
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.serve import gang
from ray_tpu_torch.util import fault_injection as tfi

# both packages export a function of the same name as their generate module
jgen = importlib.import_module("ray_tpu.models.generate")
tgen = importlib.import_module("ray_tpu_torch.models.generate")

GANG_TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_torch_models.py's fp32
# tests/test_serve_gang.py's model: tiny, reference attention, fp32
TINY = dict(max_seq_len=32, attention_impl="reference")
# head dim 64, so the port's forward and prefill take the flash path
FLASH = dict(d_model=128, n_heads=2, n_kv_heads=1, attention_impl="flash",
             max_seq_len=128)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def no_process_left():
    """Every test's gang and actors are gone by its end (children that
    were there before it, the module's gang among them, aside)."""
    before = set(multiprocessing.active_children())
    yield
    assert set(multiprocessing.active_children()) <= before


@functools.lru_cache(maxsize=None)
def _jax(kw_items):
    """(JAX config, JAX params, the params as a numpy tree) of the tiny
    fp32 model with ``kw``, from PRNGKey(0)."""
    kw = dict(kw_items)
    jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, **kw)
    jparams = jax.jit(lambda key: jtr.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.int32)


def _start(callable_cls, kw, rid, size=2, **cfg):
    entry = {"callable_blob": actors.dumps_function(callable_cls),
             "init_args": ("tiny", dict(kw, dtype=torch.float32),
                           _jax(tuple(kw.items()))[2]),
             "init_kwargs": {}}
    cfg = {"gang_size": size, "gang_mesh": f"tp={size}",
           "ray_actor_options": {"runtime_env": {"env_vars": {
               "OMP_NUM_THREADS": "1"}}}, **cfg}
    return gang.start_gang_replica("sharded_lm", rid, entry, cfg, **CPU)


@pytest.fixture(scope="module")
def served():
    """One tp=2 gang of `Generator` for the module (a spawn costs seconds;
    the last of its tests kills a member), stopped at the end."""
    t0 = time.monotonic()
    rep = _start(models.Generator, TINY, "r0", user_config={"k": 1})
    rep["start_s"] = time.monotonic() - t0
    yield rep
    gang.stop_gang_replica(rep)


def _ask(rep, *args, method=None, timeout=60.0):
    return actors.get(rep["handle"].handle_request.remote(args, {}, method),
                      timeout)


# -- the gang -----------------------------------------------------------------

def test_gang_forward_matches_jax_and_answers_from_the_leader(served):
    jcfg, jparams, _ = _jax(tuple(TINY.items()))
    tokens = np.arange(8, dtype=np.int32).reshape(1, 8) % 50
    want = np.asarray(jax.jit(jtr.forward, static_argnums=2)(
        jparams, tokens, jcfg))
    got = _ask(served, tokens, method="logits")
    np.testing.assert_allclose(got, want, **GANG_TOL)

    out = _ask(served, tokens, method="forward")
    assert out["rank"] == 0, "the gang must answer from its leader"
    assert out["shape"] == [1, 8, 256] and np.isfinite(out["mean"])
    assert out["argmax_last"] == [int(want[0, -1].argmax())]
    # the same request through the same gang program: bitwise the same
    again = _ask(served, tokens, method="forward")
    assert (again["mean"], again["checksum"]) == (out["mean"],
                                                  out["checksum"])
    # method routing reaches the leader's callable
    assert _ask(served, method="stats") == {"rank": 0, "world": 2}
    # the weights are placed over the gang's tp axis, not copied whole
    placed = _ask(served, method="placements")
    assert any("Shard" in p for p in placed["wq"])
    handle = served["handle"]
    st = actors.get(handle.stats.remote(), 30)
    assert st["rank"] == 0 and st["world_size"] == 2
    assert st["num_ongoing"] == 0 and st["total"] >= 5
    assert actors.get(handle.ready.remote(), 30) is True
    assert actors.get(handle.reconfigure.remote({"k": 2}), 30) is True
    assert served["pg"] is None and len(served["gang"]) == 2
    assert served["start_s"] < 60


def test_gang_generate_gives_jax_tokens(served):
    jcfg, jparams, _ = _jax(tuple(TINY.items()))
    prompt = _tokens((2, 6), seed=1)
    want = np.asarray(jgen.generate(jparams, prompt, cfg=jcfg,
                                    max_new_tokens=6))
    got = _ask(served, {"prompt": prompt, "n": 6})
    assert got["rank"] == 0
    np.testing.assert_array_equal(np.asarray(got["tokens"]), want)


def test_a_follower_that_sees_a_gap_raises_at_once(served):
    follower = served["gang"][1]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="gap in the gang's sequence"):
        actors.get(follower.participate.remote(10_000, (), {}, "stats"), 30)
    assert time.monotonic() - t0 < 5
    # the raise moved nothing: the gang still answers in order
    assert _ask(served, method="stats") == {"rank": 0, "world": 2}


def test_a_killed_follower_fails_the_next_request_then_every_later_one(
        served):
    """The module gang's last test: its follower SIGKILLed."""
    payload = {"prompt": _tokens((1, 4), seed=2), "n": 3}
    assert len(_ask(served, payload)["tokens"][0]) == 3
    follower = served["gang"][1]
    os.kill(follower.pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(ActorDiedError) as died:
        _ask(served, payload, timeout=30)
    assert time.monotonic() - t0 < 10
    assert died.value.pid == follower.pid
    assert died.value.exitcode == -signal.SIGKILL
    for _ in range(2):
        with pytest.raises(ReplicaUnavailableError):
            _ask(served, payload, timeout=5)
    gang.stop_gang_replica(served)
    assert not any(m.is_alive() for m in served["gang"])
    assert not set(multiprocessing.active_children()) & {
        m._proc for m in served["gang"]}


def test_gang_start_checks_its_strategy_and_device(monkeypatch):
    entry = {"callable_blob": actors.dumps_function(models.ShardedModel)}
    with pytest.raises(ValueError, match="PACK"):
        gang.start_gang_replica("d", "r", entry, {"gang_size": 2,
                                                  "gang_strategy": "SPREAD"},
                                **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gang.start_gang_replica("d", "r", entry, {"gang_size": 2})
    assert gang.get_gang_context() is None
    assert gang.serve_gang_ready_timeout_s == 300.0
    assert gang.serve_gang_stall_timeout_s == 600.0


# -- placed weights on the serving path, in process ---------------------------

@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank gloo mesh in this process, its group torn down after."""
    had = dist.is_initialized()
    mesh = parallel.create_mesh(parallel.MeshSpec(), device="cpu")
    yield mesh
    if not had:
        dist.destroy_process_group()


def test_placed_weights_serve_bitwise_and_match_jax_pallas(one_rank_mesh,
                                                           monkeypatch):
    """forward / prefill / prefill_chunk / decode_step / generate on
    DTensor-placed weights: bitwise the plain weights' results, and within
    tests/test_torch_models.py's fp32 bound of JAX with its Pallas kernel in
    interpret mode."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    jcfg, jparams, tree = _jax(tuple(FLASH.items()))
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, **FLASH)
    plain = params_from_numpy(tree, cfg, "cpu")
    placed = parallel.shard_pytree(plain, params_axes(cfg), one_rank_mesh,
                                   parallel.FSDP_TP_RULES)
    assert all(isinstance(w, DTensor)
               for w in ttr.param_leaves(placed))
    toks = _tokens((2, 32), seed=3)
    ttoks = torch.from_numpy(toks).long()

    def serve(params):
        logits = ttr.forward(params, ttoks, cfg)
        last, cache = tgen.prefill(params, ttoks, cfg,
                                   tgen.init_kv_cache(cfg, 2, 40, **CPU))
        nxt = last.argmax(-1)
        step, cache = tgen.decode_step(params, nxt, cache, cfg)
        chunk, cache = tgen.prefill_chunk(params, ttoks[:, :4], cache, cfg)
        gen = tgen.generate(params, toks, cfg=cfg, max_new_tokens=4)
        return logits, last, step, chunk, cache["k"], gen

    with torch.no_grad():
        got, want = serve(placed), serve(plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    jlogits = jax.jit(jtr.forward, static_argnums=2)(jparams, toks, jcfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jlogits),
                               **FLASH_TOL)
    jl, _ = jax.jit(jgen.prefill, static_argnums=2)(
        jparams, toks, jcfg, jgen.init_kv_cache(jcfg, 2, 40))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jl), **FLASH_TOL)
    jt = jgen.generate(jparams, toks, cfg=jcfg, max_new_tokens=4)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(jt))


# -- the chaos plan and the replica context -----------------------------------

def test_a_plan_armed_here_arms_actors_spawned_after_it():
    plan = [{"site": "serve.spec_verify", "action": "error", "once": True}]
    tfi.disarm()
    try:
        tfi.arm(plan)
        assert os.environ[tfi.ENV_VAR]
        armed = actors.remote(models.ChaosProbe).remote()
    finally:
        tfi.disarm()
    # spawned after the disarm: nothing inherited
    unarmed = actors.remote(models.ChaosProbe).remote()
    try:
        got, none = actors.get([armed.state.remote(),
                                unarmed.state.remote()], 60)
    finally:
        actors.kill(armed)
        actors.kill(unarmed)
    assert got["armed"] and got["plan"] == plan
    # `once` holds in the actor's own process: one fire, one claim
    assert [f is not None for f in got["fires"]] == [True, False, False]
    assert got["fires"][0]["rule_id"] == "serve.spec_verify#0"
    assert got["claims"] == [True, False]
    assert none == {"armed": False}
    assert tfi.ENV_VAR not in os.environ and tfi.ACTIVE is None
    assert tfi.chaos_env(plan) == {tfi.ENV_VAR: tfi.json.dumps(plan)}


def test_replica_context_raises_outside_a_replica_and_the_engine_names():
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve import DecodeSessionCore
    from ray_tpu_torch.serve.replica import get_replica_context
    with pytest.raises(RuntimeError, match="inside a Serve replica"):
        get_replica_context()
    cfg = TransformerConfig.tiny(dtype=torch.float32, max_seq_len=32)
    core = DecodeSessionCore(
        cfg, max_len=32, params=init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), **CPU)
    try:
        assert (core.engine.name, core.engine._tag) == ("decode", "local")
    finally:
        core.engine.shutdown()
