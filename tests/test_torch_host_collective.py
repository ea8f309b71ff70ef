"""The port's host collectives on the CPU, held against the JAX package.

`core.serialization` against the JAX package's round trip; the store
reduction (`util.collective._combine`) against the JAX reducer and group
actor classes, which are plain classes fed the same arrays in this process;
four spawned ranks sharing one `TCPStore` and no process group
(`torch_collective_ranks.py`, no JAX there) running `train.host_collective`
and a `util.collective` group: every op, rank order, an uneven
reducescatter, send / recv sequencing, bitwise the JAX classes' values, and
an empty store after; the no-gang paths against JAX's; a `HostArrayConfig`
gang of two through `TorchTrainer`, restarted once.
"""

import multiprocessing
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_collective_ranks as cr
import torch_train_loops as loops
from ray_tpu.core import serialization as jser
from ray_tpu.train import host_collective as jhc
from ray_tpu.util.collective import _GroupActor
from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.train import HostArrayConfig, TorchTrainer
from ray_tpu_torch.train import host_collective as hc
from ray_tpu_torch.util import collective as col

REPO = Path(__file__).resolve().parents[1]
WORLD = 4


@pytest.fixture(autouse=True)
def no_process_left():
    """Every test's ranks are gone by its end (children that were there
    before it, of other tests in this process, aside)."""
    before = set(multiprocessing.active_children())
    yield
    assert set(multiprocessing.active_children()) <= before


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# -- serialization ------------------------------------------------------------

def _value(seed):
    rng = np.random.default_rng(seed)
    return {"big": rng.standard_normal(262_144).astype(np.float32),  # 1 MB
            "ints": rng.integers(0, 9, (3, 4)),
            "nested": [rng.standard_normal((2, 2)), "s", 3, None],
            "arr": rng.standard_normal((5, 3)).astype(np.float32),
            "half": rng.standard_normal((4,)).astype(np.float16)}


@pytest.mark.parametrize("key", ["big", "ints", "nested", "arr", "half"])
def test_round_trip_matches_jax(key):
    """deserialize(serialize(x)) of the same dict, with jax.Arrays on the
    JAX side where the port has CPU tensors: the same values and dtypes;
    numpy arrays read-only views in both."""
    x = _value(0)
    jax_in = dict(x, arr=jnp.asarray(x["arr"]), half=jnp.asarray(x["half"]))
    port_in = dict(x, arr=torch.from_numpy(x["arr"]),
                   half=torch.from_numpy(x["half"]))
    want = jser.deserialize(memoryview(jser.serialize_to_bytes(jax_in)))
    got = ser.deserialize(ser.serialize_to_bytes(port_in))
    w, g = want[key], got[key]
    if key == "nested":
        assert _same(g[0], w[0]) and g[1:] == w[1:]
    elif key in ("arr", "half"):
        assert isinstance(g, torch.Tensor) and isinstance(w, jax.Array)
        assert _same(g.numpy(), np.asarray(w))
    else:
        assert _same(g, w)
        assert not g.flags.writeable and not w.flags.writeable


def test_buffers_out_of_band_and_64_byte_aligned():
    x = _value(1)
    parts = ser.serialize(x)
    offsets = np.cumsum([0] + [p.nbytes for p in parts])
    big = x["big"].nbytes
    out_of_band = [i for i, p in enumerate(parts) if p.nbytes == big]
    assert out_of_band and all(offsets[i] % 64 == 0 for i in out_of_band)
    body = parts[1].nbytes
    assert body < 4096          # the 1 MB array is not in the pickled body
    assert ser.serialize_to_bytes(x) == b"".join(parts)


def test_tensor_staging_keeps_dtype_shape_and_refuses_a_missing_card(
        monkeypatch):
    t = {"bf16": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
         "p": torch.nn.Parameter(torch.ones(2)), "empty": torch.empty(0, 4),
         "scalar": torch.tensor(7, dtype=torch.int32)}
    back = ser.deserialize(ser.serialize_to_bytes(t))
    for k, v in t.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k], v)
    assert isinstance(back["p"], torch.nn.Parameter) and \
        back["p"].requires_grad
    # a CUDA tensor arriving in a process without CUDA raises, naming it
    raw = torch.zeros(6, dtype=torch.bfloat16).view(torch.uint8).numpy()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"\(2, 3\).*bfloat16"):
        ser._restore_tensor(raw, "bfloat16", (2, 3), True, False, False)
    with pytest.raises(ValueError, match="magic"):
        ser.deserialize(b"XXXX" + bytes(16))


# -- the reduction against the JAX classes ------------------------------------

@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "prod",
                                "gather"])
def test_combine_equals_the_jax_reducer_and_group_actor(op):
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((5, 7)).astype(np.float32)
          for _ in range(WORLD)]
    actor = _GroupActor(WORLD)
    for r in (2, 0, 3, 1):      # arrival order does not matter
        actor.contribute("k", r, xs[r], op)
    wants = [actor.fetch("k")]
    if op != "prod":            # the JAX Train reducer has no prod
        red = jhc._Reducer(WORLD)
        for r in (3, 1, 0, 2):
            red.contribute("k", xs[r], op, r)
        wants.append(red.fetch("k"))
    got = col._combine(xs, op, WORLD)
    for want in wants:
        if op == "gather":
            assert len(got) == WORLD and all(_same(g, w)
                                             for g, w in zip(got, want))
        else:
            assert _same(got, want)
    with pytest.raises(ValueError):
        col._combine(xs, "median", WORLD)


# -- four ranks on one store --------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four rank processes on one TCPStore hosted here: what each returned,
    and the store's key count after they ended."""
    tmp = tmp_path_factory.mktemp("collective_ranks")
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=60))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_collective_ranks.py"),
         "127.0.0.1", str(store.port), str(WORLD), str(r), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(__import__("pickle").load(f))
    return out, store.num_keys()


def _reducer(key, values, op):
    red = jhc._Reducer(WORLD)
    for r, v in enumerate(values):
        red.contribute(key, v, op, r)
    return red.fetch(key)


def _actor(key, values, op):
    actor = _GroupActor(WORLD)
    for r, v in enumerate(values):
        actor.contribute(key, r, v, op)
    return actor.fetch(key)


INS = [cr.inputs(r) for r in range(WORLD)]


@pytest.mark.parametrize("op", cr.OPS)
def test_host_allreduce_equals_the_jax_reducer(ranks, op):
    out, _ = ranks
    want = _reducer("k", [x["x"] for x in INS], op)
    assert all(_same(o[f"hc_{op}"], want) for o in out)


def test_host_allgather_ints_and_barrier_in_rank_order(ranks):
    out, _ = ranks
    want = _reducer("k", [x["x"] for x in INS], "gather")
    ints = _reducer("k", [x["ints"] for x in INS], "sum")
    for o in out:
        assert len(o["hc_gather"]) == WORLD
        assert all(_same(g, w) for g, w in zip(o["hc_gather"], want))
        assert _same(o["hc_ints"], ints)


def _jax_allreduce_pytree(trees, op):
    """JAX's allreduce_pytree (host_collective.py:112-125) with each rank's
    flat vector fed to one _Reducer."""
    flat = []
    for tree in trees:
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        flat.append(np.concatenate([np.ravel(np.asarray(l, dtype=np.float32))
                                    for l in leaves]))
    reduced = _reducer("tree", flat, op)
    outs = []
    for tree in trees:
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        res, off = [], 0
        for l in leaves:
            size = int(np.size(l))
            res.append(np.asarray(reduced[off:off + size],
                                  dtype=np.asarray(l).dtype)
                       .reshape(np.shape(l)))
            off += size
        outs.append(jax.tree_util.tree_unflatten(treedef, res))
    return outs


def _jax_tree(x):
    t = x["tree"]
    return {"b": jnp.asarray(t["b"]), "a": t["a"],
            "t": jnp.asarray(t["t"], dtype=jnp.bfloat16)}


def test_allreduce_pytree_equals_jax_and_keeps_leaf_kinds(ranks):
    out, _ = ranks
    want = _jax_allreduce_pytree([_jax_tree(x) for x in INS], "mean")
    for o, w in zip(out, want):
        got = o["hc_tree"]
        assert got["kinds"] == ["Tensor", "torch.bfloat16", "ndarray",
                                "int32"]
        assert _same(got["b"], w["b"])
        assert _same(got["a"][0], w["a"][0]) and _same(got["a"][1], w["a"][1])
        assert _same(got["t"], np.asarray(w["t"], dtype=np.float32))
        # the store held all four contributions of the tree at once
        assert o["hc_held"] >= 4 * 4 * (6 + 4 + 2 + 3)


@pytest.mark.parametrize("op", cr.GROUP_OPS)
def test_group_allreduce_equals_the_jax_group_actor(ranks, op):
    out, _ = ranks
    want = _actor("k", [x["pos"] for x in INS], op)
    assert all(_same(o[f"g_{op}"], want) for o in out)


def test_group_gather_reducescatter_broadcast(ranks):
    out, _ = ranks
    gathered = _actor("k", [x["x"] for x in INS], "gather")
    full = _actor("k", [x["rows"] for x in INS], "sum")
    chunks = np.array_split(np.asarray(full), WORLD, axis=0)
    assert [c.shape[0] for c in chunks] == [2, 2, 2, 1]
    src = INS[cr.BROADCAST_SRC]["x"] * (cr.BROADCAST_SRC + 1)
    for r, o in enumerate(out):
        assert all(_same(g, w) for g, w in zip(o["g_gather"], gathered))
        assert _same(o["g_scatter"], chunks[r])
        assert _same(o["g_broadcast"], src)


def test_send_recv_pairs_meet_in_order(ranks):
    out, _ = ranks
    for src, dst, n in cr.P2P:
        got = out[dst]["g_recv"][src]
        want = [INS[src]["message"][i] + 10 * dst for i in range(n)]
        assert len(got) == n and all(_same(g, w) for g, w in zip(got, want))


def test_the_store_holds_no_key_of_a_finished_collective(ranks):
    """The JAX reducer never drops a finished key; the last reader of each
    of the port's deletes it."""
    _, keys_left = ranks
    assert keys_left == 0


def test_no_gang_paths_match_jax():
    assert hc._STORE is None and jhc._REDUCER is None
    x = INS[0]
    tree = {"b": x["tree"]["b"], "a": x["tree"]["a"]}
    got = hc.allreduce_pytree(tree, "mean")
    want = jhc.allreduce_pytree(tree, "mean")
    assert _same(got["b"], want["b"]) and _same(got["a"][1], want["a"][1])
    assert _same(hc.allreduce(x["x"], "max"), jhc.allreduce(x["x"], "max"))
    g, w = hc.allgather(x["x"]), jhc.allgather(x["x"])
    assert len(g) == len(w) == 1 and _same(g[0], w[0])
    # a tensor leaf comes back a tensor on its device, in its dtype
    t = hc.allreduce_pytree({"t": torch.ones(3, dtype=torch.bfloat16)})
    assert t["t"].dtype == torch.bfloat16 and t["t"].device.type == "cpu"


def test_host_array_gang_restarts_on_a_fresh_prefix(tmp_path):
    """A HostArrayConfig gang of two on the CPU: allreduce, allgather in
    rank order and a barrier through the trainer's store every step; every
    rank fails once at step 1 and the restarted gang resumes on a fresh key
    prefix (a dead attempt's keys never meet the new one)."""
    result = TorchTrainer(
        loops.host_array_steps,
        train_loop_config={"steps": 3, "marker": str(tmp_path / "m")},
        scaling_config=ScalingConfig(num_workers=2, device="cpu"),
        backend_config=HostArrayConfig(),
        run_config=RunConfig(name="host", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert result.error is None
    hist = result.metrics_history
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert [h["total"] for h in hist] == [3.0, 5.0, 7.0]
    assert all(h["gathered"] == [0, 1] and h["world"] == 2 for h in hist)
    assert hist[0]["prefix"] != hist[1]["prefix"] == hist[2]["prefix"]


def test_a_wait_past_its_timeout_raises_timeout_error():
    """A collective whose peers never come raises TimeoutError after its
    timeout (the JAX default is 120 s; here half a second)."""
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=10))
    col.init_collective_group(2, 0, store=store, group_name="lonely")
    try:
        with pytest.raises(TimeoutError, match="recv from rank 1"):
            col.recv(1, group_name="lonely", timeout_s=0.5)
        with pytest.raises(TimeoutError):
            col.allreduce(np.ones(2), group_name="lonely", timeout_s=0.5)
    finally:
        col.destroy_collective_group("lonely")
    hc._set_store(store, "lonely", 2, 0)
    try:
        with pytest.raises(TimeoutError, match="host allreduce"):
            hc._run("k/0", np.ones(2), "sum", timeout_s=0.5)
    finally:
        hc._set_store(None, "", 1, 0)
