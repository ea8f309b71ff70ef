"""The port's sharded tree checkpoints (`Checkpoint.from_pytree` /
`to_pytree` on `torch.distributed.checkpoint`) on the CPU, held against the
JAX package's orbax ones on the same values.

tests/test_train.py:138-232 ported: a save under fsdp=2,tp=2 placements at
four gloo ranks (`torch_rank_checks.check_pytree`), restored onto the
swapped placements and onto whole tensors, against orbax on
``jax.devices()[:4]`` with the same mesh; a dp=2 Train gang saving to a
shared path, restarted once from its registered save (the rank restores
it) and restored here; the numbered re-save; the errors.
"""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import torch_train_loops as loops
from ray_tpu.air import Checkpoint as JCheckpoint
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.air import (Checkpoint, FailureConfig, RunConfig,
                               ScalingConfig, session)
from ray_tpu_torch.air.session import _Session, _set_session
from ray_tpu_torch.train import SpmdConfig, TorchTrainer
from torch_rank_checks import run_ranks

W = np.arange(64.0, dtype=np.float32).reshape(8, 8)
B = np.ones((8,), np.float32)


@pytest.fixture(autouse=True)
def no_process_left():
    before = set(multiprocessing.active_children())
    yield
    assert set(multiprocessing.active_children()) <= before


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# -- one process --------------------------------------------------------------

def test_round_trip_and_numbered_resave_match_jax(tmp_path):
    """Every leaf kind back with its values and dtype, then
    tests/test_train.py:216's re-save to one path on both packages: the
    same numbered directories, the newest save restored."""
    tree = {"w": W, "b": B.astype(np.float16), "step": 3,
            "nested": [np.arange(3, dtype=np.int32), None]}
    port_tree = dict(tree, w=torch.from_numpy(W),
                     b=torch.from_numpy(tree["b"]))
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    want = JCheckpoint.from_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree), jp).to_pytree()
    got = Checkpoint.from_pytree(port_tree, pp).to_pytree(device="cpu")
    for k in ("w", "b"):
        assert isinstance(got[k], torch.Tensor)
        assert _same(got[k].numpy(), np.asarray(want[k]))
    assert int(got["step"]) == int(want["step"]) == 3
    assert _same(got["nested"][0], np.asarray(want["nested"][0]))
    assert got["nested"][1] is None

    jck = JCheckpoint.from_pytree({"x": jnp.full(4, 7.0)}, path=jp)
    pck = Checkpoint.from_pytree({"x": torch.full((4,), 7.0)}, path=pp)
    assert sorted(os.listdir(pp)) == sorted(os.listdir(jp)) == [
        "pytree-000000", "pytree-000001"]
    assert _same(pck.to_pytree(device="cpu")["x"].numpy(),
                 np.asarray(jck.to_pytree()["x"]))


def test_target_decides_and_errors(tmp_path, monkeypatch):
    ck = Checkpoint.from_pytree({"w": torch.from_numpy(W), "n": 2},
                                str(tmp_path / "ck"))
    target = {"w": torch.zeros(8, 8)}
    out = ck.to_pytree(target)
    assert out["w"] is target["w"] and _same(target["w"].numpy(), W)
    assert out["n"] == 2
    with pytest.raises(ValueError, match="no pytree"):
        Checkpoint.from_dict({"x": 1}).to_pytree()
    with pytest.raises(ValueError, match="no pytree"):
        Checkpoint.from_directory(str(tmp_path)).to_pytree(device="cpu")
    # a gang's save needs a shared path
    _set_session(_Session(world_rank=0, world_size=2))
    try:
        with pytest.raises(ValueError, match="explicit path"):
            Checkpoint.from_pytree({"w": torch.ones(2)})
    finally:
        _set_session(None)
    # no device and no CUDA: raises, as every entry point of the port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.to_pytree()


def test_preprocessor_sidecar_stays_out_of_the_saves(tmp_path):
    ck = Checkpoint.from_pytree({"w": torch.ones(2)}, str(tmp_path / "ck"))
    ck.with_preprocessor({"scale": 2})
    assert sorted(os.listdir(ck.path)) == ["preprocessor.pkl",
                                           "pytree-000000"]
    assert ck.get_preprocessor() == {"scale": 2}
    assert _same(ck.to_pytree(device="cpu")["w"].numpy(),
                 np.ones(2, np.float32))


# -- four gloo ranks: fsdp=2,tp=2 ---------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pytree_ranks")
    path = str(tmp / "ck")
    return run_ranks(tmp, 4, [("pytree", {"path": path, "w": W, "b": B})])


@pytest.fixture(scope="module")
def orbax_four(tmp_path_factory):
    """The JAX package's save of the same tree on four devices, restored
    onto P("tp", "fsdp"): each device's shard by mesh position."""
    tmp = tmp_path_factory.mktemp("orbax")
    mesh = jmesh.create_mesh(jmesh.MeshSpec(fsdp=2, tp=2),
                             devices=jax.devices()[:4])
    tree = {"w": jax.device_put(jnp.asarray(W),
                                JNamedSharding(mesh, JP("fsdp", "tp"))),
            "b": jnp.asarray(B), "step": jnp.asarray(3)}
    ck = JCheckpoint.from_pytree(tree, path=str(tmp / "ck"))
    target = {"w": jax.ShapeDtypeStruct(
        (8, 8), jnp.float32, sharding=JNamedSharding(mesh, JP("tp", "fsdp"))),
        "b": jax.ShapeDtypeStruct((8,), jnp.float32),
        "step": jax.ShapeDtypeStruct((), jnp.int32)}
    swapped = ck.to_pytree(target)
    by_device = {s.device: np.asarray(s.data)
                 for s in swapped["w"].addressable_shards}
    saved = {s.device: np.asarray(s.data)
             for s in tree["w"].addressable_shards}
    order = list(mesh.devices.flat)
    return ({"swapped": [by_device[d] for d in order],
             "saved": [saved[d] for d in order],
             "whole": ck.to_pytree()})


def test_each_rank_writes_only_its_shards(four_ranks):
    files = four_ranks[0]["pytree"]["files"]
    shards = sorted(n for n in files if n.endswith(".distcp"))
    assert shards == [f"__{r}_0.distcp" for r in range(4)]
    # a quarter of w each (and b and the step written once, by one rank)
    quarter = W.nbytes // 4
    assert all(files[n] >= quarter for n in shards)
    assert sum(files[n] for n in shards) < W.nbytes + 4 * 4096 + B.nbytes


@pytest.mark.parametrize("rank", range(4))
def test_shards_and_swapped_restore_match_orbax(four_ranks, orbax_four,
                                                rank):
    got = four_ranks[rank]["pytree"]
    assert _same(got["saved_local"], orbax_four["saved"][rank])
    assert _same(got["swapped_local"], orbax_four["swapped"][rank])
    assert got["swapped_placements"] == [
        "Shard(dim=1)" if i == 1 else "Shard(dim=0)" if i == 4
        else "Replicate()" for i in range(6)]


def test_whole_restore_and_resave_match_orbax(four_ranks, orbax_four):
    for res in four_ranks:
        got = res["pytree"]
        assert _same(got["whole"]["w"], np.asarray(orbax_four["whole"]["w"]))
        assert _same(got["whole"]["b"], np.asarray(orbax_four["whole"]["b"]))
        assert int(got["whole"]["step"]) == 3
        assert _same(got["again"]["w"], W * 2) and got["again"]["step"] == 4
        assert got["saves"] == [["pytree-000000"],
                                ["pytree-000000", "pytree-000001"]]


# -- a Train gang ------------------------------------------------------------

def test_gang_saves_restarts_from_its_save_and_restores_here(tmp_path):
    """tests/test_train.py:172's gang save on a dp=2 gang: every rank joins
    each save to a shared path and reports it; after a failure at step 1
    the new ranks restore the registered save (step 0) and go on; here the
    newest save and the run's registered checkpoint restore whole, as the
    JAX test restores its save outside the gang."""
    shared = str(tmp_path / "shared")
    result = TorchTrainer(
        loops.pytree_steps,
        train_loop_config={"path": shared, "steps": 3,
                           "marker": str(tmp_path / "m")},
        scaling_config=ScalingConfig(num_workers=2, device="cpu"),
        backend_config=SpmdConfig(mesh="dp=2"),
        run_config=RunConfig(name="pytree", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert result.error is None
    hist = result.metrics_history
    assert [h["step"] for h in hist] == [0, 1, 2]
    base = np.arange(16.0).reshape(4, 4)
    assert hist[1]["restored"] == base.tolist()       # the step-0 save
    assert hist[0]["local"] == base[:2].tolist()      # rank 0's dp shard
    assert sorted(os.listdir(shared)) == [f"pytree-{i:06d}" for i in range(3)]
    for ck in (Checkpoint.from_directory(shared), result.checkpoint):
        out = ck.to_pytree(device="cpu")
        assert _same(out["w"].numpy(), (base + 2).astype(np.float32))
        assert out["step"] == 2
    assert session._get_session() is None
