"""The port's Train gang (`ray_tpu_torch.train`, `air.session`,
`core.actors`) on the CPU: spawned rank processes over gloo
(``ScalingConfig(device="cpu")``), tiny fp32 configs.  The assertions of
tests/test_train.py's gang tests, ported; the trainer's per-step losses
against the JAX package's `make_train_step` on the same weights and global
batch; the checkpoint manager against the JAX one; a crashed rank, a
killed actor and a timeout, each failing fast and leaving no process
behind.  The train functions live in `torch_train_loops.py`, which imports
no JAX, so the ranks never import this module."""

import multiprocessing
import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

import torch_train_loops as loops
from ray_tpu.air import Checkpoint as JCheckpoint
from ray_tpu.air import CheckpointConfig as JCheckpointConfig
from ray_tpu.models import transformer as jtr
from ray_tpu.train.checkpointing import CheckpointManager as JManager
from ray_tpu_torch.air import (Checkpoint, CheckpointConfig, ElasticConfig,
                               FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.core import actors
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError
from ray_tpu_torch.train import (CheckpointManager, HostArrayConfig,
                                 SpmdConfig, TorchTrainer,
                                 TrainingFailedError)

LOSS_TOL = 1e-5          # tests/test_torch_train.py's
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def no_process_left():
    """Every test's gang and actors are gone by its end (children that
    were there before it, of other tests in this process, aside)."""
    before = set(multiprocessing.active_children())
    yield
    assert set(multiprocessing.active_children()) <= before


def _fit(tmp_path, fn, name, config=None, workers=1, **kw):
    return TorchTrainer(
        fn, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=workers, **CPU),
        run_config=RunConfig(name=name, storage_path=str(tmp_path),
                             failure_config=kw.pop("failure", None)),
        **kw).fit()


# -- the checkpoint manager ---------------------------------------------------

@pytest.mark.parametrize("keep, metric, mode", [
    (2, "acc", "max"), (2, "acc", "min"), (1, None, "max"),
    (None, None, "max"), (3, "acc", "max")])
def test_checkpoint_manager_keeps_what_the_jax_one_keeps(
        tmp_path, keep, metric, mode):
    """The same register sequence (a re-registered iteration included)
    through the JAX manager and the port's: the same kept directories,
    latest and best."""
    seq = [(1, 0.5), (2, 0.9), (3, 0.6), (2, 0.3), (4, 0.7), (5, 0.1)]
    out = {}
    for side, mgr_cls, ck_cls, cfg_cls in (
            ("jax", JManager, JCheckpoint, JCheckpointConfig),
            ("port", CheckpointManager, Checkpoint, CheckpointConfig)):
        root = tmp_path / side
        mgr = mgr_cls(str(root), cfg_cls(num_to_keep=keep), metric=metric,
                      mode=mode)
        for i, acc in seq:
            mgr.register(i, ck_cls.from_dict({"i": i, "acc": acc}),
                         {"acc": acc})
        out[side] = (sorted(os.listdir(root)),
                     mgr.latest_checkpoint.to_dict(),
                     mgr.best_checkpoint.to_dict(), mgr.latest_iteration)
    assert out["port"] == out["jax"]


def test_checkpoint_carries_a_preprocessor(tmp_path):
    pre = {"scale": 2.0}
    ck = Checkpoint.from_dict({"w": 1}).with_preprocessor(pre)
    assert ck.get_preprocessor() == pre
    back = Checkpoint.from_directory(ck.to_directory(str(tmp_path / "d")))
    assert back.get_preprocessor() == pre
    assert Checkpoint.from_bytes(back.to_bytes()).get_preprocessor() == pre


def test_refused_configs_name_their_item():
    with pytest.raises(NotImplementedError, match="item 10"):
        ElasticConfig()
    with pytest.raises(NotImplementedError, match="item 10"):
        RunConfig(elastic_config=object())
    # HostArrayConfig builds now (its host collectives are ported)
    assert isinstance(HostArrayConfig(), HostArrayConfig)
    with pytest.raises(ValueError, match="PACK"):
        ScalingConfig(placement_strategy="SPREAD")


# -- the actor layer ----------------------------------------------------------

def test_actor_calls_errors_timeouts_and_kill():
    a = actors.remote(loops.Echo).options(env={"GANG_TEST": "x"}).remote(3)
    try:
        assert actors.get(a.add.remote(4), timeout=60) == 7
        assert actors.get(a.env.remote("GANG_TEST"), timeout=10) == "x"
        with pytest.raises(ValueError, match="failed in the actor"):
            actors.get(a.fail.remote(), timeout=10)
        with pytest.raises(GetTimeoutError):
            actors.get(a.sleep.remote(30), timeout=0.2)
        with pytest.raises(ValueError, match="finite timeout"):
            actors.get(a.add.remote(1), timeout=None)
        pending = a.add.remote(1)      # queued behind the sleep
    finally:
        t0 = time.monotonic()
        actors.kill(a)
    with pytest.raises(ActorDiedError) as err:
        actors.get(pending, timeout=10)
    assert err.value.exitcode == -15 and err.value.pid == a.pid
    assert time.monotonic() - t0 < 10
    with pytest.raises(ActorDiedError):        # and every later call
        actors.get(a.add.remote(1), timeout=10)


def test_a_closure_needs_cloudpickle(monkeypatch):
    import sys
    y = 1
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(TypeError, match="cloudpickle"):
        actors.dumps_function(lambda: y)
    blob = actors.dumps_function(loops.always_fails)
    assert actors.loads_function(blob) is loops.always_fails


# -- the trainer --------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_jax():
    """The tiny model's JAX weights (numpy), a global batch of 4 x 32 and
    JAX's AdamW losses over 3 steps on it."""
    jcfg = jtr.TransformerConfig.tiny(dtype=jax.numpy.float32,
                                      **loops.TINY)
    # jitted: op by op the init takes seconds
    jparams = jax.jit(lambda key: jtr.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 32),
                                               dtype=np.int32)
    opt = optax.adamw(loops.LR, b1=loops.B1, b2=loops.B2, eps=loops.EPS,
                      weight_decay=loops.WD)
    step = jax.jit(jtr.make_train_step(jcfg, opt))
    params, state, losses, norms = jparams, opt.init(jparams), [], []
    for _ in range(3):
        params, state, m = step(params, state, {"tokens": tokens})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return (jax.tree_util.tree_map(np.asarray, jparams), tokens, losses,
            norms)


@pytest.mark.parametrize("workers", [1, 2])
def test_trainer_steps_match_jax(tmp_path, tiny_jax, workers):
    """tests/test_train.py:47 (single worker) on the port, and the same
    run as a dp=2 gang: each step's loss and grad norm within
    tests/test_torch_train.py's tolerance of the JAX step's on the same
    weights and global batch."""
    params, tokens, losses, norms = tiny_jax
    result = _fit(tmp_path, loops.tiny_steps, f"steps{workers}",
                  {"params": params, "tokens": tokens, "steps": 3},
                  workers=workers,
                  backend_config=SpmdConfig(mesh=f"dp={workers}"))
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["world"] == workers
    assert len(result.metrics_history) == 3
    assert result.checkpoint.to_dict()["step"] == 2
    np.testing.assert_allclose([m["loss"] for m in result.metrics_history],
                               losses, rtol=LOSS_TOL)
    np.testing.assert_allclose(
        [m["grad_norm"] for m in result.metrics_history], norms,
        rtol=LOSS_TOL)


def test_restart_from_checkpoint(tmp_path):
    """tests/test_train.py:100: one failure, resumed from the step-1
    checkpoint."""
    marker = str(tmp_path / "failed_once")
    result = _fit(tmp_path, loops.restart_once, "elastic",
                  {"marker": marker}, failure=FailureConfig(max_failures=1))
    assert result.error is None
    # resumed from step-1 checkpoint: steps 0,1 then 2,3 after restart
    assert result.metrics["step"] == 3
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]
    assert os.path.exists(marker)


def test_failure_exhausts_budget(tmp_path):
    """tests/test_train.py:125."""
    result = _fit(tmp_path, loops.always_fails, "fail",
                  failure=FailureConfig(max_failures=0))
    assert isinstance(result.error, TrainingFailedError)
    assert "always fails" in str(result.error)


def test_gang_world_size_4_all_reduce(tmp_path):
    """tests/test_train.py:260 with torch.distributed in place of the host
    allreduce: a dp=4 gang, two elements a rank of value rank, summed."""
    result = _fit(tmp_path, loops.rank_allreduce, "ws4", workers=4,
                  backend_config=SpmdConfig(mesh="dp=4,fsdp=-1"))
    assert result.error is None
    assert result.metrics["world"] == 4 and result.metrics["dp"] == 4
    assert result.metrics["total"] == 12.0


def test_a_crashed_rank_fails_the_run_fast(tmp_path):
    """Rank 1's process ends with exit code 3 while rank 0 waits for it in
    a barrier: fit returns a TrainingFailedError naming the rank and the
    code well inside the barrier's own timeout, and kills rank 0."""
    t0 = time.monotonic()
    result = _fit(tmp_path, loops.exits_after_a_report, "crash",
                  {"rank": 1, "code": 3}, workers=2)
    assert time.monotonic() - t0 < 30
    assert isinstance(result.error, TrainingFailedError)
    assert "rank 1" in str(result.error)
    assert "exit code 3" in str(result.error)


def test_fit_raises_without_cuda_or_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchTrainer(loops.always_fails, run_config=RunConfig(
            storage_path=str(tmp_path))).fit()
