"""Trainers: the user-facing ``fit()`` entry points (counterpart of
``ray_tpu/train/trainer.py``).

`TorchTrainer` (the JAX package's `JaxTrainer`) runs
``train_loop_per_worker`` on a gang of spawned rank processes with
`SpmdConfig` as its default backend: one process group (NCCL on the card,
gloo with ``ScalingConfig(device="cpu")``) and a mesh on the session.
``fit`` restarts a failed attempt from the newest registered checkpoint up
to ``FailureConfig.max_failures`` times.  `TorchCompatTrainer` runs
reference-style torch train functions on a plain gloo process group with
no mesh.  The JAX package's `TensorflowTrainer` is not ported (no
TensorFlow on the port's machines).
"""

from __future__ import annotations

import datetime
import functools
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional

from ..air.checkpoint import Checkpoint
from ..air.config import (CheckpointConfig, FailureConfig, RunConfig,
                          ScalingConfig)
from ..air.result import Result
from .backend import (TEARDOWN_TIMEOUT_S, Backend, BackendConfig,
                      SpmdConfig)
from .backend_executor import BackendExecutor, TrainingFailedError
from .checkpointing import CheckpointManager


class TorchTrainer:
    """Run ``train_loop_per_worker`` on a gang of rank processes with
    mesh / session plumbing.  Without a ``backend_config`` the gang joins
    one process group laid out as ``scaling_config.mesh``."""

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 backend_config: Optional[BackendConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 preprocessor: Optional[Any] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or self._default_backend_config()
        self.datasets = datasets or {}
        # the base-trainer preprocessor contract: fit on the train split,
        # transform every Dataset split before sharding, attach to every
        # checkpoint the run registers so inference applies the SAME
        # transforms
        self.preprocessor = preprocessor
        self.resume_from_checkpoint = resume_from_checkpoint

    def _default_backend_config(self) -> BackendConfig:
        return SpmdConfig(mesh=self.scaling_config.mesh)

    # -- orchestration ------------------------------------------------------
    def fit(self) -> Result:
        if self.scaling_config.device is None:
            from ..device import resolve_device
            resolve_device(None)       # raises without CUDA
        if self.preprocessor is not None and \
                not getattr(self, "_datasets_preprocessed", False):
            train = self.datasets.get("train") if self.datasets else None
            if not getattr(self.preprocessor, "fitted", True):
                if train is None or not hasattr(train, "map_batches"):
                    # an unfitted preprocessor would fail at INFERENCE
                    # time: fail at the misconfiguration instead
                    raise ValueError(
                        "preprocessor needs a 'train' Dataset split to "
                        "fit on (or pass an already-fitted "
                        "preprocessor)")
                self.preprocessor.fit(train)
            self.datasets = {
                name: (self.preprocessor.transform(ds)
                       if hasattr(ds, "map_batches") else ds)
                for name, ds in self.datasets.items()}
            # fit() may run again (failure retries): never double-fit or
            # double-transform
            self._datasets_preprocessed = True
        name = self.run_config.name or "train_run"
        storage = (self.run_config.storage_path
                   or os.path.join(tempfile.gettempdir(),
                                   "ray_tpu_torch_results"))
        run_dir = os.path.join(storage, name)
        ckpt_mgr = CheckpointManager(
            run_dir, self.run_config.checkpoint_config or CheckpointConfig())
        failure = self.run_config.failure_config or FailureConfig()

        attempts = 0
        resume = self.resume_from_checkpoint
        history: List[Dict[str, Any]] = []
        while True:
            try:
                metrics = self._run_attempt(name, ckpt_mgr, resume, history)
                return Result(metrics=metrics,
                              checkpoint=ckpt_mgr.latest_checkpoint,
                              path=run_dir, metrics_history=history)
            except TrainingFailedError as e:
                attempts += 1
                if failure.max_failures >= 0 and \
                        attempts > failure.max_failures:
                    return Result(metrics=history[-1] if history else {},
                                  checkpoint=ckpt_mgr.latest_checkpoint,
                                  error=e, path=run_dir,
                                  metrics_history=history)
                resume = ckpt_mgr.latest_checkpoint or resume

    def _dataset_shards(self) -> Optional[List[Any]]:
        if not self.datasets:
            return None
        n = self.scaling_config.num_workers
        shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for key, ds in self.datasets.items():
            if hasattr(ds, "split"):
                parts = ds.split(n)
            else:  # static sequence: strided split
                parts = [list(ds)[i::n] for i in range(n)]
            for i in range(n):
                shards[i][key] = parts[i]
        return shards

    def _run_attempt(self, name: str, ckpt_mgr: CheckpointManager,
                     resume: Optional[Checkpoint],
                     history: List[Dict[str, Any]]) -> Dict[str, Any]:
        sc = self.scaling_config
        executor = BackendExecutor(self.backend_config,
                                   num_workers=sc.num_workers,
                                   device=sc.device)
        try:
            executor.start(trial_name=name, resume_checkpoint=resume,
                           dataset_shards=self._dataset_shards())
            executor.start_training(self.train_loop, self.train_loop_config)
            last_metrics: Dict[str, Any] = {}
            while True:
                results = executor.next_results()
                if results is None:
                    break
                rank0 = next((r for r in results
                              if isinstance(r, dict)), None)
                if rank0 is None:
                    continue
                last_metrics = rank0["metrics"]
                history.append(last_metrics)
                wire = rank0.get("checkpoint")
                if wire is not None:
                    ckpt = Checkpoint._from_wire(wire)
                    # a directory is the rank's own (it crossed by path):
                    # the preprocessor goes on the registered copy instead
                    ranks_own = ckpt.path is not None
                    if self.preprocessor is not None and not ranks_own:
                        ckpt = ckpt.with_preprocessor(self.preprocessor)
                    path = ckpt_mgr.register(rank0["iteration"], ckpt,
                                             last_metrics)
                    if self.preprocessor is not None and ranks_own:
                        Checkpoint.from_directory(path).with_preprocessor(
                            self.preprocessor)
            executor.finish()
            return last_metrics
        finally:
            executor.shutdown()


class _TorchGlooBackendConfig(BackendConfig):
    @property
    def backend_cls(self):
        return _TorchGlooBackend


def _init_gloo(world: int) -> None:
    """On a rank: a gloo process group over the gang, rendezvous at the
    MASTER_ADDR / MASTER_PORT the executor put in its environment."""
    import torch.distributed as dist

    from ..air import session
    dist.init_process_group(
        "gloo", rank=session.get_world_rank(), world_size=world,
        timeout=datetime.timedelta(seconds=120))


def _destroy_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class _TorchGlooBackend(Backend):
    def worker_setup_fn(self, executor):
        return functools.partial(_init_gloo, executor.num_workers)

    def on_shutdown(self, worker_group, executor) -> None:
        worker_group.execute(_destroy_group, timeout=TEARDOWN_TIMEOUT_S)


class TorchCompatTrainer(TorchTrainer):
    """Runs reference-style torch train functions: a ``torch.distributed``
    gloo group over the gang (``dist.init_process_group``), no mesh."""

    def _default_backend_config(self) -> BackendConfig:
        return _TorchGlooBackendConfig()
