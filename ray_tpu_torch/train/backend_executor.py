"""Drives the training gang: workers → backend → train loop (counterpart
of ``ray_tpu/train/backend_executor.py``).

Ranks are assigned by sorted (hostname, pid), so same-host workers get
consecutive local ranks; rank i computes on ``cuda:<local rank>``, or on
the CPU with ``device="cpu"``.  The trainer's process picks MASTER_ADDR /
MASTER_PORT for the gang's store and, on the card, builds the kernels once
before any rank starts (ranks then load the built libraries instead of
each running ``nvcc``).  A rank whose process ends fails `next_results` at
once with a `TrainingFailedError` naming the rank and its exit code.
Every wait on the ranks is bounded.  The JAX executor's drain and
elastic-repair paths need its runtime's controller and are not ported:
this executor takes no ``elastic_config``.
"""

from __future__ import annotations

import itertools
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional

from ..air.checkpoint import Checkpoint
from ..core import actors
from ..exceptions import ActorDiedError
from .backend import Backend, BackendConfig
from .worker_group import WorkerGroup

#: next_result poll slice
_POLL_SLICE_S = 2.0
#: session init and the backend's setup, beyond its own timeout
_SETUP_TIMEOUT_S = 120.0
#: how long `finish` waits for the train functions to return
FINISH_TIMEOUT_S = 600.0


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, backend_config: Optional[BackendConfig] = None,
                 num_workers: int = 1, device: Optional[str] = None):
        self.backend_config = backend_config or BackendConfig()
        self.backend: Backend = self.backend_config.backend_cls(
            self.backend_config)
        self.num_workers = num_workers
        self.device = device
        self.run_id = uuid.uuid4().hex[:8]
        self.worker_group: Optional[WorkerGroup] = None
        self.shared_env: Dict[str, Any] = {}
        self.world_ranks: Dict[int, int] = {}

    # -- lifecycle ----------------------------------------------------------
    def start(self, *, trial_name: str = "train",
              resume_checkpoint: Optional[Checkpoint] = None,
              dataset_shards: Optional[List[Any]] = None) -> None:
        from ..parallel.coordinator import _free_port, _local_ip
        if self.device != "cpu":
            from ..device import resolve_device
            from ..kernels import build
            resolve_device(None)       # raises without CUDA
            build.build_all()          # once, before the ranks load them
        self.shared_env["master_addr"] = _local_ip()
        self.shared_env["master_port"] = _free_port()
        self.worker_group = WorkerGroup(
            self.num_workers,
            rank_env={"MASTER_ADDR": self.shared_env["master_addr"],
                      "MASTER_PORT": self.shared_env["master_port"]})
        meta = self._get([w.metadata.remote()
                          for w in self.worker_group.workers],
                         _SETUP_TIMEOUT_S)
        # rank by (hostname, pid): same-host workers contiguous
        order = sorted(range(self.num_workers),
                       key=lambda i: (meta[i]["hostname"], meta[i]["pid"]))
        self.world_ranks = {worker_idx: rank
                            for rank, worker_idx in enumerate(order)}
        local_counters: Dict[str, Any] = {}
        node_ids: Dict[str, int] = {}
        ckpt_wire = (resume_checkpoint._to_wire()
                     if resume_checkpoint else None)
        futures = []
        for worker_idx in order:
            host = meta[worker_idx]["hostname"]
            rank = self.world_ranks[worker_idx]
            futures.append(
                self.worker_group.workers[worker_idx].init_session.remote(
                    world_rank=rank,
                    local_rank=next(local_counters.setdefault(
                        host, itertools.count())),
                    world_size=self.num_workers,
                    node_rank=node_ids.setdefault(host, len(node_ids)),
                    trial_name=trial_name, checkpoint=ckpt_wire,
                    dataset_shard=(dataset_shards[rank]
                                   if dataset_shards else None),
                    device=self.device))
        self._get(futures, _SETUP_TIMEOUT_S)
        self.backend.on_start(self.worker_group, self)
        setup = self.backend.worker_setup_fn(self)
        if setup is not None:
            blob = actors.dumps_function(setup)
            self._get([w.execute.remote(blob)
                       for w in self.worker_group.workers],
                      getattr(self.backend_config, "timeout_s", 0.0)
                      + _SETUP_TIMEOUT_S)

    def start_training(self, train_fn: Callable,
                       config: Optional[Dict[str, Any]] = None) -> None:
        blob = actors.dumps_function(train_fn)
        self._get([w.start_training.remote(blob, config or {})
                   for w in self.worker_group.workers], _SETUP_TIMEOUT_S)

    def _get(self, futures, timeout: float):
        """`actors.get`, with a rank's death as a `TrainingFailedError`
        naming the rank and its exit code."""
        try:
            return actors.get(futures, timeout)
        except ActorDiedError as e:
            rank = next((self.world_ranks.get(i) for i, w in enumerate(
                self.worker_group.workers) if w.pid == e.pid), None)
            who = f"rank {rank}" if rank is not None else "a worker"
            raise TrainingFailedError(
                f"{who} (pid {e.pid}) died with exit code {e.exitcode}"
            ) from e

    # -- results -------------------------------------------------------------
    def next_results(self, timeout_s: float = 60.0):
        """One report from every rank (ordered by world rank), or None when
        all ranks finished.  Raises TrainingFailedError on a worker's
        failure; a rank whose process ended fails it at once."""
        deadline = time.monotonic() + timeout_s
        while True:
            poll = min(_POLL_SLICE_S, max(0.2, deadline - time.monotonic()))
            futures = [w.next_result.remote(poll)
                       for w in self.worker_group.workers]
            try:
                results = self._get(futures, poll + 60.0)
            except TrainingFailedError:
                raise
            except Exception as e:
                raise TrainingFailedError(
                    f"worker lost mid-training: {e}") from e
            if all(r is None for r in results):
                return None
            if all(r in (None, "__timeout__") for r in results) \
                    and time.monotonic() < deadline:
                continue  # nothing reported yet: poll the next slice
            if any(r is None for r in results):
                # some ranks done, some not: drain the stragglers next call
                results = [r if r is not None else "__timeout__"
                           for r in results]
            by_rank = [None] * self.num_workers
            for worker_idx, r in enumerate(results):
                by_rank[self.world_ranks[worker_idx]] = r
            return by_rank

    # -- teardown ------------------------------------------------------------
    def finish(self) -> None:
        try:
            self._get([w.finish.remote(FINISH_TIMEOUT_S)
                       for w in self.worker_group.workers],
                      FINISH_TIMEOUT_S + 60.0)
        except TrainingFailedError:
            raise
        except Exception as e:
            raise TrainingFailedError(str(e)) from e

    def shutdown(self) -> None:
        """Tear the backend down on the ranks (skipped where one has died:
        its peers' groups go with their processes), then kill every rank;
        no process of the gang outlives this."""
        if self.worker_group is None:
            return
        try:
            if self.worker_group.all_alive():
                self.backend.on_shutdown(self.worker_group, self)
        except Exception as e:
            warnings.warn(f"train backend teardown failed: {e!r}; the "
                          f"ranks are killed all the same")
        finally:
            self.worker_group.shutdown()
            self.worker_group = None
