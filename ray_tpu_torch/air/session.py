"""Training session: the in-train-loop API (counterpart of
``ray_tpu/air/session.py``).

The user's train function calls these; the backing `_Session` is installed
on each rank by the Train worker (`train.worker_group.TrainWorker`) and
streams reports back to the trainer.  Beside the JAX package's getters,
`get_device` names the device this rank computes on (``cuda:<local rank>``,
or the CPU for a gang run with ``device="cpu"``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

import torch

from .checkpoint import Checkpoint


class _Session:
    def __init__(self, *, world_rank: int = 0, local_rank: int = 0,
                 world_size: int = 1, node_rank: int = 0,
                 trial_name: str = "default", dataset_shard=None,
                 device: Optional[torch.device] = None):
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.world_size = world_size
        self.node_rank = node_rank
        self.trial_name = trial_name
        self.dataset_shard = dataset_shard
        self.device = device
        self.queue: "queue.Queue" = queue.Queue()
        self.stop_event = threading.Event()
        self.last_checkpoint: Optional[Checkpoint] = None
        self.iteration = 0
        self.mesh = None             # set by the SPMD backend's setup
        self._last_report_t: Optional[float] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        from ..util import tracing
        self.iteration += 1
        # per-step span: report() marks step boundaries, so each span
        # covers one train step on this rank's timeline lane
        now = time.time()
        if self._last_report_t is not None:
            tracing.record_span(f"train_step::{self.trial_name}", "train",
                                self._last_report_t, now,
                                iteration=self.iteration,
                                rank=self.world_rank)
        self._last_report_t = now
        if checkpoint is not None:
            self.last_checkpoint = checkpoint
        self.queue.put({"metrics": dict(metrics), "checkpoint": checkpoint,
                        "iteration": self.iteration})
        if self.stop_event.is_set():
            raise SystemExit("session stopped by the trainer")


_session: threading.local = threading.local()


def _set_session(s: Optional[_Session]):
    _session.value = s


def _get_session() -> Optional[_Session]:
    return getattr(_session, "value", None)


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report intermediate metrics (and optionally a checkpoint) to the
    trainer; outside a Train session it's a no-op print."""
    s = _get_session()
    if s is None:
        print(f"[ray_tpu_torch.air.session] {metrics}")
        return
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from (set on restore), else None."""
    s = _get_session()
    return s.last_checkpoint if s else None


def get_world_rank() -> int:
    s = _get_session()
    return s.world_rank if s else 0


def get_local_rank() -> int:
    s = _get_session()
    return s.local_rank if s else 0


def get_world_size() -> int:
    s = _get_session()
    return s.world_size if s else 1


def get_node_rank() -> int:
    s = _get_session()
    return s.node_rank if s else 0


def get_trial_name() -> str:
    s = _get_session()
    return s.trial_name if s else "default"


def get_device() -> torch.device:
    """This rank's device; outside a session the current card (raises
    without CUDA)."""
    s = _get_session()
    if s is not None and s.device is not None:
        return s.device
    from ..device import resolve_device
    return resolve_device(None)


def get_mesh():
    """The gang's `DeviceMesh` (set by the SPMD backend), or outside a
    session a one-rank mesh on the card."""
    s = _get_session()
    mesh = getattr(s, "mesh", None) if s else None
    if mesh is None:
        from ..parallel.mesh import create_mesh
        mesh = create_mesh()
    return mesh


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    if s is None or s.dataset_shard is None:
        return None
    if isinstance(s.dataset_shard, dict):
        return s.dataset_shard.get(name)
    return s.dataset_shard
