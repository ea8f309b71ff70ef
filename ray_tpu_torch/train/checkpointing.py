"""Checkpoint bookkeeping for training runs (counterpart of
``ray_tpu/train/checkpointing.py``, line for line).

`CheckpointManager` tracks, persists, prunes to ``num_to_keep`` (never the
best by its metric) and exposes latest / best.  Checkpoints land under
``<storage>/checkpoint_<iter:06d>`` as directories
(`Checkpoint.to_directory`), staged and renamed into place.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..air.checkpoint import Checkpoint
from ..air.config import CheckpointConfig
from ..exceptions import CheckpointWriteError
from ..util import fault_injection as fi

CHECKPOINT_REGISTER_SITE = "train.checkpoint_register"


class CheckpointManager:
    def __init__(self, storage_path: str,
                 config: Optional[CheckpointConfig] = None,
                 metric: Optional[str] = None, mode: str = "max"):
        self.storage_path = storage_path
        self.config = config or CheckpointConfig()
        self.metric = metric
        self.mode = mode
        self._tracked: List[Tuple[int, str, Dict[str, Any]]] = []
        os.makedirs(storage_path, exist_ok=True)
        # sweep torn writes from a previous crash: a .tmp-* staging dir
        # is by definition incomplete and must never be resumed from
        for name in os.listdir(storage_path):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(storage_path, name),
                              ignore_errors=True)

    def register(self, iteration: int, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None) -> str:
        """Crash-safe: the checkpoint is staged into a temp dir and
        atomically renamed into place, so a crash mid-write can never
        leave a torn ``checkpoint_<iter>`` that a later resume would
        read as valid.

        Durable under disk faults: an ENOSPC/EIO anywhere in the stage /
        replace dance rolls back (staging cleaned, a half-swapped old
        dir restored) and raises a typed :class:`CheckpointWriteError` —
        the previously registered checkpoints stay tracked and loadable,
        so the run keeps training and retries the save later."""
        path = os.path.join(self.storage_path, f"checkpoint_{iteration:06d}")
        staging = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
        old = None
        try:
            fi.fs_point(CHECKPOINT_REGISTER_SITE, path)
            checkpoint.to_directory(staging)
            if os.path.isdir(path):
                # re-registration after a restart resumed at this
                # iteration: replace the old complete dir (never visible
                # half-written)
                old = f"{path}.tmp-replaced-{uuid.uuid4().hex[:8]}"
                os.rename(path, old)
                os.rename(staging, path)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(staging, path)
        except OSError as e:
            shutil.rmtree(staging, ignore_errors=True)
            if old is not None and os.path.isdir(old) \
                    and not os.path.isdir(path):
                # the old dir was swapped out but the new one never
                # landed: put the last good checkpoint back
                os.rename(old, path)
            from ..core import runtime_metrics as rtm
            rtm.STORAGE_FAULTS.inc(tags={
                "site": CHECKPOINT_REGISTER_SITE,
                "outcome": "kept_previous"})
            raise CheckpointWriteError(os.path.basename(path),
                                       str(e)) from e
        entry = (iteration, path, dict(metrics or {}))
        self._tracked = [e for e in self._tracked if e[1] != path]
        self._tracked.append(entry)
        self._prune()
        return path

    def _score(self, entry) -> float:
        _, _, metrics = entry
        if self.metric and self.metric in metrics:
            v = float(metrics[self.metric])
            return v if self.mode == "max" else -v
        return float("-inf")

    def _prune(self) -> None:
        keep = self.config.num_to_keep
        if keep is None or len(self._tracked) <= keep:
            return
        # keep the most recent `keep` - but never drop the best-by-metric
        candidates = sorted(self._tracked, key=lambda e: e[0])
        best = (max(self._tracked, key=self._score)
                if self.metric else None)
        while len(candidates) > keep:
            victim = candidates[0]
            if best is not None and victim is best and len(candidates) > 1:
                victim = candidates[1]
            candidates.remove(victim)
            self._tracked.remove(victim)
            shutil.rmtree(victim[1], ignore_errors=True)

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        path = max(self._tracked, key=lambda e: e[0])[1]
        return Checkpoint.from_directory(path)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        entry = max(self._tracked, key=self._score)
        return Checkpoint.from_directory(entry[1])

    @property
    def latest_iteration(self) -> int:
        return max((e[0] for e in self._tracked), default=0)
