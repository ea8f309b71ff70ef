"""Run configuration (counterpart of ``RunConfig`` and the configs it
holds in ``ray_tpu/air/config.py``).  The scaling and elastic configs, the
progress reporter and the sync config come with the distributed training
pieces and Tune."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # gang restarts from last checkpoint


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = True


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    verbose: int = 0
    # metric thresholds, or a (trial_id, result) -> bool callable
    stop: Optional[Union[Dict[str, Any], Callable[[str, Dict[str, Any]],
                                                  bool]]] = None
