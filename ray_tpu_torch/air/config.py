"""Run, scaling and failure configuration (counterpart of
``ray_tpu/air/config.py``).

`ScalingConfig` speaks the card where the JAX package speaks TPU slices:
``device=None`` puts rank i on ``cuda:<local rank>`` (and raises without
CUDA, as every entry point of the port does), ``device="cpu"`` runs the
ranks on the CPU over gloo.  Every rank runs on this host.  `ElasticConfig`
is refused: elastic repair rides the JAX runtime's object store and node
events, which the port does not have (ROADMAP item 10).  The progress
reporter and the sync config come with Tune.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

from ..parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    # accepted; nothing schedules by it: every rank runs on this host
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    mesh: Union[MeshSpec, str, None] = None  # parallelism layout of the gang
    device: Optional[str] = None             # None: the card; "cpu": gloo

    def __post_init__(self):
        if self.placement_strategy != "PACK":
            raise ValueError(
                f"placement_strategy {self.placement_strategy!r}: the port "
                f"packs every rank on this host (only 'PACK')")
        if self.device not in (None, "cpu", "cuda"):
            raise ValueError(f"device {self.device!r}: None (the card), "
                             f"'cuda' or 'cpu'")


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # gang restarts from last checkpoint


@dataclasses.dataclass
class ElasticConfig:
    """Refused: the JAX package's elastic gang repair (in-memory replicated
    snapshots, rank replacement) rides its runtime's object store and node
    events, which the port does not have."""
    snapshot_interval_steps: int = 10
    repair_deadline_s: float = 30.0
    max_repairs: int = 8
    keep_snapshots: int = 2

    def __post_init__(self):
        raise NotImplementedError(
            "ElasticConfig: elastic repair needs the runtime's object store "
            "and node events (ROADMAP item 10); use FailureConfig restarts")


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
    elastic_config: Optional[ElasticConfig] = None   # refused: see above
    verbose: int = 0
    # metric thresholds, or a (trial_id, result) -> bool callable
    stop: Optional[Union[Dict[str, Any], Callable[[str, Dict[str, Any]],
                                                  bool]]] = None

    def __post_init__(self):
        if self.elastic_config is not None:
            raise NotImplementedError(
                "RunConfig.elastic_config: elastic repair needs the "
                "runtime's object store and node events (ROADMAP item 10)")
