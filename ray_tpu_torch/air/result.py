"""Result of a training run (counterpart of ``ray_tpu/air/result.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return self.metrics.get("config") if self.metrics else None
