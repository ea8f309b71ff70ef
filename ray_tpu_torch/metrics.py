"""User metrics: Counter / Gauge / Histogram + Prometheus exposition
(counterpart of ``ray_tpu/metrics.py``).

Metrics are per-process; `prometheus_text()` renders the registry in the
exposition format, line for line as the JAX package renders the same
metric.  The HTTP exporter and the registry lint come with the port's
runtime.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry: Dict[str, "_Metric"] = {}
_lock = threading.Lock()


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple, float] = {}
        self._default_tags: Dict[str, str] = {}
        with _lock:
            _registry[name] = self

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def _samples(self) -> List[Tuple[Tuple, float]]:
        with _lock:
            return list(self._values.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with _lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with _lock:
            self._values[self._key(tags)] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (), tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [0.1, 1, 10]
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with _lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1


def _fmt_tags(keys, key_vals, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in zip(keys, key_vals)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text() -> str:
    """Render every metric in Prometheus exposition format."""
    out: List[str] = []
    with _lock:
        metrics = list(_registry.values())
    for m in metrics:
        out.append(f"# HELP {m.name} {m.description}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for k, counts in list(m._counts.items()):
                cum = 0
                for b, c in zip(m.boundaries + [float("inf")], counts):
                    cum += c
                    le = "+Inf" if b == float("inf") else repr(b)
                    le_attr = 'le="%s"' % le
                    out.append(
                        f"{m.name}_bucket"
                        f"{_fmt_tags(m.tag_keys, k, le_attr)} {cum}")
                out.append(f"{m.name}_sum{_fmt_tags(m.tag_keys, k)} "
                           f"{m._sums.get(k, 0.0)}")
                out.append(f"{m.name}_count{_fmt_tags(m.tag_keys, k)} "
                           f"{m._totals.get(k, 0)}")
        else:
            for k, v in m._samples():
                out.append(f"{m.name}{_fmt_tags(m.tag_keys, k)} {v}")
    return "\n".join(out) + "\n"
