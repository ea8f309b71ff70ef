"""Process-local tracing (counterpart of the process-local part of
``ray_tpu/util/tracing.py``).

* ``profile`` — a local Chrome-trace duration event (perf_counter clock).
* **Lifecycle spans** — ``record_span`` / ``span`` append wall-clock spans
  (the serve engine's prefill chunks, decode steps, admissions,
  speculative iterations and injected faults) to a bounded per-process
  buffer; ``span_events`` snapshots it.

The flush of the buffer into the controller's KV and the cluster-wide
merge wait for the port's runtime.  ``TRACE_ENABLED`` and
``TRACE_BUFFER_SIZE`` stand for the JAX package's ``GlobalConfig``
settings of those names, with the same defaults.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, List, Optional

#: record spans at all (``GlobalConfig.trace_enabled``)
TRACE_ENABLED = True
#: spans kept per process, oldest dropped first
#: (``GlobalConfig.trace_buffer_size``)
TRACE_BUFFER_SIZE = 4096

_events: List[dict] = []
_lock = threading.Lock()


class profile:
    """Context manager recording one local Chrome-trace duration event;
    both endpoints read ``time.perf_counter() * 1e6`` (µs)."""

    def __init__(self, name: str, category: str = "task"):
        self.name = name
        self.category = category

    def __enter__(self):
        self.start = time.perf_counter() * 1e6
        return self

    def __exit__(self, *exc):
        end = time.perf_counter() * 1e6
        with _lock:
            _events.append({
                "name": self.name, "cat": self.category, "ph": "X",
                "ts": self.start, "dur": max(0.0, end - self.start),
                "pid": os.getpid(), "tid": threading.get_ident() % 10000,
            })


def chrome_trace_events() -> List[dict]:
    with _lock:
        return list(_events)


# --------------------------------------------------------- lifecycle spans

_span_lock = threading.Lock()
_spans: Optional[deque] = None
# this process's identity in spans and for the chaos rules' ``proc``
# filter; the runtime that names its processes waits for the port's runtime
_proc = {"kind": "proc", "node": ""}


def _buffer() -> deque:
    global _spans
    if _spans is None:
        _spans = deque(maxlen=max(16, TRACE_BUFFER_SIZE))
    return _spans


def proc_label() -> str:
    node = _proc["node"]
    return f"{_proc['kind']}@{node}" if node else _proc["kind"]


def record_span(name: str, cat: str, start_s: float, end_s: float,
                **args: Any) -> None:
    """Record one lifecycle span (wall-clock seconds in, Chrome µs out)."""
    if not TRACE_ENABLED:
        return
    ev = {
        "name": name, "cat": cat, "ph": "X",
        "ts": start_s * 1e6, "dur": max(0.0, end_s - start_s) * 1e6,
        "pid": proc_label(), "tid": str(os.getpid()),
        "args": {k: v for k, v in args.items() if v},
    }
    with _span_lock:
        _buffer().append(ev)


class span:
    """Context manager form of :func:`record_span` (wall clock)."""

    def __init__(self, name: str, cat: str = "task", **args: Any):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        record_span(self.name, self.cat, self.start, time.time(),
                    **self.args)


def span_events() -> List[dict]:
    """Snapshot of this process's span buffer."""
    with _span_lock:
        return list(_buffer())


def dump_chrome_trace(path: str):
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_trace_events()}, f)
