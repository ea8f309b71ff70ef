"""Per-dispatch device profiling of the serve engine's programs
(counterpart of ``ray_tpu/util/device_profile.py``).

Every program the engine runs (decode step, prefill chunk, cache
insert/gather, draft/verify) is wrapped once in a timing shim that records,
per program:

* dispatch count and cumulative dispatch wall time on the host (always);
* device time, sampled every 10th dispatch (as the JAX package's
  default): on a CUDA device from a pair of CUDA events recorded around the
  dispatch on the current stream and read once they have completed (never
  a synchronize, so the hot loop keeps its one sync a step); on the CPU,
  where PyTorch computes before it returns, from the dispatch's wall time.
  The estimate extrapolates the sampled mean over all dispatches;
* the argument-shape key of each dispatch and the wall time of every
  first-seen shape: the shape ledger.  PyTorch compiles nothing, but a
  first shape still pays one-time costs (library handles, allocator
  growth, a graph capture), so its time is kept apart from the samples,
  as the JAX package keeps compile time apart;
* tokens processed (host-known counts fed by the engine through
  :meth:`DispatchProfiler.note_tokens`) and an analytic FLOPs-per-token
  figure (``models.engine_flops_table``), giving an MFU estimate per
  program: ``mfu = tokens * flops_per_token / device_seconds / peak``.

The wrap is idempotent: wrapping an already-wrapped callable re-wraps the
original underneath, never stacking shims.

``peak_flops`` reads the card's name: the table holds the H100 SXM's dense
bf16 peak; on the CPU it is a nominal figure, so the ratio there is a
relative number, not a device metric.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

# dense bf16 peak TFLOP/s by CUDA device name (NVIDIA's data sheet, SXM
# part); the longest matching prefix wins
_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}
#: nominal peak where the table has no entry (the CPU test harness), the
#: JAX package's figure
_FALLBACK_PEAK = 2e11
_SAMPLE_EVERY = 10


def peak_flops() -> float:
    """Per-device peak FLOP/s: the device-name table, else the nominal
    fallback."""
    kind = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
    for key, tf in sorted(_PEAK_TFLOPS.items(), key=lambda kv: -len(kv[0])):
        if kind.startswith(key):
            return tf * 1e12
    return _FALLBACK_PEAK


def _part(a: Any) -> Any:
    """One argument's part of a shape key: an array's shape; a Python
    number is a 0-d argument (a slot index, a depth: the JAX engine passes
    those as 0-d arrays), a bool or string its value; anything else (the
    params, a cache) ``*``."""
    shape = getattr(a, "shape", None)
    if shape is not None:
        return tuple(int(d) for d in shape)
    if isinstance(a, (bool, str)):
        return a
    if isinstance(a, (int, float)):
        return ()
    return "*"


def _shape_key(args: tuple, kwargs: dict) -> tuple:
    """Cheap per-dispatch shape fingerprint of the top-level arguments;
    nested trees (params, caches) are summarized as ``*``."""
    return tuple([_part(a) for a in args]
                 + [(k, _part(kwargs[k])) for k in sorted(kwargs)])


class _ProgramStats:
    """Cumulative ledger of one wrapped program (one writer, the
    dispatching thread; snapshot readers tolerate torn reads)."""

    __slots__ = ("program", "dispatches", "wall_s", "sampled_s",
                 "sampled_n", "compile_s", "compiles", "shapes",
                 "tokens", "flops_per_token", "pending")

    def __init__(self, program: str):
        self.program = program
        self.dispatches = 0
        self.wall_s = 0.0
        self.sampled_s = 0.0        # device time of the samples read
        self.sampled_n = 0          # samples read
        self.compile_s = 0.0        # wall time of first-seen shapes
        self.compiles = 0           # distinct argument-shape keys seen
        self.shapes: set = set()
        self.tokens = 0
        self.flops_per_token = 0.0
        self.pending: List[tuple] = []   # CUDA event pairs not yet read

    def device_seconds(self) -> float:
        """Extrapolated device time: sampled mean x all dispatches.
        Until the first sample is read, dispatch wall time stands in."""
        if self.sampled_n:
            return self.sampled_s * (self.dispatches
                                     / max(1, self.sampled_n))
        return self.wall_s

    def mfu(self, peak: float) -> Optional[float]:
        dev = self.device_seconds()
        if not self.flops_per_token or not self.tokens or dev <= 0 \
                or peak <= 0:
            return None
        return (self.tokens * self.flops_per_token) / dev / peak


class DispatchProfiler:
    """Wrap-once timing shims over a set of named programs that run on
    ``device`` (CUDA events there; wall time on the CPU)."""

    def __init__(self, device: Optional[torch.device] = None):
        self._cuda = device is not None and torch.device(device).type \
            == "cuda"
        self._stats: Dict[str, _ProgramStats] = {}
        self._lock = threading.Lock()

    def _stat(self, program: str) -> _ProgramStats:
        st = self._stats.get(program)
        if st is None:
            with self._lock:
                st = self._stats.setdefault(program,
                                            _ProgramStats(program))
        return st

    def _read_samples(self, st: _ProgramStats) -> None:
        """Fold in the event pairs the device has completed; pairs still
        in flight stay pending.  Never waits."""
        with self._lock:
            left = []
            for start, end in st.pending:
                if end.query():
                    st.sampled_s += start.elapsed_time(end) / 1e3
                    st.sampled_n += 1
                else:
                    left.append((start, end))
            st.pending = left

    def wrap(self, program: str, fn: Callable) -> Callable:
        """Return ``fn`` timed under ``program``.  Idempotent: a callable
        that is already a profiler shim is unwrapped to the original
        first."""
        inner = getattr(fn, "_rt_profiled_inner", None)
        if inner is not None:
            fn = inner
        st = self._stat(program)

        def dispatch(*args, **kwargs):
            key = _shape_key(args, kwargs)
            novel = key not in st.shapes
            sample = not novel and (st.dispatches + 1) % _SAMPLE_EVERY == 0
            events = None
            if sample and self._cuda:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            st.dispatches += 1
            st.wall_s += dt
            if novel:
                # the first dispatch of a shape pays the one-time costs;
                # kept out of the samples so MFU is steady-state
                st.shapes.add(key)
                st.compiles += 1
                st.compile_s += dt
            elif events is not None:
                events[1].record()
                with self._lock:
                    st.pending.append(events)
                self._read_samples(st)
            elif sample:
                st.sampled_s += dt
                st.sampled_n += 1
            return out

        dispatch._rt_profiled_inner = fn
        dispatch._rt_profiler = self
        dispatch.__name__ = getattr(fn, "__name__", program)
        return dispatch

    # ---------------------------------------------------------- feeding
    def note_tokens(self, program: str, n: int) -> None:
        """Credit ``n`` processed tokens to ``program``: host-known counts
        (batch occupancy, chunk width), never a device read."""
        if n > 0:
            self._stat(program).tokens += n

    def set_flops_per_token(self, program: str, flops: float) -> None:
        self._stat(program).flops_per_token = float(flops or 0.0)

    # --------------------------------------------------------- snapshot
    def wall_seconds(self) -> Dict[str, float]:
        """program -> cumulative dispatch wall seconds (the engine thread
        is occupied for the whole dispatch)."""
        with self._lock:
            return {p: s.wall_s for p, s in self._stats.items()}

    def snapshot(self, peak: Optional[float] = None) -> List[dict]:
        """Cumulative per-program rows."""
        pk = peak if peak is not None else peak_flops()
        with self._lock:
            stats = list(self._stats.values())
        rows = []
        for st in sorted(stats, key=lambda s: s.program):
            if st.pending:
                self._read_samples(st)
            mfu = st.mfu(pk)
            rows.append({
                "program": st.program,
                "dispatches": st.dispatches,
                "wall_s": round(st.wall_s, 6),
                "device_s": round(st.device_seconds(), 6),
                "compile_s": round(st.compile_s, 6),
                "compiles": st.compiles,
                "shapes": len(st.shapes),
                "tokens": st.tokens,
                "mfu": None if mfu is None else round(mfu, 6),
            })
        return rows
