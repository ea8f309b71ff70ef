"""Stateful KV-cache decode sessions for a serve replica (counterpart of
``ray_tpu/serve/decode_session.py``).

Two decode data planes live here, as in the JAX package:

* **Continuous-batching engine** (default): a fixed-slot batched KV cache
  (`models.init_slot_cache`) and one decode step shared by every live
  session (`step_graph.FusedDecodeStep`: on the card one CUDA graph,
  captured once per engine at ``[max_slots]`` and replayed every step).
  A background thread decodes all active slots each iteration; sessions
  join and leave between steps.  Decoded tokens land in per-session
  bounded queues that clients drain with ``next_chunk``.  Inside the loop:

  - **Chunked-prefill admission**: a joining session's prompt is consumed
    ``[1, chunk]`` tokens at a time between shared decode steps
    (`models.prefill_chunk`), then ``[1, 1]`` tail steps; admission,
    failover resume (``op: resume``) and the ``engine=False`` path's
    ``prefill_chunk > 0`` run the same chunk function.
  - **Shared-prefix reuse**: a prompt sharing a prefix with a slot's
    prompt copies those K/V rows (`models.cache_gather_slot`) and
    prefills only its suffix.
  - **Speculative decoding** (``DecodeEngineConfig.spec_draft``): a draft
    proposes ``spec_k`` tokens per slot (`models.draft_propose_slots`) and
    the target verifies them in one ``spec_k``-wide forward
    (`models.verify_step_slots`); acceptance is exact-match, so streams
    stay identical to plain decode, and any draft/verify fault falls back
    to a plain step.  Draft and verify run eagerly.

* **Eager per-call path** (``engine=False`` only): the pop-as-lease
  session table, one whole-prompt `models.prefill` (the flash kernel) per
  ``start`` and one `models.decode_step` per ``next``.

The engine feeds the JAX engine's serve series
(`core.runtime_metrics`: tokens, prefill chunks, prefix hits and tokens
reused, speculative tokens proposed and accepted, the acceptance ratio,
the batch occupancy histogram), records its spans (`util.tracing`:
``serve_prefill_chunk::``, ``serve_admission::``, ``serve_spec_fallback::``,
``serve_spec_verify::`` and ``serve_decode_step::<name>``) and honours the
chaos site ``serve.spec_verify`` (`util.fault_injection`), all on the host
around the device work, with no read of the device of their own.  The
nodelet metrics push and the replica context wait for the port's runtime.
"""

from __future__ import annotations

import atexit
import collections
import dataclasses
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.runtime_metrics import (SERVE_DECODE_OCCUPANCY,
                                    SERVE_PREFILL_CHUNKS, SERVE_PREFIX_HITS,
                                    SERVE_PREFIX_TOKENS_REUSED,
                                    SERVE_SPEC_ACCEPTANCE,
                                    SERVE_SPEC_ACCEPTED, SERVE_SPEC_PROPOSED,
                                    SERVE_TOKENS)
from ..device import DeviceLike, resolve_device
from ..exceptions import ReplicaUnavailableError
from ..models import (cache_gather_slot, cache_insert_slot, decode_step,
                      draft_propose_slots, engine_flops_table, init_kv_cache,
                      init_params, init_slot_cache, prefill, prefill_chunk,
                      prefill_chunked, verify_step_slots)
from ..util import fault_injection as fi
from ..util import tracing
from ..util.device_profile import DispatchProfiler
from .config import DecodeEngineConfig
from .prefix_cache import PrefixIndex
from .step_graph import FusedDecodeStep

#: live engines, stopped at interpreter exit: a thread still launching work
#: while the interpreter tears down can crash the process, so every loop is
#: stopped and joined before the runtime goes away
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _shutdown_engines() -> None:
    for eng in list(_ENGINES):
        try:
            eng.shutdown()
            t = eng._thread
            if t is not None and t.is_alive():
                t.join(timeout=5.0)
        except Exception:
            pass


class _EngineSession:
    """One live session inside the engine, through three phases:
    *prefilling* (the engine thread consumes its prompt one chunk at a
    time, between decode steps), *waiting* (prompt prefilled into a
    batch-1 cache, first token produced, queued for a free slot), and
    *decoding* (cache inserted into its slot of the shared cache)."""

    __slots__ = ("sid", "slot", "queue", "first_tok", "last_tok", "pos",
                 "done", "error", "ended", "seq", "last_poll",
                 "prompt", "poff", "pcache", "dcache", "plogits",
                 "ready", "shed", "ptoks", "t_enq", "t_pf", "t_ready")

    def __init__(self, sid: str, prompt: torch.Tensor, seq_base: int = 0):
        self.sid = sid
        self.t_enq = time.monotonic()  # enqueued for chunked admission
        self.t_pf: Optional[float] = None     # first prefill chunk ran
        self.t_ready: Optional[float] = None  # first token produced
        # host copy of the prompt tokens: the shared-prefix index key
        self.ptoks: tuple = ()
        self.slot: Optional[int] = None
        self.queue: collections.deque = collections.deque()
        # the token the prefill gave, which the start reply carries (the
        # loop may have decoded past it by the time the caller wakes)
        self.first_tok: Optional[int] = None
        self.last_tok: Optional[int] = None  # set when prefill completes
        self.pos = 0                  # host mirror of the cache's pos
        self.done = False             # no more tokens will be produced
        self.error: Optional[str] = None
        self.ended = False            # client sent `end`
        # seq of the next token to be delivered (the start/resume reply
        # carries token seq_base): replies stamp their first token's seq
        # so a failover client can dedupe replayed tokens
        self.seq = seq_base + 1
        self.last_poll = time.monotonic()  # idle-reaper clock
        # ---- chunked-admission state (cleared once decoding) ----
        self.prompt = prompt          # [1, S] int64 still to prefill
        self.poff = 0                 # tokens consumed so far
        self.pcache: Any = None       # target batch-1 cache being built
        self.dcache: Any = None       # draft batch-1 cache (speculating)
        self.plogits: Any = None      # last chunk's final-position logits
        self.ready = False            # first token produced
        self.shed = False             # drained mid-admission


class ContinuousBatchingEngine:
    """Replica-resident continuous-batching decode loop.

    All slot-cache mutation happens on the engine thread, between steps:
    callers only enqueue admissions and drain token queues under the
    engine's condition variable.  On a CUDA device the thread runs on its
    own stream and synchronizes once a step, to read the step's tokens
    (and once more when an admission's last chunk gives its first
    token)."""

    def __init__(self, cfg, max_len: int, params: Any,
                 engine_cfg: DecodeEngineConfig, name: str = "decode",
                 replica_tag: str = "local"):
        self.cfg = cfg
        self.max_len = max_len
        self.params = params
        self.ecfg = engine_cfg
        self.name = name or "decode"
        self._tag = replica_tag
        self.device = params["embed"]["tok"].device
        # ---- dispatch profiler (util/device_profile.py) ----
        self._prof = DispatchProfiler(device=self.device)
        self._insert = self._prof.wrap("cache_insert", cache_insert_slot)
        self._chunk = self._prof.wrap("prefill_chunk", prefill_chunk)
        self._fused: Optional[FusedDecodeStep] = None   # made with the cache
        self._step = None
        # ---- shared-prefix KV reuse (engine thread only) ----
        self._prefix = None
        self._gather = None
        if engine_cfg.prefix_cache:
            self._prefix = PrefixIndex()
            self._gather = self._prof.wrap("prefix_gather",
                                           cache_gather_slot)
        self.prefix_hits = 0           # admissions seeded from a donor
        self.prefix_tokens_reused = 0  # prefill tokens skipped
        # ---- speculative decoding ----
        self._spec = False
        self._draft_cfg = None
        self._draft_params = None
        spec = engine_cfg.spec_draft
        if spec:
            if spec in ("shared", True):
                self._draft_cfg, self._draft_params = cfg, params
            elif isinstance(spec, tuple):
                self._draft_cfg, self._draft_params = spec
            else:   # a bare TransformerConfig: fresh seed-0 params (tests)
                self._draft_cfg = spec
                gen = torch.Generator(device=self.device).manual_seed(0)
                self._draft_params = init_params(spec, gen, self.device)
            if self._draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {self._draft_cfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size}: proposals must be target "
                    f"token ids")
            self._spec = True
            self._draft = self._prof.wrap("draft_propose",
                                          draft_propose_slots)
            self._verify = self._prof.wrap("verify", verify_step_slots)
        self._spec_k = max(2, int(engine_cfg.spec_k))
        self._spec_disabled = False
        self._spec_fail_streak = 0
        self.spec_proposed = 0   # draft tokens offered to verification
        self.spec_accepted = 0   # draft tokens the target agreed with
        self.spec_fallbacks = 0  # iterations degraded to plain decode
        self._cache = None            # allocated by the loop on first start
        self._dcache = None           # draft slot cache (speculating)
        self._fatal: Optional[str] = None   # the loop could not start
        self._shapes: set = set()     # distinct program shapes run
        self._cond = threading.Condition()
        self.sessions: Dict[str, _EngineSession] = {}  # insertion = LRU
        self._pending: List[_EngineSession] = []   # prefilled, want slot
        self._prefilling: List[_EngineSession] = []
        self._free: List[int] = list(range(engine_cfg.max_slots))
        self._slots: Dict[int, _EngineSession] = {}
        self._next_sid = 0
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._draining = False   # replica evacuating: hand sessions off
        self.steps = 0
        self.tokens = 0
        self.reaped = 0          # sessions evicted by the idle reaper
        self.prefill_chunks = 0  # chunk programs run for admissions
        # analytic FLOPs/token per program: the profiler's MFU numerators
        for prog, f in engine_flops_table(
                cfg, max_len, draft_cfg=self._draft_cfg).items():
            self._prof.set_flops_per_token(prog, f)
        # phase accumulators (queue: enqueue -> first prefill chunk;
        # admission: first token -> decode slot)
        self.phase_s = {"queue": 0.0, "admission": 0.0}

    @property
    def graph_replays(self) -> int:
        """Launches of the captured decode-step graph (0 on the CPU)."""
        return self._fused.replays if self._fused is not None else 0

    # ------------------------------------------------------------ client ops

    def start(self, prompt: torch.Tensor, max_sessions: int,
              seq_base: int = 0, teacher_forced: bool = False,
              ptoks: Optional[tuple] = None) -> Dict[str, Any]:
        """Enqueue one batch-1 prompt [1, S] for chunked admission and
        block until the engine thread has prefilled it (``[1, chunk]``
        blocks, then ``[1, 1]`` tail steps, between shared decode steps).
        Returns the sid and first token; the remaining tokens flow once a
        slot frees.

        ``teacher_forced`` marks failover resume: ``prompt`` is the replay
        prefix (original prompt + every token already delivered) and the
        token seqs continue from ``seq_base``."""
        s_len = int(prompt.shape[1])
        if s_len > self.max_len:
            raise ValueError(f"prompt length {s_len} exceeds cache "
                             f"capacity {self.max_len}")
        prompt = torch.as_tensor(prompt, dtype=torch.long).cpu()
        if ptoks is None and self._prefix is not None:
            ptoks = tuple(int(t) for t in prompt[0].tolist())
        if self.device.type == "cuda":
            # page-locked, so the engine thread copies it to the card
            # asynchronously on its own stream
            prompt = prompt.pin_memory()
        with self._cond:
            if self._fatal is not None:
                raise RuntimeError(self._fatal)
            if self._draining:
                raise ReplicaUnavailableError(self.name)
            if not self._free and \
                    len(self._pending) + len(self._prefilling) \
                    >= self.ecfg.max_waiting:
                raise ReplicaUnavailableError(self.name)
            sid = f"{self._tag}:{self._next_sid}"
            self._next_sid += 1
            sess = _EngineSession(sid, prompt, seq_base=seq_base)
            sess.ptoks = ptoks or ()
            # LRU bound on abandoned sessions: evict the oldest slot-less
            # finished session (ended clients pop themselves)
            while len(self.sessions) >= max_sessions:
                victim = next((s for s in self.sessions.values()
                               if s.slot is None and s.done), None)
                if victim is None:
                    break
                self.sessions.pop(victim.sid)
            self.sessions[sid] = sess
            self._prefilling.append(sess)
            self._ensure_thread()
            self._cond.notify_all()
            deadline = time.monotonic() + \
                max(1.0, self.ecfg.admission_timeout_s)
            while not sess.ready and sess.error is None \
                    and not sess.shed and not sess.done:
                left = deadline - time.monotonic()
                if left <= 0 or self._shutdown:
                    sess.done = True
                    sess.ended = True
                    self.sessions.pop(sid, None)
                    raise ReplicaUnavailableError(self.name)
                self._cond.wait(min(left, 1.0))
            if sess.shed:     # drain began mid-admission: typed shed
                raise ReplicaUnavailableError(self.name)
            if sess.error is not None:
                raise RuntimeError(sess.error)
            if not sess.ready:   # reaped or force-ended mid-admission
                self.sessions.pop(sid, None)
                raise ReplicaUnavailableError(self.name)
            reply = {"sid": sid, "token": [sess.first_tok],
                     "proto": "chunk", "seq": seq_base}
            if sess.done:
                reply["done"] = True  # the prompt filled the cache
        return reply

    def next_chunk(self, sid: str, max_tokens: int = 16,
                   timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Drain up to ``max_tokens`` buffered tokens (blocking until at
        least one is available, the session finishes, or the timeout).
        Once one token is buffered, lingers ``chunk_linger_s`` for the
        chunk to fill."""
        max_tokens = max(1, int(max_tokens))
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.ecfg.chunk_timeout_s)
        linger_deadline = None
        with self._cond:
            sess = self.sessions.get(sid)
            if sess is None:
                return {"error": f"unknown session {sid!r} (ended, "
                                 f"evicted, or never started)"}
            sess.last_poll = time.monotonic()
            while True:
                if sess.error is not None:
                    return {"error": sess.error, "done": True}
                if self._draining:
                    break   # hand off what is buffered, don't wait
                if len(sess.queue) >= max_tokens or \
                        (sess.queue and sess.done):
                    break
                now = time.monotonic()
                if sess.queue:
                    if linger_deadline is None:
                        linger_deadline = now + self.ecfg.chunk_linger_s
                    if now >= linger_deadline:
                        break
                    wait = min(linger_deadline, deadline) - now
                else:
                    if sess.done:
                        return {"tokens": [], "done": True,
                                "seq": sess.seq}
                    wait = deadline - now
                if wait <= 0:
                    break
                self._cond.wait(wait)
            first_seq = sess.seq
            toks = [sess.queue.popleft()
                    for _ in range(min(len(sess.queue), max_tokens))]
            sess.seq += len(toks)
            done = sess.done and not sess.queue
            out = {"tokens": toks, "done": done, "seq": first_seq}
            if self._draining and not done:
                # replica evacuating: deliver the buffered tokens and hand
                # the session over (the client resumes it elsewhere)
                out["migrating"] = True
                sess.done = True
                sess.ended = True
                self.sessions.pop(sid, None)
            # draining may un-pause a slot whose queue was full
            self._cond.notify_all()
        return out

    def end(self, sid: str) -> bool:
        with self._cond:
            sess = self.sessions.pop(sid, None)
            if sess is None:
                return False
            sess.ended = True
            sess.done = True
            self._cond.notify_all()   # the loop vacates the slot
        return True

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            prop, acc = self.spec_proposed, self.spec_accepted
            return {"max_slots": self.ecfg.max_slots,
                    "occupied_slots": len(self._slots),
                    "waiting": len(self._pending),
                    "prefilling": len(self._prefilling),
                    "sessions": len(self.sessions),
                    "live_sessions": self._live_locked(),
                    "draining": self._draining,
                    "reaped": self.reaped,
                    "steps": self.steps, "tokens": self.tokens,
                    "prefill_chunks": self.prefill_chunks,
                    "graph_replays": self.graph_replays,
                    # every distinct program shape this engine has run: a
                    # count growing with traffic would be a regression
                    "program_shapes": sorted(
                        "%s:%s" % (k[0], "x".join(str(d) for d in k[1:]))
                        for k in self._shapes),
                    "distinct_program_shapes": len(self._shapes),
                    "prefix": dict(
                        (self._prefix.stats() if self._prefix is not None
                         else {"entries": 0, "hits": 0, "misses": 0,
                               "hit_rate": None, "tokens_matched": 0}),
                        applied_hits=self.prefix_hits,
                        tokens_reused=self.prefix_tokens_reused),
                    "spec": {"enabled": self._spec,
                             "disabled": self._spec_disabled,
                             "k": self._spec_k,
                             "proposed": prop, "accepted": acc,
                             "acceptance":
                                 round(acc / prop, 4) if prop else None,
                             "fallbacks": self.spec_fallbacks},
                    "device_profile": self._prof.snapshot(),
                    "phase_totals": self.phase_totals()}

    def phase_totals(self) -> Dict[str, float]:
        """Cumulative serve-phase seconds: queue and admission from the
        sessions' marks, prefill and decode from the profiler's dispatch
        wall times (the engine thread's occupancy)."""
        wall = self._prof.wall_seconds()
        prefill_s = sum(wall.get(p, 0.0)
                        for p in ("prefill_chunk", "prefix_gather"))
        decode_s = sum(wall.get(p, 0.0)
                       for p in ("decode_step", "draft_propose", "verify",
                                 "cache_insert"))
        return {"queue": round(self.phase_s["queue"], 6),
                "admission": round(self.phase_s["admission"], 6),
                "prefill": round(prefill_s, 6),
                "decode_dispatch": round(decode_s, 6)}

    def _live_locked(self) -> int:
        """Sessions a client may still come back for (not `end`ed)."""
        return sum(1 for s in self.sessions.values() if not s.ended)

    def begin_drain(self) -> int:
        """Enter drain mode: shed new starts and resumes with
        ReplicaUnavailableError, stop stepping, and hand every live
        session off on its next `next_chunk` poll (buffered tokens are
        still delivered, with a ``migrating`` flag).  Sessions still
        mid-prefill are shed the same typed way.  Returns the number of
        sessions awaiting handoff."""
        with self._cond:
            self._draining = True
            for sess in self._prefilling:
                sess.shed = True
                sess.done = True
                sess.ended = True
                sess.pcache = sess.dcache = sess.plogits = None
                self.sessions.pop(sess.sid, None)
            self._prefilling.clear()
            n = self._live_locked()
            self._cond.notify_all()   # wake blocked next_chunk waits
        return n

    def live_sessions(self) -> int:
        with self._cond:
            return self._live_locked()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    # ------------------------------------------------------------ engine loop

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            _ENGINES.add(self)
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"decode-engine:{self.name}")
            self._thread.start()

    def _reap_locked(self) -> None:
        """Vacate the slots of ended or finished sessions (between steps),
        and evict sessions whose client stopped polling."""
        ttl = self.ecfg.session_idle_ttl_s or 0.0
        if ttl > 0:
            now = time.monotonic()
            for sid, sess in list(self.sessions.items()):
                if not sess.ended and now - sess.last_poll > ttl:
                    sess.done = True      # slot vacated just below
                    sess.ended = True
                    self.sessions.pop(sid, None)
                    self.reaped += 1
        for slot, sess in list(self._slots.items()):
            if sess.done:
                del self._slots[slot]
                sess.slot = None
                self._free.append(slot)
                # the prefix index keeps a freed slot's entry: nothing
                # writes rows below its pos until the slot is reassigned
                # (an inactive slot writes only at pos and past it)

    def _admit_locked(self) -> List[Tuple[_EngineSession, Any, Any, int]]:
        admitted = []
        if self._draining:
            return admitted   # evacuating: no new slot occupancy
        while self._free and self._pending:
            sess = self._pending.pop(0)
            if sess.ended or sess.done:
                sess.pcache = sess.dcache = None
                continue              # ended while waiting
            slot = self._free.pop()
            sess.slot = slot
            self._slots[slot] = sess
            if sess.t_ready is not None:   # admission phase: first
                self.phase_s["admission"] += \
                    time.monotonic() - sess.t_ready  # token -> slot
            if self._prefix is not None:
                # slot reclaim is the eviction point: the insert below
                # overwrites the rows the slot advertised
                self._prefix.evict(slot)
                if sess.ptoks:
                    self._prefix.insert(sess.ptoks, slot)
            admitted.append((sess, sess.pcache, sess.dcache, slot))
            sess.pcache = sess.dcache = None
        return admitted

    def _collect_locked(self) -> List[_EngineSession]:
        """Slots decoding this step: live sessions with queue room.  A
        draining engine stops stepping."""
        if self._draining:
            return []
        return [s for s in self._slots.values()
                if not s.done and
                len(s.queue) < self.ecfg.token_queue_depth]

    def _shape_seen(self, kind: str, *dims) -> None:
        """Record one program shape run (engine thread only)."""
        self._shapes.add((kind,) + tuple(int(d) for d in dims))

    def _prefill_advance(self, sess: _EngineSession) -> Optional[int]:
        """Run one chunk of a joining session's prompt (target, and draft
        when speculating) on the engine thread.  Returns the session's
        first token once the prompt is consumed, else None."""
        if sess.pcache is None:
            sess.prompt = sess.prompt.to(self.device, non_blocking=True)
            seeded = False
            if self._prefix is not None and sess.ptoks:
                # the longest prefix this prompt shares with a slot's
                # prompt is already in the slot cache: copy those rows and
                # prefill only the suffix.  Cap at len - 1: the last prompt
                # token's logits must be computed for the first token.
                donor, depth = self._prefix.longest_match(
                    sess.ptoks, cap=len(sess.ptoks) - 1)
                if donor is not None and \
                        depth >= max(1, self.ecfg.prefix_cache_min_tokens):
                    sess.pcache = self._gather(self._cache, donor, depth)
                    if self._spec:
                        sess.dcache = self._gather(self._dcache, donor,
                                                   depth)
                    sess.poff = depth
                    seeded = True
                    with self._cond:   # stats() reads these counters
                        self.prefix_hits += 1
                        self.prefix_tokens_reused += depth
                    self._shape_seen("prefix_gather", 1)
                    SERVE_PREFIX_HITS.inc(tags={"deployment": self.name})
                    SERVE_PREFIX_TOKENS_REUSED.inc(
                        depth, tags={"deployment": self.name})
            if not seeded:
                sess.pcache = init_kv_cache(self.cfg, 1, self.max_len,
                                            self.device)
                if self._spec:
                    sess.dcache = init_kv_cache(self._draft_cfg, 1,
                                                self.max_len, self.device)
        chunk = max(1, int(self.ecfg.prefill_chunk_tokens))
        n = int(sess.prompt.shape[1])
        off = sess.poff
        take = chunk if n - off >= chunk else 1
        toks = sess.prompt[:, off:off + take]
        if sess.t_pf is None:          # the queue phase ends at the first
            sess.t_pf = time.monotonic()  # chunk of the prompt
            self.phase_s["queue"] += sess.t_pf - sess.t_enq
        t0 = time.time()
        sess.plogits, sess.pcache = self._chunk(self.params, toks,
                                                sess.pcache, cfg=self.cfg)
        self._shape_seen("prefill_chunk", 1, take)
        if self._spec:
            _, sess.dcache = self._chunk(self._draft_params, toks,
                                         sess.dcache, cfg=self._draft_cfg)
            self._shape_seen("draft_prefill_chunk", 1, take)
        sess.poff = off + take
        self._prof.note_tokens("prefill_chunk", take)
        with self._cond:   # stats() reads this counter
            self.prefill_chunks += 1
        SERVE_PREFILL_CHUNKS.inc(tags={"deployment": self.name})
        tracing.record_span(f"serve_prefill_chunk::{self.name}", "serve",
                            t0, time.time(), tokens=take,
                            deployment=self.name)
        if sess.poff < n:
            return None
        return int(torch.argmax(sess.plogits, dim=-1)[0])

    def _spec_step(self, tokens: np.ndarray, active: np.ndarray):
        """One speculative iteration over the whole batch: the draft
        proposes ``spec_k`` tokens per slot and the target verifies the
        pending token and ``spec_k - 1`` proposals in one forward.
        Returns host arrays ``(greedy [S, spec_k], accepted [S])``; raises
        on any draft/verify fault, leaving ``pos`` as it was (it is
        committed last), so the loop continues with a plain step.  The
        chaos site ``serve.spec_verify`` sleeps here (delay, latency) or
        raises (any other action)."""
        if fi.ACTIVE is not None:
            act = fi.ACTIVE.point("serve.spec_verify", self.name)
            if act is not None:
                if act["action"] in ("delay", "latency"):
                    time.sleep(max(0.0, act["delay_s"]))
                else:
                    raise RuntimeError(
                        f"chaos: injected spec_verify failure for "
                        f"{self.name}")
        self._fused.load(tokens, active)
        tok, act = self._fused.tok, self._fused.active
        # the draft cache's pos is re-synced from the target every
        # iteration: its rejected writes sit past the true pos and are
        # rewritten before any masked read
        dcache = {"k": self._dcache["k"], "v": self._dcache["v"],
                  "pos": self._cache["pos"]}
        # the draft runs spec_k steps but only spec_k - 1 proposals are
        # verified: the last step's K/V write keeps the draft cache whole
        # when every proposal is accepted
        props, _ = self._draft(self._draft_params, tok, dcache, act,
                               cfg=self._draft_cfg, k=self._spec_k)
        self._shape_seen("draft_propose", len(tokens), self._spec_k)
        props = props[:, :self._spec_k - 1]
        fed = torch.cat([tok[:, None], props], dim=1)
        greedy, accepted, new_cache = self._verify(
            self.params, fed, props, self._cache, act, cfg=self.cfg)
        self._shape_seen("verify", len(tokens), self._spec_k)
        # one device-to-host read; the commit of pos comes after it
        host = torch.cat([greedy, accepted[:, None]], dim=1).cpu().numpy()
        self._cache["pos"].copy_(new_cache["pos"])
        return host[:, :-1], host[:, -1]

    def _setup(self) -> None:
        """Allocate the slot caches and make the decode step (captured as
        a CUDA graph on the card)."""
        self._cache = init_slot_cache(self.cfg, self.ecfg.max_slots,
                                      self.max_len, self.device)
        if self._spec:
            self._dcache = init_slot_cache(
                self._draft_cfg, self.ecfg.max_slots, self.max_len,
                self.device)
        self._fused = FusedDecodeStep(self.params, self._cache, self.cfg)
        if self._fused.cuda:
            self._fused.capture()
        self._step = self._prof.wrap("decode_step", self._fused.run)

    def _loop(self) -> None:
        if self.device.type != "cuda":
            self._run()
            return
        torch.cuda.set_device(self.device)
        # the parameters were written on another thread's stream
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(torch.cuda.Stream(device=self.device)):
            self._run()

    def _fail_all(self, error: str) -> None:
        with self._cond:
            self._fatal = error
            for sess in self.sessions.values():
                sess.error = error
                sess.done = True
            self._cond.notify_all()

    def _run(self) -> None:
        if self._cache is None:
            try:
                self._setup()
            except Exception as e:
                self._fail_all(f"decode engine setup failed: {e!r}")
                return
        slots = self.ecfg.max_slots
        tokens = np.zeros(slots, np.int64)
        while True:
            with self._cond:
                while not self._shutdown:
                    self._reap_locked()
                    self._prefilling = [
                        s for s in self._prefilling
                        if not (s.ready or s.done or s.ended or s.shed)]
                    admitted = self._admit_locked()
                    prefills = ([] if self._draining
                                else list(self._prefilling))
                    batch = self._collect_locked()
                    if admitted or prefills or batch:
                        break
                    self._cond.wait(0.5)
                if self._shutdown:
                    return
                active = np.zeros(slots, bool)
                for s in batch:
                    active[s.slot] = True
                    tokens[s.slot] = s.last_tok
            # ---- device work, outside the lock (nobody else touches the
            # slot cache, and client ops must not stall on compute)
            t0 = time.time()
            for sess, pcache, dcache, slot in admitted:
                self._insert(self._cache, pcache, slot)
                if self._spec and dcache is not None:
                    self._insert(self._dcache, dcache, slot)
            # one chunk per joining session per iteration: prompts are
            # consumed between decode steps, never ahead of the batch
            ready: List[Tuple[_EngineSession, int]] = []
            for sess in prefills:
                try:
                    first = self._prefill_advance(sess)
                    if first is not None:
                        ready.append((sess, first))
                except Exception as e:
                    with self._cond:
                        sess.error = f"chunked prefill failed: {e!r}"
                        sess.done = True
                        sess.ready = True
                        sess.pcache = sess.dcache = sess.plogits = None
                        self._cond.notify_all()
            if ready:
                now = time.monotonic()
                now_wall = time.time()
                with self._cond:
                    for sess, first in ready:
                        sess.t_ready = now
                        # the admission span: enqueue -> first token
                        tracing.record_span(
                            f"serve_admission::{self.name}", "serve",
                            now_wall - (now - sess.t_enq), now_wall,
                            sid=sess.sid, deployment=self.name)
                        sess.first_tok = sess.last_tok = first
                        sess.pos = sess.poff
                        sess.ready = True
                        sess.prompt = sess.plogits = None
                        if sess.pos >= self.max_len or sess.ended:
                            sess.done = True  # nothing left to decode
                            sess.pcache = sess.dcache = None
                        else:
                            self._pending.append(sess)
                    self._cond.notify_all()
            if not batch:
                continue          # admissions/prefill only: step next round
            spec_out = None
            if self._spec and not self._spec_disabled:
                try:
                    spec_out = self._spec_step(tokens, active)
                    self._spec_fail_streak = 0
                except Exception as e:
                    with self._cond:   # stats() reads these
                        self.spec_fallbacks += 1
                        self._spec_fail_streak += 1
                        if self._spec_fail_streak >= \
                                max(1, self.ecfg.spec_fail_disable):
                            self._spec_disabled = True
                    tracing.record_span(
                        f"serve_spec_fallback::{self.name}", "serve",
                        t0, time.time(), error=repr(e),
                        deployment=self.name)
            if spec_out is None:
                try:
                    new_toks = self._step(tokens, active)
                    self._shape_seen("decode_step", len(tokens))
                    tokens[:] = new_toks
                except Exception as e:
                    with self._cond:
                        for s in batch:
                            s.error = f"decode engine step failed: {e!r}"
                            s.done = True
                        self._cond.notify_all()
                    continue
            occupancy = len(batch)
            now = time.time()   # the step's span ends after its token read
            # MFU numerators: useful tokens only (active slots)
            if spec_out is not None:
                self._prof.note_tokens("draft_propose",
                                       occupancy * self._spec_k)
                self._prof.note_tokens("verify", occupancy * self._spec_k)
                greedy, accepted = spec_out
                emitted = int(sum(accepted[s.slot] for s in batch))
                tracing.record_span(
                    f"serve_spec_verify::{self.name}", "serve", t0, now,
                    batch=occupancy,
                    proposed=(self._spec_k - 1) * occupancy,
                    emitted=emitted, deployment=self.name)
            else:
                self._prof.note_tokens("decode_step", occupancy)
                emitted = occupancy
                tracing.record_span(f"serve_decode_step::{self.name}",
                                    "serve", t0, now, batch=occupancy,
                                    deployment=self.name)
            SERVE_DECODE_OCCUPANCY.observe(occupancy,
                                           {"deployment": self.name})
            SERVE_TOKENS.inc(emitted, {"deployment": self.name})
            with self._cond:
                self.steps += 1
                self.tokens += emitted
                if spec_out is not None:
                    for s in batch:
                        n = int(accepted[s.slot])
                        toks = [int(t) for t in greedy[s.slot][:n]]
                        s.last_tok = toks[-1]
                        tokens[s.slot] = s.last_tok
                        s.pos += n
                        if not s.ended:
                            s.queue.extend(toks)
                        if s.pos >= self.max_len:
                            s.done = True
                    self.spec_proposed += (self._spec_k - 1) * occupancy
                    self.spec_accepted += emitted - occupancy
                else:
                    for s in batch:
                        tok = int(new_toks[s.slot])
                        s.last_tok = tok
                        s.pos += 1
                        if not s.ended:
                            s.queue.append(tok)
                        if s.pos >= self.max_len:
                            s.done = True  # cache full: reaped next turn
                self._cond.notify_all()
            if spec_out is not None:
                SERVE_SPEC_PROPOSED.inc((self._spec_k - 1) * occupancy,
                                        {"deployment": self.name})
                SERVE_SPEC_ACCEPTED.inc(emitted - occupancy,
                                        {"deployment": self.name})
                if self.spec_proposed:
                    SERVE_SPEC_ACCEPTANCE.set(
                        self.spec_accepted / self.spec_proposed,
                        {"deployment": self.name})


def _host_tokens(prompt) -> Optional[tuple]:
    """Prompt ints straight from the request payload (the prefix-index
    key).  None when the payload is not a host-side B=1 token list."""
    if not isinstance(prompt, (list, tuple)):
        return None
    try:
        p = prompt
        if p and isinstance(p[0], (list, tuple)):
            p = p[0]
        return tuple(int(t) for t in p)
    except (TypeError, ValueError, IndexError):
        return None


class DecodeSessionCore:
    """Session store + prefill/decode over one model.

    Protocol (msgpack/JSON-native), as the JAX package's:
      {"op": "start", "prompt": [S ints] | [[S ints]xB]} ->
          {"sid": str|int, "token": [B ints]} (+ {"proto": "chunk",
          "seq": 0} when the engine owns the session)
      {"op": "resume", "prompt": [S ints], "generated": [G ints]} ->
          as an engine start, with "seq": G: failover re-admission, a
          teacher-forced prefill of prompt + generated into a fresh slot;
          the token returned is the one the uninterrupted session would
          have produced next (greedy decode is deterministic)
      {"op": "next", "sid": ...} -> {"token": [B ints]}
      {"op": "next_chunk", "sid": str, "max_tokens": N} ->
          {"tokens": [<=N ints], "done": bool, "seq": first token's seq}
          (+ {"migrating": true} when the engine is draining)
      {"op": "end", "sid": ...} -> {"ended": bool}
      {"op": "stats"} -> session and engine counters

    Engine sessions (single-prompt starts) carry string sids
    ``<replica_tag>:<n>``.  B > 1 prompts on an engine core are admitted
    row by row as engine sessions behind a ``grp:<n>`` sid that keeps the
    one-reply-per-step shape.  Only ``engine=False`` cores run the eager
    integer-sid path: pop-as-lease (a second `next` on the same sid in
    flight, or an unknown, ended or evicted sid, gets an ``{"error": ...}``
    reply), at most ``max_sessions`` sessions kept, least recently used
    evicted; a `next` past ``max_len`` rewrites the cache's last row.
    """

    def __init__(self, cfg, max_len: int, seed: int = 0,
                 params: Any = None, max_sessions: int = 64,
                 prefill_chunk: int = 0, engine: Any = True,
                 device: DeviceLike = None):
        """``prefill_chunk > 0`` prefills the ``engine=False`` path in
        chunks of that size through `models.prefill_chunked` (dense, no
        flash kernel) and sets the engine's ``prefill_chunk_tokens``, so
        both paths share one chunk width.  ``engine`` is True (default),
        False, or a `DecodeEngineConfig`."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.max_sessions = max_sessions
        self.prefill_chunk = prefill_chunk
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self._lock = threading.Lock()
        self.sessions: Dict[int, Any] = {}   # insertion-ordered = LRU
        self._next_sid = 0
        # B > 1 prompts on an engine core: each row is its own engine
        # session behind one group sid
        self._groups: Dict[str, List[str]] = {}
        self._next_gid = 0
        if engine is False or engine is None:
            self._engine_cfg = None
        elif isinstance(engine, DecodeEngineConfig):
            self._engine_cfg = engine
        else:
            self._engine_cfg = DecodeEngineConfig()
        if self._engine_cfg is not None and prefill_chunk > 0:
            # one chunk width per replica for admission and resume
            self._engine_cfg = dataclasses.replace(
                self._engine_cfg, prefill_chunk_tokens=prefill_chunk)
        self._engine: Optional[ContinuousBatchingEngine] = None

    @property
    def engine(self) -> Optional[ContinuousBatchingEngine]:
        """The continuous-batching engine, created on first use (slot
        cache memory is only paid by cores that serve).  Creation is
        locked: two concurrent `start` ops must not make two engines.
        Inside a replica the engine takes its deployment's and replica's
        names (`replica.get_replica_context`); elsewhere, a gang member
        included, ``"decode"`` / ``"local"``."""
        if self._engine is None and self._engine_cfg is not None:
            with self._lock:
                if self._engine is None:
                    name, tag = "decode", "local"
                    try:
                        from .replica import get_replica_context
                        ctx = get_replica_context()
                        name, tag = ctx.deployment, ctx.replica_tag
                    except RuntimeError:
                        pass
                    self._engine = ContinuousBatchingEngine(
                        self.cfg, self.max_len, self.params,
                        self._engine_cfg, name=name, replica_tag=tag)
        return self._engine

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req["op"]
        if op == "start":
            prompt = torch.as_tensor(req["prompt"], dtype=torch.long)
            if prompt.ndim == 1:
                prompt = prompt[None]
            if self._engine_cfg is not None:
                if prompt.shape[0] == 1:
                    return self.engine.start(
                        prompt, self.max_sessions,
                        ptoks=_host_tokens(req["prompt"]))
                return self._group_start(prompt, req["prompt"])
            return self._legacy_start(prompt.to(self.device))
        if op == "resume":
            # failover re-admission: replay prompt + every token the client
            # already has through a teacher-forced chunked prefill into a
            # fresh slot, continuing seqs at len(generated)
            if self._engine_cfg is None:
                return {"error": "resume requires the continuous-"
                                 "batching engine (engine=False core)"}
            prompt = req["prompt"]
            if prompt and isinstance(prompt[0], (list, tuple)):
                prompt = prompt[0]     # batched form: the engine is B=1
            generated = list(req.get("generated") or [])
            replay = list(prompt) + generated
            return self.engine.start(
                torch.tensor([replay], dtype=torch.long), self.max_sessions,
                seq_base=len(generated), teacher_forced=True,
                ptoks=tuple(int(t) for t in replay))
        if op == "stats":
            out = {"legacy_sessions": len(self.sessions),
                   "groups": len(self._groups)}
            if self._engine is not None:
                out["engine"] = self._engine.stats()
            return out
        sid = req.get("sid")
        if isinstance(sid, str) and sid.startswith("grp:"):
            return self._group_op(op, sid)
        if op == "end":
            if isinstance(sid, str):
                if self._engine is None:
                    return {"ended": False}
                return {"ended": self._engine.end(sid)}
            with self._lock:
                return {"ended": self.sessions.pop(sid, None) is not None}
        if op == "next_chunk":
            if not isinstance(sid, str) or self._engine is None:
                # legacy sessions have no token queue: one step per call
                out = self._legacy_next(sid)
                if "error" in out:
                    return out
                return {"tokens": out["token"], "done": False}
            return self._engine.next_chunk(
                sid, req.get("max_tokens", 16), req.get("timeout_s"))
        # op == "next"
        if isinstance(sid, str) and self._engine is not None:
            out = self._engine.next_chunk(sid, 1)
            if "error" in out:
                return out
            if not out["tokens"]:
                return {"error": f"session {sid!r} finished "
                                 f"(cache capacity reached)"}
            reply = {"token": out["tokens"]}
            if out["done"]:
                reply["eos"] = True
            return reply
        return self._legacy_next(sid)

    def _group_start(self, prompt: torch.Tensor,
                     raw_prompt=None) -> Dict[str, Any]:
        """B > 1 prompts through the engine: each row its own session,
        behind a group sid whose `next` pops one token per member.  A
        member shed mid-admission releases the members already admitted
        and re-raises, so a group is all or nothing."""
        sids, toks = [], []
        try:
            for row in range(int(prompt.shape[0])):
                pt = None
                if raw_prompt is not None:
                    try:
                        pt = _host_tokens([raw_prompt[row]])
                    except (TypeError, IndexError):
                        pt = None
                out = self.engine.start(prompt[row:row + 1],
                                        self.max_sessions, ptoks=pt)
                sids.append(out["sid"])
                toks.extend(out["token"])
        except BaseException:
            for s in sids:
                self.engine.end(s)
            raise
        with self._lock:
            gid = f"grp:{self._next_gid}"
            self._next_gid += 1
            self._groups[gid] = sids
        return {"sid": gid, "token": toks}

    def _group_op(self, op: str, gid: str) -> Dict[str, Any]:
        with self._lock:
            sids = self._groups.get(gid)
        if sids is None or self._engine is None:
            return {"error": f"unknown session {gid!r} (ended, "
                             f"evicted, or never started)"}
        if op == "end":
            for s in sids:
                self._engine.end(s)
            with self._lock:
                self._groups.pop(gid, None)
            return {"ended": True}
        # next / next_chunk: one token for every member (rows share a
        # prompt length, so they reach the cache's end together)
        toks = []
        for s in sids:
            out = self._engine.next_chunk(s, 1)
            if "error" in out:
                return out
            if not out["tokens"]:
                return {"error": f"session {gid!r} finished "
                                 f"(cache capacity reached)"}
            toks.extend(out["tokens"])
        if op == "next_chunk":
            return {"tokens": toks, "done": False}
        return {"token": toks}

    def _legacy_start(self, prompt: torch.Tensor) -> Dict[str, Any]:
        cache = init_kv_cache(self.cfg, prompt.shape[0], self.max_len,
                              self.device)
        if self.prefill_chunk > 0:
            logits, cache = prefill_chunked(self.params, prompt, self.cfg,
                                            cache, chunk=self.prefill_chunk)
        else:
            logits, cache = prefill(self.params, prompt, self.cfg, cache)
        tok = torch.argmax(logits, dim=-1)
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self.sessions[sid] = (cache, tok)
            while len(self.sessions) > self.max_sessions:
                self.sessions.pop(next(iter(self.sessions)))
        return {"sid": sid, "token": tok.tolist()}

    def _legacy_next(self, sid) -> Dict[str, Any]:
        with self._lock:
            entry = self.sessions.pop(sid, None)
        if entry is None:
            return {"error": f"unknown session {sid!r} (ended, "
                             f"evicted, or decoding in another request)"}
        cache, tok = entry
        logits, cache = decode_step(self.params, tok, cache, self.cfg)
        tok = torch.argmax(logits, dim=-1)
        with self._lock:
            self.sessions[sid] = (cache, tok)
        return {"token": tok.tolist()}
