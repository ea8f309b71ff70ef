"""Knobs of the continuous-batching decode engine (counterpart of
``DecodeEngineConfig`` in ``ray_tpu/serve/config.py``; every field and
default the same)."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class DecodeEngineConfig:
    """Bounds of the replica-resident continuous-batching decode engine
    (`serve/decode_session.py`).  One fixed-slot batched KV cache and one
    decode step (a CUDA graph on the card) are shared by every live
    session; these bounds govern admission and token buffering."""
    # decode slots in the batched KV cache: the step's fixed batch size.
    # Sessions beyond this wait for a slot (iteration-level admission).
    max_slots: int = 8
    # per-session bounded token queue: the engine decodes ahead of the
    # client by at most this many tokens, then pauses the slot
    token_queue_depth: int = 64
    # sessions allowed to wait for a slot before `start` is rejected with
    # ReplicaUnavailableError
    max_waiting: int = 32
    # how long a `next_chunk` drain lingers for its chunk to fill once at
    # least one token is buffered
    chunk_linger_s: float = 0.025
    # server-side cap on one `next_chunk` wait with an empty queue
    chunk_timeout_s: float = 30.0
    # leak reaper: a session whose client has not polled for this long is
    # evicted and its slot reclaimed.  <= 0 disables the reaper.
    session_idle_ttl_s: float = 120.0
    # -- chunked-prefill admission ----------------------------------------
    # a joining session's prompt is consumed [1, chunk] tokens at a time
    # between shared decode steps on the engine thread (remainder in
    # [1, 1] tail steps); admission, failover resume and the legacy
    # prefill_chunked path run the same chunk function.  Matches
    # models.resume_prefill's default.
    prefill_chunk_tokens: int = 32
    # bound on one `start`/`resume` call: enqueue -> first token
    admission_timeout_s: float = 60.0
    # -- shared-prefix KV reuse -------------------------------------------
    # admission consults a radix trie over live slots' prompts
    # (serve/prefix_cache.py): a new session sharing a prefix with a
    # resident slot copies those K/V rows (`models.cache_gather_slot`) and
    # chunk-prefills only the unshared suffix
    prefix_cache: bool = True
    # minimum shared tokens worth a gather
    prefix_cache_min_tokens: int = 4
    # -- speculative decoding ---------------------------------------------
    # draft model proposing tokens for the target to verify in one batched
    # k-token forward.  None disables; "shared" weight-shares the target
    # (acceptance 1.0); a (TransformerConfig, params) tuple supplies a real
    # draft; a bare TransformerConfig gets fresh seed-0 params (tests).
    # Greedy verification is exact-match, so token streams stay identical
    # to plain decode whatever the draft.
    spec_draft: Any = None
    # draft steps per engine iteration (at least 2): the verify forward is
    # spec_k tokens wide, the pending token and spec_k - 1 proposals, so
    # each iteration emits 1..spec_k tokens per slot
    spec_k: int = 4
    # consecutive draft/verify failures before the engine stops
    # speculating and stays on plain decode
    spec_fail_disable: int = 3
