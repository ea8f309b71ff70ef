"""The series of the runtime's self-metrics that the decode engine and the
Train checkpoint manager feed (counterpart of the serve part and the
storage-fault counter of ``ray_tpu/core/runtime_metrics.py``).

Same names, help strings, tag keys and buckets as the JAX package, so a
series renders to the same exposition lines in both.  The controller,
nodelet, RPC and WAL series belong to the runtime, which the port does not
have yet.
"""

from __future__ import annotations

from .. import metrics as m

SERVE_TOKENS = m.Counter(
    "ray_tpu_serve_tokens_total",
    "Tokens decoded by replica continuous-batching engines "
    "(decode_session.py); incremented in the replica's process AND "
    "delta-folded into the nodelet registry from engine "
    "`serve_metrics` pushes, so the cluster scrape carries it (the "
    "serve_breakdown table's per-token denominator)",
    ("deployment",))
SERVE_PREFILL_CHUNKS = m.Counter(
    "ray_tpu_serve_prefill_chunks_total",
    "Fixed-shape prefill chunk programs run by serve decode engines — "
    "chunked admission and failover resume share these programs, and "
    "each one is the most a joining session may stall live streams",
    ("deployment",))
SERVE_PREFIX_HITS = m.Counter(
    "ray_tpu_serve_prefix_hits_total",
    "Engine admissions seeded from a live slot's shared prompt prefix "
    "(serve/prefix_cache.py): the session prefilled only its unshared "
    "suffix instead of the whole prompt", ("deployment",))
SERVE_PREFIX_TOKENS_REUSED = m.Counter(
    "ray_tpu_serve_prefix_tokens_reused_total",
    "Prompt tokens whose prefill was skipped by shared-prefix KV reuse "
    "(copied out of a donor decode slot via models.cache_gather_slot)",
    ("deployment",))
SERVE_SPEC_PROPOSED = m.Counter(
    "ray_tpu_serve_spec_tokens_proposed_total",
    "Draft-model tokens offered to speculative verification by serve "
    "decode engines", ("deployment",))
SERVE_SPEC_ACCEPTED = m.Counter(
    "ray_tpu_serve_spec_tokens_accepted_total",
    "Draft-model tokens the target's batched verify step accepted "
    "(exact greedy match; the bonus token per iteration is not counted)",
    ("deployment",))
SERVE_DECODE_OCCUPANCY = m.Histogram(
    "ray_tpu_serve_decode_batch_occupancy",
    "Active decode slots per continuous-batching engine step — how full "
    "the batched decode program runs (the serve-vs-raw decode gap closes "
    "as this climbs toward max_slots)",
    (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0), ("deployment",))
SERVE_SPEC_ACCEPTANCE = m.Gauge(
    "ray_tpu_serve_spec_acceptance_ratio",
    "Cumulative speculative-decoding acceptance ratio (accepted / "
    "proposed draft tokens) per serve decode engine — the knob that "
    "decides whether spec_k is paying for itself", ("deployment",))
STORAGE_FAULTS = m.Counter(
    "ray_tpu_storage_faults_total",
    "Storage faults absorbed by a degradation ladder, by site and "
    "outcome (retained: spill failed, object stayed in memory | "
    "backpressured: a put waited out a spill fault | missing / "
    "corrupt_dropped: a spill copy was unusable and the fetch ladder "
    "fell through | kept_previous: a checkpoint write failed, the last "
    "good one stands | shed: a best-effort incident write was dropped "
    "| leaked: a spill-file GC unlink failed)", ("site", "outcome"))
