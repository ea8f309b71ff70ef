"""Deterministic fault injection (chaos), process-local (counterpart of
the process-local plan of ``ray_tpu/util/fault_injection.py``).

A fault **plan** is a JSON list of rules, the JAX package's schema:

    {"site": "serve.spec_verify",        # where to inject
     "match": {"nth": 3} | {"prob": 0.1, "seed": 7} | {"regex": "dep.*"}
              | {"peer": "ab12"},        # peer-directed sites only
     "action": "error",                  # what to do (site-dependent)
     "delay_s": 0.05,                    # for delay / latency
     "once": true,                       # fire once
     "max_fires": 2,                     # per-process fire cap
     "proc": "worker"}                   # only in this process kind

Matchers are deterministic: ``nth`` fires on the Nth eligible hit of the
site in this process (``regex`` filters which calls count as hits, against
the site's key: for ``serve.spec_verify`` the engine's name); ``prob``
draws from a per-rule ``random.Random(seed)``.  Every injected fault counts
in ``ray_tpu_chaos_injected_total{site,action}`` (registered only while a
plan is armed) and records a ``chaos::<site>`` span.

The port threads two sites so far: ``serve.spec_verify`` in the decode
engine's speculative iteration (``delay`` / ``latency`` sleep, any other
action raises, and the engine falls back to a plain step) and
``train.checkpoint_register`` in the Train checkpoint manager
(`fs_point`: an injected ``OSError``, the previous checkpoint kept).  ``KNOWN_SITES``
is the JAX package's whole table, so a plan validates the same in both
packages.

A plan armed in one process spreads to the processes it spawns later, as
the JAX package's ``chaos_plan`` setting does: `arm` writes the plan into
``RAY_TPU_CHAOS_PLAN``, which a spawned child inherits, and every actor of
the port (`core.actors`: gang members, Train ranks) arms from it
(`maybe_arm_from_config`) before it builds its instance; `disarm` takes
the variable out again, so later spawns start unarmed; `chaos_env` is the
env block that arms a process started some other way.  With no controller
in the port, ``once`` holds per process: each process counts its own fires,
so a ``once`` rule fires at most once in every process the plan reaches,
and `local_claim` (the JAX package's claim when no controller answers) is
the only claim a site can take.  The runtime-wide pieces (the
controller's KV and its pubsub channel) are not ported.
"""

from __future__ import annotations

import json
import os
import random
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from . import tracing

METRIC_NAME = "ray_tpu_chaos_injected_total"
#: the variable that carries an armed plan to the processes spawned later
ENV_VAR = "RAY_TPU_CHAOS_PLAN"

_FS_ACTIONS = frozenset({"error", "enospc", "eio"})

#: Every injection site of the JAX package's runtime, with the actions the
#: site understands (None = any action blackholes or fails the site);
#: ``delay`` / ``latency`` are valid everywhere.
KNOWN_SITES: Dict[str, Optional[frozenset]] = {
    "rpc.send": frozenset({"drop", "sever", "error"}),
    "rpc.connect": frozenset({"error", "drop"}),
    "nodelet.lease": frozenset({"kill_worker"}),
    "nodelet.heartbeat": None,
    "object.fetch_meta": frozenset({"evict"}),
    "worker.before_put": frozenset({"crash", "error"}),
    "worker.after_put": frozenset({"crash", "error"}),
    "worker.exec_crash": frozenset({"sigkill", "sigsegv", "sigabrt",
                                    "crash", "error"}),
    "nodelet.death_classify": None,
    "serve.request": frozenset({"crash", "error", "fail"}),
    "serve.health_check": frozenset({"error", "fail"}),
    "serve.session_failover": frozenset({"error", "fail"}),
    "serve.autoscale": frozenset({"drop", "error", "fail"}),
    "serve.spec_verify": frozenset({"error", "fail"}),
    "serve.slo_eval": frozenset({"error", "fail"}),
    "drain.evacuate": None,
    "drain.deadline": None,
    "train.snapshot_put": frozenset({"error", "fail"}),
    "train.repair_restore": frozenset({"error", "fail"}),
    "controller.wal_replicate": frozenset({"drop"}),
    "controller.lease_renew": None,
    "object.transfer_fetch": None,
    "nodelet.peer_probe": None,
    "controller.admission_shed": frozenset({"force", "suppress"}),
    "rpc.lane_starve": frozenset(),
    "wal.append": _FS_ACTIONS,
    "wal.fsync": _FS_ACTIONS,
    "wal.snapshot": _FS_ACTIONS,
    "spill.write": _FS_ACTIONS,
    "spill.restore": _FS_ACTIONS,
    "spill.delete": _FS_ACTIONS,
    "train.checkpoint_register": _FS_ACTIONS,
    "flight.write": _FS_ACTIONS,
}
_UNIVERSAL_ACTIONS = frozenset({"delay", "latency"})
_RULE_KEYS = frozenset({"site", "action", "match", "delay_s", "once",
                        "max_fires", "proc", "id", "seed"})
_MATCH_KEYS = frozenset({"nth", "prob", "seed", "regex", "peer"})

#: The armed plan, or None when the chaos layer is disabled.  Hot paths
#: guard with ``fi.ACTIVE is not None``.
ACTIVE: Optional["FaultPlan"] = None

_lock = threading.Lock()
_counter = None            # metrics.Counter, registered only while armed
_local_claims: set = set()  # per-process `once` claims


class FaultRule:
    def __init__(self, idx: int, d: Dict[str, Any]):
        self.site = d["site"]
        self.action = d["action"]
        m = d.get("match") or {}
        self.nth = m.get("nth")
        self.prob = m.get("prob")
        self.regex = re.compile(m["regex"]) if m.get("regex") else None
        # peer-directed filter: only fire toward matching remote peers
        self.peer = re.compile(m["peer"]) if m.get("peer") else None
        self.seed = int(m.get("seed", d.get("seed", 0)))
        self.delay_s = float(d.get("delay_s", 0.05))
        self.max_fires = d.get("max_fires")
        self.once = bool(d.get("once"))
        self.proc = d.get("proc")
        self.rule_id = d.get("id") or f"{self.site}#{idx}"
        self._rng = random.Random(self.seed)
        self.hits = 0
        self.fires = 0

    def matches(self, key: str, proc_kind: str, proc_node: str = "",
                peer: str = "") -> bool:
        """One eligible hit of this rule's site; True when the fault
        fires.  The regex / peer filters decide which calls count as hits,
        then nth / prob decide on the hit sequence."""
        if self.proc and not self._proc_matches(proc_kind, proc_node):
            return False
        if self.regex is not None and not self.regex.search(key or ""):
            return False
        if self.peer is not None and not self.peer.search(peer or ""):
            return False
        self.hits += 1
        if self.once and self.fires >= 1:
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.nth is not None:
            wanted = self.nth if isinstance(self.nth, (list, tuple)) \
                else (self.nth,)
            if self.hits not in wanted:
                return False
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        self.fires += 1
        return True

    def _proc_matches(self, proc_kind: str, proc_node: str) -> bool:
        """``proc`` filter: a bare kind matches every process of that
        kind; ``"<kind>:<node-id-prefix>"`` pins the rule to one node's
        process (prefixes compare on their overlap)."""
        if ":" not in self.proc:
            return self.proc == proc_kind
        kind, _, pref = self.proc.partition(":")
        if kind != proc_kind or not pref or not proc_node:
            return False
        return pref.startswith(proc_node) or proc_node.startswith(pref)

    def to_act(self) -> Dict[str, Any]:
        return {"action": self.action, "delay_s": self.delay_s,
                "rule_id": self.rule_id, "once": self.once}


class FaultPlan:
    """A parsed plan; sites call ``point`` on it."""

    def __init__(self, rules_json: List[Dict[str, Any]]):
        self.raw = [dict(r) for r in rules_json]
        self.rules: Dict[str, List[FaultRule]] = {}
        for i, d in enumerate(rules_json):
            r = FaultRule(i, d)
            self.rules.setdefault(r.site, []).append(r)

    def point(self, site: str, key: str = "",
              peer: str = "") -> Optional[Dict[str, Any]]:
        """Evaluate the plan at one injection site.  Returns the action
        dict when a rule fires (counting the metric and recording a span),
        else None; the caller applies the action."""
        rules = self.rules.get(site)
        if not rules:
            return None
        kind = tracing._proc.get("kind", "")
        node = tracing._proc.get("node", "")
        for r in rules:
            with _lock:
                fired = r.matches(key, kind, node, peer)
            if fired:
                _count(site, r.action)
                now = time.time()
                tracing.record_span(f"chaos::{site}", "chaos", now, now,
                                    action=r.action, rule=r.rule_id,
                                    key=key)
                return r.to_act()
        return None

    async def async_point(self, site: str, key: str = "",
                          peer: str = "") -> Optional[Dict[str, Any]]:
        """``point`` for async sites: delay / latency actions sleep here
        without blocking the loop; the action dict is returned either
        way."""
        act = self.point(site, key, peer)
        if act is not None and act["action"] in ("delay", "latency"):
            import asyncio
            await asyncio.sleep(max(0.0, act["delay_s"]))
        return act


def fs_point(site: str, key: str = "") -> None:
    """Evaluate a filesystem chaos site (``train.checkpoint_register``):
    raises the injected ``OSError`` (errno per action) or sleeps through a
    ``delay`` stall, blocking, as a stalling fsync does to its caller."""
    if ACTIVE is None:
        return
    act = ACTIVE.point(site, key)
    if act is None:
        return
    if act["action"] in _UNIVERSAL_ACTIONS:
        time.sleep(max(0.0, act["delay_s"]))
        return
    import errno
    import os
    eno = {"enospc": errno.ENOSPC, "eio": errno.EIO}.get(
        act["action"], errno.EIO)
    raise OSError(eno, f"chaos[{act['rule_id']}]: injected "
                       f"{os.strerror(eno)}", key or site)


# ----------------------------------------------------------- arm / disarm

def arm(plan: Any) -> "FaultPlan":
    """Arm the chaos layer in this process.  ``plan`` is the rule list (or
    its JSON text).  Re-arming replaces the plan and resets rule counters.
    The plan is also written into ``RAY_TPU_CHAOS_PLAN``, so the processes
    this one spawns later arm with it."""
    global ACTIVE
    if isinstance(plan, (str, bytes)):
        plan = json.loads(plan)
    fp = FaultPlan(list(plan))
    with _lock:
        ACTIVE = fp
        _ensure_counter()
    os.environ[ENV_VAR] = json.dumps(fp.raw)
    return fp


def disarm() -> None:
    """Disable the layer, deregister its counter (a disabled process's
    metrics do not mention the chaos metric), drop this process's ``once``
    claims and take the plan out of ``RAY_TPU_CHAOS_PLAN``: processes
    spawned later start unarmed."""
    global ACTIVE, _counter
    with _lock:
        ACTIVE = None
        if _counter is not None:
            from .. import metrics
            with metrics._lock:
                metrics._registry.pop(METRIC_NAME, None)
            _counter = None
        _local_claims.clear()
    os.environ.pop(ENV_VAR, None)


def maybe_arm_from_config() -> None:
    """Arm from ``RAY_TPU_CHAOS_PLAN`` (set by `arm` in a parent, or by
    `chaos_env`); a no-op when it is empty or a plan is already armed (so
    a live plan's counters are never reset).  A malformed plan is reported
    and ignored, as in the JAX package."""
    if ACTIVE is not None:
        return
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return
    try:
        arm(raw)
    except (ValueError, KeyError, TypeError) as e:
        print(f"WARNING: ignoring malformed chaos plan: {e}",
              file=sys.stderr, flush=True)


def local_claim(rule_id: str) -> bool:
    """Claim a ``once`` rule in this process: True the first time, False
    after (the JAX package's fallback when no controller answers, and the
    port's only claim)."""
    with _lock:
        if rule_id in _local_claims:
            return False
        _local_claims.add(rule_id)
        return True


def chaos_env(plan: List[Dict[str, Any]]) -> Dict[str, str]:
    """The env block that arms a spawned process with ``plan``."""
    return {ENV_VAR: json.dumps(plan)}


# ---------------------------------------------------------------- validation

def validate_plan(plan: Any) -> List[str]:
    """Lint a chaos plan; returns human-readable issues (empty = clean).
    A malformed plan mostly fails silently at run time (an unknown site
    never fires), so these checks run up front."""
    issues: List[str] = []
    if not isinstance(plan, list):
        return [f"plan must be a JSON list of rules, got "
                f"{type(plan).__name__}"]
    seen_ids: Dict[str, int] = {}
    for i, d in enumerate(plan):
        tag = f"rule #{i}"
        if not isinstance(d, dict):
            issues.append(f"{tag}: not an object "
                          f"({type(d).__name__})")
            continue
        site = d.get("site")
        if d.get("id"):
            tag = f"rule #{i} ({d['id']!r})"
        elif site:
            tag = f"rule #{i} ({site})"
        for k in d:
            if k not in _RULE_KEYS:
                issues.append(f"{tag}: unknown key {k!r} "
                              f"(known: {', '.join(sorted(_RULE_KEYS))})")
        if not site:
            issues.append(f"{tag}: missing 'site'")
        elif site not in KNOWN_SITES:
            issues.append(
                f"{tag}: unknown site {site!r} — the rule would never "
                f"fire (known: {', '.join(sorted(KNOWN_SITES))})")
        action = d.get("action")
        if not action:
            issues.append(f"{tag}: missing 'action'")
        elif site in KNOWN_SITES:
            allowed = KNOWN_SITES[site]
            if allowed is not None and action not in allowed \
                    and action not in _UNIVERSAL_ACTIONS:
                issues.append(
                    f"{tag}: action {action!r} is a no-op at site "
                    f"{site!r} (understood: "
                    f"{', '.join(sorted(allowed | _UNIVERSAL_ACTIONS))})")
        m = d.get("match")
        if m is not None and not isinstance(m, dict):
            issues.append(f"{tag}: 'match' must be an object")
            m = None
        if m:
            for k in m:
                if k not in _MATCH_KEYS:
                    issues.append(f"{tag}: unknown matcher {k!r} "
                                  f"(known: nth, prob, seed, regex, "
                                  f"peer)")
            if "nth" in m and "prob" in m:
                issues.append(f"{tag}: 'nth' and 'prob' conflict — one "
                              f"rule matches by count OR by draw, not "
                              f"both")
            nth = m.get("nth")
            if nth is not None and not (
                    isinstance(nth, int) and not isinstance(nth, bool)
                    or (isinstance(nth, (list, tuple)) and nth and all(
                        isinstance(n, int) and not isinstance(n, bool)
                        for n in nth))):
                issues.append(f"{tag}: 'nth' must be an int or a "
                              f"non-empty list of ints, got {nth!r}")
            prob = m.get("prob")
            if prob is not None and not (
                    isinstance(prob, (int, float))
                    and not isinstance(prob, bool) and 0 < prob <= 1):
                issues.append(f"{tag}: 'prob' must be in (0, 1], got "
                              f"{prob!r}")
            if m.get("regex") is not None:
                try:
                    re.compile(m["regex"])
                except (re.error, TypeError) as e:
                    issues.append(f"{tag}: bad regex "
                                  f"{m.get('regex')!r}: {e}")
            if m.get("peer") is not None:
                try:
                    re.compile(m["peer"])
                except (re.error, TypeError) as e:
                    issues.append(f"{tag}: bad peer matcher "
                                  f"{m.get('peer')!r}: {e}")
        delay = d.get("delay_s")
        if delay is not None and (not isinstance(delay, (int, float))
                                  or isinstance(delay, bool)
                                  or delay < 0):
            issues.append(f"{tag}: 'delay_s' must be a non-negative "
                          f"number, got {delay!r}")
        mf = d.get("max_fires")
        if mf is not None and (not isinstance(mf, int)
                               or isinstance(mf, bool) or mf < 1):
            issues.append(f"{tag}: 'max_fires' must be a positive int, "
                          f"got {mf!r}")
        if d.get("once") and isinstance(mf, int) and mf > 1:
            issues.append(f"{tag}: 'once' conflicts with max_fires="
                          f"{mf} — once caps the rule at one fire "
                          f"cluster-wide")
        rid = d.get("id")
        if rid:
            if rid in seen_ids:
                issues.append(
                    f"{tag}: duplicate rule id {rid!r} (also rule "
                    f"#{seen_ids[rid]}) — `once` claims are keyed by "
                    f"id, so duplicates starve each other and at most "
                    f"one ever fires")
            else:
                seen_ids[rid] = i
    return issues


# ------------------------------------------------------------------ metric

def _ensure_counter():
    global _counter
    if _counter is None:
        from .. import metrics
        _counter = metrics.Counter(
            METRIC_NAME,
            "Faults injected by the chaos layer", ("site", "action"))
    return _counter


def _count(site: str, action: str) -> None:
    c = _ensure_counter()
    c.inc(tags={"site": site, "action": action})


def count_injection(site: str, action: str) -> None:
    """Record an injection observed elsewhere (a process that reports its
    fault before it dies)."""
    _count(site, action)


def injected_counts() -> Dict[str, float]:
    """site|action -> count for this process."""
    if _counter is None:
        return {}
    return {"|".join(k): v for k, v in _counter._samples()}
