"""Shared-prefix index: a radix trie over token sequences (counterpart of
``ray_tpu/serve/prefix_cache.py``, the same class).

Chat traffic is prefix-heavy: many sessions share one system prompt, and a
new session whose prompt extends a prefix already resident in the engine's
slot cache only needs to prefill the unshared suffix (vLLM's automatic
prefix caching).  The continuous-batching engine
(`decode_session.ContinuousBatchingEngine`) keys the trie by the prompts of
its decode slots, with slot indices as owners: admission looks up the
longest shared prefix, copies that many K/V rows out of the donor slot
(`models.cache_gather_slot`), and chunk-prefills only the suffix.

Children are dicts keyed by the next token, owners are opaque ids, and
every owner has at most one key: re-inserting an owner replaces its old key
(a reclaimed slot).  All operations are O(len(key)); the structure is
lock-free by contract (the engine thread owns its instance).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple


class _Node:
    __slots__ = ("children", "owners")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        # owners whose key passes through (or ends at) this node
        self.owners: set = set()


class PrefixIndex:
    """Radix/trie shared-prefix index mapping token sequences to owner
    ids (engine slots), with longest-match lookup and hit/miss
    accounting."""

    def __init__(self):
        self._root = _Node()
        self._keys: Dict[Any, Tuple[int, ...]] = {}   # owner -> key
        self.hits = 0           # lookups that matched >= 1 token
        self.misses = 0
        self.tokens_matched = 0  # total prefix tokens served from hits

    # ------------------------------------------------------------- mutation

    def insert(self, tokens: Iterable[int], owner: Any) -> None:
        """Register ``owner`` as holding ``tokens``.  An owner holds at
        most one key: re-insertion evicts its previous key first (slot
        reuse)."""
        key = tuple(int(t) for t in tokens)
        if owner in self._keys:
            self.evict(owner)
        if not key:
            return
        node = self._root
        node.owners.add(owner)
        for t in key:
            node = node.children.setdefault(t, _Node())
            node.owners.add(owner)
        self._keys[owner] = key

    def evict(self, owner: Any) -> bool:
        """Drop ``owner``'s key (slot reclaimed).  Prunes
        now-ownerless trie branches so memory tracks live owners."""
        key = self._keys.pop(owner, None)
        if key is None:
            return False
        node = self._root
        node.owners.discard(owner)
        path: List[Tuple[_Node, int]] = []
        for t in key:
            nxt = node.children.get(t)
            if nxt is None:       # defensive: trie desynced, stop
                return True
            path.append((node, t))
            node = nxt
            node.owners.discard(owner)
        for parent, t in reversed(path):
            child = parent.children.get(t)
            if child is not None and not child.owners:
                del parent.children[t]
            else:
                break
        return True

    # -------------------------------------------------------------- lookup

    def longest_match(self, tokens: Iterable[int],
                      cap: Optional[int] = None
                      ) -> Tuple[Optional[Any], int]:
        """Walk ``tokens`` down the trie; returns ``(owner, depth)`` for
        the deepest node that still has a live owner (``depth`` = how
        many prefix tokens that owner's key shares with ``tokens``).
        ``cap`` bounds the usable depth (an admission must re-run at
        least the prompt's last token for its logits).  Counts hit/miss
        accounting: a match of zero tokens is a miss."""
        key = [int(t) for t in tokens]
        if cap is not None:
            key = key[:max(0, int(cap))]
        node = self._root
        best: Tuple[Optional[Any], int] = (None, 0)
        depth = 0
        for t in key:
            node = node.children.get(t)
            if node is None:
                break
            depth += 1
            if node.owners:
                best = (next(iter(node.owners)), depth)
        if best[0] is None or best[1] <= 0:
            self.misses += 1
            return (None, 0)
        self.hits += 1
        self.tokens_matched += best[1]
        return best

    # --------------------------------------------------------------- stats

    def __len__(self) -> int:
        return len(self._keys)

    def owners(self) -> List[Any]:
        return list(self._keys)

    def key_of(self, owner: Any) -> Optional[Tuple[int, ...]]:
        return self._keys.get(owner)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"entries": len(self._keys),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "tokens_matched": self.tokens_matched}
