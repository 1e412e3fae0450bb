"""Mutation-aware query-result cache consulted before batch formation.

Repeated hot queries are a dominant serving cost in RAG (PAPERS.md:
Gao et al. 2023; Huang & Huang 2024); a hit here skips stage-0, the
rescore ladder, and the driver queue entirely.  The hard part is
staleness, and it is handled structurally rather than by TTL: every
entry is stamped with ``(store.generation, store.mask_epoch,
n_rebuilds)`` at insert time, and the whole cache is flushed the moment
any component moves (``_sync_stamp``).  A cached result therefore can
never be served across an add/delete/compact (``generation``), a
tenant/filter-mask change (``mask_epoch``), or an index rebuild — the
invariant the hypothesis property in tests/test_adaptive.py pins across
all six backend variants.

Keys are ``(query bytes, mask key, degradation level)`` — a degraded
(level > 0) answer is never replayed to a full-quality request or vice
versa, and tenants/filters can't alias.  Optionally (``near_eps > 0``)
a miss falls back to a near-duplicate scan: squared-L2 distance against
the cached queries of the same (mask key, level), served when within
``near_eps``.  The scan is vectorised over a preallocated ``(capacity,
d)`` matrix — O(capacity · d) numpy per miss, intended for modest
capacities (hot-query working sets), not as an ANN index.

Thread-safe behind its own lock; it must never be entered while holding
``engine.lock`` order-sensitively (callers take ``engine.lock`` only to
read the stamp, then release before touching the cache).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..obs import NULL_INSTRUMENT

Stamp = Tuple[int, int, int]  # (store_generation, mask_epoch, n_rebuilds)


@dataclass
class _Entry:
    k: int
    scores: np.ndarray  # (k,) float32 copy
    ids: np.ndarray     # (k,) int32 copy
    slot: int           # row in the query matrix (near-dup scan)


class QueryCache:
    """Exact + near-duplicate query-result LRU with structural
    invalidation.  See module docstring for the staleness contract."""

    def __init__(self, d: int, capacity: int = 1024,
                 near_eps: float = 0.0) -> None:
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.d = int(d)
        self.capacity = int(capacity)
        self.near_eps = float(near_eps)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # preallocated query rows for the near-dup distance scan; slot i
        # is live iff some entry points at it
        self._qmat = np.zeros((self.capacity, self.d), dtype=np.float32)
        self._slot_key: Dict[int, tuple] = {}
        self._free = list(range(self.capacity - 1, -1, -1))
        self._stamp: Optional[Stamp] = None
        # plain-int counters, published at scrape time (EngineStats
        # discipline); mutated only under self._lock
        self.hits_exact = 0
        self.hits_near = 0
        self.misses = 0
        self.invalidations = 0
        self._c_hits = NULL_INSTRUMENT
        self._c_misses = NULL_INSTRUMENT
        self._c_inval = NULL_INSTRUMENT
        self._g_size = NULL_INSTRUMENT

    # -- staleness ----------------------------------------------------
    def _sync_stamp_locked(self, stamp: Stamp) -> None:
        if self._stamp == stamp:
            return
        if self._entries:
            self.invalidations += 1
        self._entries.clear()
        self._slot_key.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._stamp = stamp

    # -- lookup / insert ---------------------------------------------
    @staticmethod
    def _key(q: np.ndarray, mask_key, level: int) -> tuple:
        return (q.tobytes(), mask_key, level)

    def lookup(self, q: np.ndarray, k: int, mask_key, level: int,
               stamp: Stamp) -> Optional[Tuple[np.ndarray, np.ndarray, str]]:
        """Return ``(scores[:k], ids[:k], 'exact'|'near')`` or None.

        ``stamp`` must be the store/backend generation triple read under
        ``engine.lock`` *by the caller, just before calling* — passing a
        fresh stamp is what makes a stale hit structurally impossible.
        """
        q = np.ascontiguousarray(q, dtype=np.float32)
        with self._lock:
            self._sync_stamp_locked(stamp)
            key = self._key(q, mask_key, level)
            e = self._entries.get(key)
            if e is not None and e.k >= k:
                self._entries.move_to_end(key)
                self.hits_exact += 1
                return e.scores[:k].copy(), e.ids[:k].copy(), "exact"
            if self.near_eps > 0.0 and self._entries:
                hit = self._near_locked(q, k, mask_key, level)
                if hit is not None:
                    self.hits_near += 1
                    return hit
            self.misses += 1
            return None

    def _near_locked(self, q, k, mask_key, level):
        slots = [s for s, sk in self._slot_key.items()
                 if sk[1] == mask_key and sk[2] == level
                 and self._entries[sk].k >= k]
        if not slots:
            return None
        rows = np.asarray(slots)
        d2 = ((self._qmat[rows] - q[None, :]) ** 2).sum(axis=1)
        j = int(np.argmin(d2))
        if d2[j] > self.near_eps:
            return None
        key = self._slot_key[slots[j]]
        e = self._entries[key]
        self._entries.move_to_end(key)
        return e.scores[:k].copy(), e.ids[:k].copy(), "near"

    def insert(self, q: np.ndarray, scores: np.ndarray, ids: np.ndarray,
               mask_key, level: int, stamp: Stamp) -> None:
        """Insert a delivered result.  ``stamp`` must be read under
        ``engine.lock`` AFTER the batch executed; if a mutation landed
        mid-window the stamps differ and the entry is dropped with the
        rest of the flush — never inserted stale."""
        q = np.ascontiguousarray(q, dtype=np.float32)
        scores = np.asarray(scores, dtype=np.float32).copy()
        ids = np.asarray(ids, dtype=np.int32).copy()
        with self._lock:
            self._sync_stamp_locked(stamp)
            key = self._key(q, mask_key, level)
            old = self._entries.pop(key, None)
            if old is not None:
                slot = old.slot
            elif self._free:
                slot = self._free.pop()
            else:  # LRU eviction
                _, victim = self._entries.popitem(last=False)
                self._slot_key.pop(victim.slot, None)
                slot = victim.slot
            self._qmat[slot] = q
            self._slot_key[slot] = key
            self._entries[key] = _Entry(k=len(ids), scores=scores, ids=ids,
                                        slot=slot)

    # -- observability ------------------------------------------------
    def bind(self, registry) -> None:
        self._c_hits = registry.counter(
            "repro_qcache_hits_total",
            "Query-cache hits served without dispatch", labels=("kind",))
        self._c_misses = registry.counter(
            "repro_qcache_misses_total", "Query-cache misses")
        self._c_inval = registry.counter(
            "repro_qcache_invalidations_total",
            "Whole-cache flushes on store/mask/rebuild generation bumps")
        self._g_size = registry.gauge(
            "repro_qcache_size", "Live cached query results")
        self.publish()

    def publish(self) -> None:
        with self._lock:
            hits_exact, hits_near = self.hits_exact, self.hits_near
            misses, inval = self.misses, self.invalidations
            size = len(self._entries)
        self._c_hits.set_total(hits_exact, kind="exact")
        self._c_hits.set_total(hits_near, kind="near")
        self._c_misses.set_total(misses)
        self._c_inval.set_total(inval)
        self._g_size.set(size)

    def summary(self) -> Dict:
        with self._lock:
            n = self.hits_exact + self.hits_near + self.misses
            hits = self.hits_exact + self.hits_near
            return {
                "enabled": True,
                "size": len(self._entries),
                "capacity": self.capacity,
                "near_eps": self.near_eps,
                "hits_exact": self.hits_exact,
                "hits_near": self.hits_near,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "hit_rate": (hits / n) if n else 0.0,
            }
