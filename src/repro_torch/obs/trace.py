"""Per-request trace spans: monotonic pipeline timestamps + slow-query log.

A ``TraceContext`` rides on each ``PendingRequest`` through the serving
spine and collects ``time.perf_counter()`` marks at the pipeline's seams:

    submit    request constructed (``check_request``)
    admit     accepted into a queue (driver pending list / engine queue)
    batch     chosen into a batch (driver ``_take_locked`` / queue pop)
    dispatch  batch handed to the backend (post rebuild + mask compile)
    stage0    stage-0 scan fenced complete (only with ``obs.stage_fences``)
    rescore   rescore ladder complete (only with ``obs.stage_fences``)
    deliver   result materialised on host

``spans_ms()`` converts marks to millisecond offsets from ``submit`` —
monotone non-decreasing in pipeline order, so ``dispatch`` *is* the queue
time and ``deliver`` is the end-to-end latency.  Marks that a given path
does not cross (e.g. ``stage0`` on the fused fast path) are simply absent.

``TraceRing`` keeps a bounded in-memory window of recent completed traces
for ``/v1/traces``-style debugging; ``SlowQueryLog`` emits one structured
JSON line per request whose latency exceeds the configured threshold.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Dict, List, Optional

# pipeline order — used for ordering output and monotonicity checks
MARK_ORDER = ("submit", "admit", "batch", "dispatch",
              "stage0", "rescore", "deliver")

slow_query_logger = logging.getLogger("repro_torch.obs.slowquery")


class TraceContext:
    """Mutable mark set for one request's trip through the pipeline.

    Single-writer at every point in time (ownership moves along the
    pipeline with the request), so no lock is needed.
    """

    __slots__ = ("marks",)

    def __init__(self, t_submit: Optional[float] = None):
        self.marks: Dict[str, float] = {
            "submit": time.perf_counter() if t_submit is None else t_submit}

    def mark(self, name: str, t: Optional[float] = None) -> None:
        self.marks[name] = time.perf_counter() if t is None else t

    def spans_ms(self) -> Dict[str, float]:
        """Millisecond offsets from ``submit``, in pipeline order."""
        t0 = self.marks["submit"]
        return {name: (self.marks[name] - t0) * 1e3
                for name in MARK_ORDER if name in self.marks}


class TraceRing:
    """Bounded ring of recent completed-request trace records."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=max(1, self.capacity))
        self._lock = threading.Lock()

    def push(self, record: Dict) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._ring.append(record)

    def push_many(self, records) -> None:
        """One lock round-trip for a whole batch of completed traces."""
        if self.capacity <= 0 or not records:
            return
        with self._lock:
            self._ring.extend(records)

    def snapshot(self, n: Optional[int] = None) -> List[Dict]:
        """Most-recent-last copy of up to ``n`` records."""
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-int(n):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class SlowQueryLog:
    """Structured JSON log for requests slower than ``threshold_ms``.

    Emits one ``logging`` record per offender on the
    ``repro_torch.obs.slowquery`` logger; keeps the last few records in memory so
    tests (and operators at a REPL) can inspect them without a log pipe.
    """

    def __init__(self, threshold_ms: Optional[float],
                 logger: Optional[logging.Logger] = None, keep: int = 32):
        self.threshold_ms = (float(threshold_ms)
                             if threshold_ms is not None else None)
        self._logger = logger or slow_query_logger
        self._lock = threading.Lock()
        self._recent = collections.deque(maxlen=keep)
        self.n_logged = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_ms is not None and self.threshold_ms >= 0

    def maybe_log(self, record: Dict) -> bool:
        """Log ``record`` if its latency_ms crosses the threshold."""
        if not self.enabled:
            return False
        latency = record.get("latency_ms")
        if latency is None or latency < self.threshold_ms:
            return False
        entry = dict(record, slow_query_threshold_ms=self.threshold_ms)
        with self._lock:
            self._recent.append(entry)
            self.n_logged += 1
        self._logger.warning(json.dumps(entry, sort_keys=True,
                                        default=str))
        return True

    def recent(self) -> List[Dict]:
        with self._lock:
            return list(self._recent)
