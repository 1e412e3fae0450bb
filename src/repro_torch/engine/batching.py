"""Request coalescing for the retrieval engine: FIFO queue + static buckets.

Serving traffic arrives as single queries at arbitrary times, but the device
path wants a small, fixed set of batch shapes — every distinct (batch,
corpus-capacity) pair is a separate first dispatch.  A ``BucketPolicy`` quantizes batch sizes to a
static ladder (powers of two by default): the engine drains its queue in
chunks and pads each chunk up to the nearest bucket, so each bucket is a
new shape exactly once per corpus capacity.  Padding rows are zero queries whose
results are discarded — progressive search is per-query, so they cannot
perturb real requests.

``DeadlineBatcher`` is the *when* to the BucketPolicy's *what shape*: the
latency/throughput knob for the async driver (`repro_torch.engine.driver`).  A
request waits at most ``max_wait_s`` for companions before its partial batch
is flushed, and a full top bucket flushes immediately.  It is a pure decision
function over (queue depth, oldest arrival, now) — no clock of its own, no
thread state — so the deadline policy is unit-testable with a fake clock
while the driver thread feeds it real time.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Static batch-size ladder for shape-bucketed dispatch.

    Attributes:
      sizes: ascending, unique, positive batch sizes.  A pending chunk of
             ``n`` requests is padded to the smallest bucket >= n; chunks
             larger than the top bucket are split.
    """

    sizes: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)

    def __post_init__(self):
        if not self.sizes:
            raise ValueError("BucketPolicy needs at least one bucket size")
        if any(s <= 0 for s in self.sizes):
            raise ValueError(f"bucket sizes must be positive, got {self.sizes}")
        if list(self.sizes) != sorted(set(self.sizes)):
            raise ValueError(
                f"bucket sizes must be ascending and unique, got {self.sizes}"
            )

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (top bucket for oversized n; caller splits)."""
        if n <= 0:
            raise ValueError(f"need a positive batch, got {n}")
        for s in self.sizes:
            if s >= n:
                return s
        return self.max_size

    def plan(self, n: int) -> List[int]:
        """Bucket sequence covering ``n`` requests.

        Full top-size batches first (best MXU utilization), then one padded
        bucket for the remainder — at most ``max_size - 1`` padded slots total.
        """
        if n <= 0:
            return []
        out = [self.max_size] * (n // self.max_size)
        rem = n % self.max_size
        if rem:
            out.append(self.bucket_for(rem))
        return out


@dataclasses.dataclass(frozen=True)
class BatchDecision:
    """What the driver loop should do right now.

    ``action`` is one of:
      * ``'flush'`` — dispatch ``n`` requests from the queue head (``reason``
        says why: ``'full'`` bucket or ``'deadline'`` expiry).
      * ``'wait'``  — nothing is due; sleep at most ``wait_s`` (an earlier
        arrival can only shorten the deadline, so waking on new submissions
        and re-deciding is always safe).
      * ``'idle'``  — queue is empty; block until something arrives.
    """

    action: str
    n: int = 0
    wait_s: float = 0.0
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class DeadlineBatcher:
    """Deadline-based flush policy over a ``BucketPolicy`` ladder.

    A partial batch is held back for up to ``max_wait_s`` after its *oldest*
    request arrived (more companions => bigger bucket => better device
    utilization); a full top-size bucket flushes immediately (waiting longer
    cannot improve its shape).  ``max_wait_s=0`` degenerates to
    flush-on-arrival: minimum latency, singleton batches under light load.
    """

    policy: BucketPolicy
    max_wait_s: float = 0.002

    def __post_init__(self):
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")

    def decide(self, n_pending: int, oldest_arrival: float,
               now: float) -> BatchDecision:
        """Pure policy step: all time flows in through the arguments."""
        if n_pending <= 0:
            return BatchDecision("idle")
        if n_pending >= self.policy.max_size:
            return BatchDecision("flush", n=self.policy.max_size, reason="full")
        deadline = oldest_arrival + self.max_wait_s
        if now >= deadline:
            return BatchDecision("flush", n=n_pending, reason="deadline")
        return BatchDecision("wait", wait_s=deadline - now)


@dataclasses.dataclass
class PendingRequest:
    """A submitted query waiting for dispatch.

    ``k``/``mask_key`` carry the per-request options of the typed
    `repro_torch.engine.request.SearchRequest` surface; the defaults are exactly
    the legacy raw-vector request (engine-default k, no tenant/filter).
    Requests sharing a ``mask_key`` can ride the same dispatch — the batch
    applies one row bitmask — so batch formation groups by it.
    """

    request_id: int
    query: np.ndarray           # (D,) float32
    t_submit: float             # perf_counter seconds
    k: Optional[int] = None     # result width; None = engine default
    mask_key: Optional[Tuple] = None   # DocStore.compile_mask identity
    deadline: Optional[float] = None   # absolute perf_counter deadline
    # repro_torch.obs.TraceContext stamped by the engine/driver along the way
    # (None when observability is disabled); typed loosely so this module
    # keeps zero obs imports
    trace: Optional[object] = None


class RequestQueue:
    """FIFO of pending requests (arrival order == dispatch order)."""

    def __init__(self) -> None:
        self._q: Deque[PendingRequest] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: PendingRequest) -> None:
        self._q.append(req)

    def pop_chunk(self, max_n: int) -> List[PendingRequest]:
        """Pop up to ``max_n`` requests in arrival order."""
        out = []
        while self._q and len(out) < max_n:
            out.append(self._q.popleft())
        return out

    def pop_group(self, max_n: int) -> List[PendingRequest]:
        """Pop up to ``max_n`` requests sharing the head's ``mask_key``.

        A batch dispatches with ONE row bitmask, so only same-key requests
        may share it.  The head's key always progresses (no starvation —
        this is still FIFO by key-of-the-oldest); non-matching requests
        keep their relative order for the next pop.
        """
        if not self._q:
            return []
        key = self._q[0].mask_key
        out: List[PendingRequest] = []
        skipped: List[PendingRequest] = []
        while self._q and len(out) < max_n:
            req = self._q.popleft()
            if req.mask_key == key:
                out.append(req)
            else:
                skipped.append(req)
        self._q.extendleft(reversed(skipped))
        return out


def pad_batch(queries: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad a (B, D) query batch up to (bucket, D)."""
    b, d = queries.shape
    if b > bucket:
        raise ValueError(f"batch {b} exceeds bucket {bucket}")
    if b == bucket:
        return queries
    out = np.zeros((bucket, d), queries.dtype)
    out[:b] = queries
    return out
