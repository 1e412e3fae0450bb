"""Async serving driver: a background thread owning batch formation/dispatch.

``RetrievalEngine`` is deliberately caller-paced — ``step()`` runs one batch
when somebody calls it.  That shape is right for benchmarks and tests, but a
serving system has many client threads and nobody whose job is to call
``step()``.  The driver closes the loop:

    client threads ──submit()/retrieve()──> bounded pending deque
        ──driver thread── DeadlineBatcher.decide() ──flush──>
            engine.execute_batch() under engine.lock ──> RetrievalFuture

* **Deadline-based batching** — the latency/throughput knob.  A request
  waits at most ``max_wait_ms`` (measured from the *oldest* request in the
  partial batch) before flushing; a full top-size bucket flushes
  immediately.  ``max_wait_ms=0`` minimizes latency (singleton batches under
  light load); larger values trade p50 latency for bigger buckets and higher
  device throughput.  The policy itself is ``repro_torch.engine.batching.
  DeadlineBatcher`` — pure and fake-clock-testable; this thread just feeds
  it real time.
* **Thread-safe submission** — ``submit()`` may be called from any thread
  and returns a ``RetrievalFuture``; ``retrieve()`` is the blocking
  convenience wrapper.  **Backpressure**: the pending queue is bounded
  (``max_queue``); ``submit`` blocks until space frees (or raises
  ``DriverQueueFull`` past ``timeout``), so an overloaded engine pushes back
  on producers instead of buffering unboundedly.
* **Lifecycle** — ``start()`` spawns the thread; ``stop(drain=True)``
  serves every accepted request before exiting, ``stop(drain=False)``
  cancels pending requests (their futures raise ``DriverStopped``).  The
  context-manager form drains on clean exit and aborts if the body raised.
* **Exception propagation** — a dispatch error fails that batch's futures
  (clients see the exception from ``result()``) and the driver keeps
  serving; an unexpected driver-loop error is recorded, fails everything
  pending, and re-raises from the next ``submit``/``stop``.
* **Safe-point composition** — every dispatch runs through
  ``engine.execute_batch``, whose pre-dispatch ``maybe_rebuild()`` adopts
  finished background index builds and runs compaction *between* driver
  iterations (the engine's safe-point contract), never mid-batch.  Corpus
  mutations from client threads serialize against dispatches on
  ``engine.lock``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.engine.adaptive import AdaptivePolicy
from repro_torch.engine.batching import DeadlineBatcher, PendingRequest
from repro_torch.engine.engine import RequestStats, RetrievalEngine, RetrievalResult
from repro_torch.engine.qcache import QueryCache


class DriverStopped(RuntimeError):
    """The driver is stopping/stopped/dead — the request was not served."""


class RequestFailed(RuntimeError):
    """This specific request failed while its co-batched neighbours
    succeeded: batch bisection isolated it as the poison request (its
    dispatch raised on every subset containing it).  The HTTP layer maps
    this to 503 for the offender alone."""


class DriverQueueFull(TimeoutError):
    """``submit`` timed out waiting for space in the bounded pending queue."""


class DeadlineExceeded(TimeoutError):
    """The request's ``SearchRequest.deadline_ms`` budget expired before its
    batch dispatched — the driver dropped it instead of burning device time
    on an answer nobody is waiting for (the HTTP layer maps this to 504)."""


class RetrievalFuture:
    """Write-once result slot for one submitted request.

    ``result(timeout)`` blocks until the driver resolves the future — with a
    ``RetrievalResult``, the dispatch exception, or ``DriverStopped`` on
    abort — and raises ``TimeoutError`` if nothing lands in time.
    """

    __slots__ = ("_event", "_result", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Optional[RetrievalResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RetrievalResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"no retrieval result within {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The error the future resolved with (None on success)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"no retrieval result within {timeout}s")
        return self._error

    def _finish(self, result: Optional[RetrievalResult] = None,
                error: Optional[BaseException] = None) -> None:
        self._result, self._error = result, error
        self._event.set()


# driver counter attribute -> registry metric; the three flush counters
# share one labeled family (repro_driver_flush_total{reason=...}) and
# queue_peak mirrors to a gauge — attribute surface unchanged either way
_DRIVER_COUNTERS = {
    "n_submitted": ("repro_driver_requests_submitted_total",
                    "Requests accepted into the driver queue"),
    "n_completed": ("repro_driver_requests_completed_total",
                    "Requests resolved with a result"),
    "n_cancelled": ("repro_driver_requests_cancelled_total",
                    "Requests cancelled at stop(drain=False)"),
    "n_expired": ("repro_driver_requests_expired_total",
                  "Requests shed: client deadline passed pre-dispatch"),
    "n_batch_errors": ("repro_driver_batch_errors_total",
                       "Batches whose dispatch raised"),
    "n_quarantined": ("repro_driver_quarantined_total",
                      "Requests isolated by batch bisection and failed "
                      "alone (RequestFailed/503)"),
    "n_bisections": ("repro_driver_bisect_splits_total",
                     "Failing-batch splits performed while isolating "
                     "poison requests"),
    "n_driver_crashes": ("repro_driver_crashes_total",
                         "Driver-thread deaths absorbed in supervised "
                         "mode"),
    "n_restarts": ("repro_driver_restarts_total",
                   "Driver-thread restarts (supervisor or manual)"),
}
_FLUSH_REASONS = {"n_flush_full": "full", "n_flush_deadline": "deadline",
                  "n_flush_drain": "drain"}


class DriverStats:
    """Driver-side counters (the engine keeps the latency distributions).

    Plain int attributes with the exact field set of the original
    dataclass — ``stats.n_completed += 1`` call sites and ``summary()``
    consumers see no difference.  The ints are the source of truth; a
    bound `repro_torch.obs.MetricsRegistry` sees them through ``publish()``,
    which the driver's scrape-time collector calls — zero registry lock
    traffic on the submit/flush hot path.
    """

    _FIELDS = ("n_submitted", "n_completed", "n_cancelled", "n_expired",
               "n_batch_errors", "n_quarantined", "n_bisections",
               "n_driver_crashes", "n_restarts", "n_flush_full",
               "n_flush_deadline", "n_flush_drain", "queue_peak")

    def __init__(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0)
        self._mirror: Dict[str, object] = {}
        self._c_flush = None
        self._g_peak = None

    def bind(self, registry) -> None:
        for attr, (metric, help_text) in _DRIVER_COUNTERS.items():
            self._mirror[attr] = registry.counter(metric, help_text)
        self._c_flush = registry.counter(
            "repro_driver_flush_total",
            "Batches flushed, by trigger (full bucket / deadline / drain)",
            labels=("reason",))
        self._g_peak = registry.gauge(
            "repro_driver_queue_peak",
            "High-water pending-queue depth")
        self.publish()

    def publish(self) -> None:
        """Mirror current totals into the bound registry (collector path:
        runs at scrape time, never per request)."""
        for attr, c in self._mirror.items():
            c.set_total(getattr(self, attr))
        if self._c_flush is not None:
            for attr, reason in _FLUSH_REASONS.items():
                self._c_flush.set_total(getattr(self, attr), reason=reason)
        if self._g_peak is not None:
            self._g_peak.set(float(self.queue_peak))

    def summary(self) -> Dict:
        return {f: getattr(self, f) for f in self._FIELDS}


@dataclasses.dataclass
class _Pending:
    req: PendingRequest         # validated request (rid assigned by engine)
    future: RetrievalFuture
    t_arrival: float            # driver-clock seconds (deadline policy)

    @property
    def mask_key(self):
        return self.req.mask_key


_NEW, _RUNNING, _STOPPING, _STOPPED = "new", "running", "stopping", "stopped"


class EngineDriver:
    """Background batching loop over a ``RetrievalEngine``.

    Args:
      engine:       the engine to drive (its ``policy`` supplies the bucket
                    ladder; its ``lock`` serializes dispatches against
                    client-side corpus mutations).
      max_wait_ms:  deadline a partial batch waits for companions before
                    flushing (0 = flush on arrival).
      max_queue:    pending-queue bound; ``submit`` blocks past it.
      clock:        time source for the *deadline policy only* (injectable
                    for tests); engine latency stats always use
                    ``time.perf_counter``.
    """

    def __init__(
        self,
        engine: RetrievalEngine,
        *,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        clock: Callable[[], float] = time.perf_counter,
        name: str = "engine-driver",
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.engine = engine
        self.batcher = DeadlineBatcher(engine.policy, float(max_wait_ms) / 1e3)
        self.stats = DriverStats()
        self.stats.bind(engine.metrics)
        self._h_wait = engine.metrics.histogram(
            "repro_driver_queue_wait_ms",
            "Driver-queue wait: submit to batch formation")
        self._g_depth = engine.metrics.gauge(
            "repro_driver_queue_depth",
            "Requests pending in the driver queue")
        # -- adaptive policy + query cache, built from the engine's config
        # sections (both default-off; the driver owns them because the
        # pressure signals — queue depth / queue-wait p95 — are driver-side)
        acfg = engine.config.adaptive
        self.adaptive: Optional[AdaptivePolicy] = (
            AdaptivePolicy(acfg) if acfg.enabled else None)
        if self.adaptive is not None:
            self.adaptive.bind(engine.metrics)
        ccfg = engine.config.cache
        self.cache: Optional[QueryCache] = (
            QueryCache(engine.store.d_emb, capacity=ccfg.capacity,
                       near_eps=ccfg.near_eps) if ccfg.enabled else None)
        if self.cache is not None:
            self.cache.bind(engine.metrics)
        # recent queue waits (seconds) feeding the policy's p95 signal;
        # consumed (cleared) at each policy update so recovery sees a
        # fresh window instead of old overload samples
        self._wait_samples: Deque[float] = deque(maxlen=128)
        engine.metrics.register_collector(self._collect_metrics)
        self._clock = clock
        self._max_queue = int(max_queue)
        self._name = name
        self._pending: Deque[_Pending] = deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._state = _NEW
        self._drain = True
        self._join_timed_out = False
        self._fatal: Optional[BaseException] = None
        # -- fault tolerance: heartbeat stamped per loop iteration (the
        # supervisor's hang detector), an epoch that lets restart() abandon
        # a wedged thread (it exits at its next safe point), and the
        # supervised-crash slot (thread died, state stays _RUNNING so a
        # restart can resume the pending queue)
        self._bisect = bool(engine.config.fault.poison_bisect)
        self._supervised = False
        self._epoch = 0
        self._hb = 0.0
        self._crash: Optional[BaseException] = None
        self.supervisor = None            # attached by Supervisor.__init__

    # -- lifecycle -----------------------------------------------------------
    def start(self, *, supervised: bool = False) -> "EngineDriver":
        """Spawn the batching thread; returns self for chaining.

        ``supervised=True`` changes what a driver-loop crash does: instead
        of failing every pending request and going fatal, the thread
        records the crash and dies with the queue INTACT — a supervisor (or
        a manual ``restart()``) then resumes service.  Unsupervised, a
        crash stays fatal exactly as before.
        """
        with self._cv:
            if self._state != _NEW:
                raise RuntimeError(f"driver already {self._state}")
            self._supervised = bool(supervised)
            self._state = _RUNNING
            self._hb = self._clock()
            self._thread = threading.Thread(
                target=self._run, args=(self._epoch,), name=self._name,
                daemon=True)
            self._thread.start()
        return self

    def restart(self) -> bool:
        """Replace a dead or hung driver thread; pending requests survive.

        Bumps the thread epoch — a hung-but-alive old thread notices the
        stale epoch at its next safe point and exits without touching
        shared state (its in-flight dispatch, if any, still resolves its
        own futures).  Returns False when the driver isn't running (there
        is nothing to revive).
        """
        with self._cv:
            if self._state != _RUNNING:
                return False
            self._crash = None
            self._epoch += 1
            self._hb = self._clock()
            self.stats.n_restarts += 1
            self._thread = threading.Thread(
                target=self._run, args=(self._epoch,),
                name=f"{self._name}-r{self._epoch}", daemon=True)
            self._thread.start()
            self._cv.notify_all()
        return True

    def health(self) -> Dict:
        """Liveness snapshot the supervisor (and deep health) polls."""
        with self._cv:
            now = self._clock()
            alive = self._thread is not None and self._thread.is_alive()
            oldest = (now - self._pending[0].t_arrival
                      if self._pending else 0.0)
            return {
                "state": self._state,
                "thread_alive": alive,
                "heartbeat_age_s": max(0.0, now - self._hb),
                "oldest_wait_s": oldest,
                "n_pending": len(self._pending),
                "n_restarts": self.stats.n_restarts,
                "crashed": self._crash is not None,
            }

    def kill(self, error: BaseException) -> None:
        """Supervisor gave up: fail everything pending and go fatal."""
        with self._cv:
            if self._state == _STOPPED:
                return
            self._fatal = error
            self._epoch += 1             # any surviving thread stands down
            self._finish_locked()

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Shut the driver down.

        ``drain=True`` serves every accepted request first; ``drain=False``
        cancels pending requests (their futures raise ``DriverStopped``).
        Idempotent.  Re-raises a fatal driver-loop error, and raises
        ``TimeoutError`` if the thread doesn't exit within ``timeout``.
        """
        with self._cv:
            if self._state == _STOPPED:
                if self._fatal is not None:
                    raise self._fatal
                return
            if self._state == _NEW:
                # never started: resolve the backlog inline on this thread
                self._state = _STOPPING
                if drain:
                    while self._pending:
                        self._dispatch(self._take_locked(
                            self.engine.policy.max_size), "drain")
                self._finish_locked()
                return
            if self._state == _RUNNING:
                self._state = _STOPPING
                self._drain = drain
                self._cv.notify_all()
            elif not drain and self._drain and self._join_timed_out:
                # already _STOPPING.  A concurrent stop(drain=True) owns the
                # drain policy — an abort racing a healthy drain must not
                # revoke the promise to serve accepted requests.  But once a
                # drain stop() has TIMED OUT the thread is presumed wedged,
                # and a retry with drain=False may DOWNGRADE the policy to
                # reclaim it instead of leaving the driver stuck in
                # _STOPPING forever.
                self._drain = False
                self._cv.notify_all()
        assert self._thread is not None
        self._thread.join(timeout)
        with self._cv:
            if self._thread.is_alive():
                self._join_timed_out = True
                raise TimeoutError(
                    f"driver thread did not stop within {timeout}s")
            if self._state != _STOPPED:
                # the thread is gone but never reached _finish_locked (it
                # crashed in supervised mode, or died uncleanly): complete
                # the shutdown on its behalf so stop() leaves no zombie
                # state behind
                self._finish_locked()
        if self._fatal is not None:
            raise self._fatal

    def __enter__(self) -> "EngineDriver":
        with self._cv:
            not_started = self._state == _NEW
        if not_started:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # clean exit drains; an exception in the body aborts (the caller is
        # unwinding — don't block on a backlog it no longer wants)
        self.stop(drain=exc_type is None)
        return False

    @property
    def running(self) -> bool:
        with self._cv:
            return self._state == _RUNNING

    @property
    def n_pending(self) -> int:
        with self._cv:
            return len(self._pending)

    # -- client API ----------------------------------------------------------
    def submit(self, request, *,
               timeout: Optional[float] = None) -> RetrievalFuture:
        """Enqueue one request from any thread; returns a
        ``RetrievalFuture``.

        ``request`` is a raw (D,)/(1, D) query vector or a
        `repro_torch.engine.request.SearchRequest` carrying per-request
        k/tenant/filter/deadline (a raw array means ``SearchRequest(query)``
        exactly).  Blocks while the pending queue is full (backpressure);
        raises ``DriverQueueFull`` if no slot frees within ``timeout`` and
        ``DriverStopped`` once the driver is shutting down.  Accepted before
        ``start()`` too — requests just wait for the thread (or an inline
        ``stop(drain=True)``).
        """
        req = self.engine.check_request(request)
        if self.cache is not None:
            hit = self._cache_lookup(req)
            if hit is not None:
                return hit
        fut = RetrievalFuture()
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._cv:
            while True:
                if self._fatal is not None:
                    raise DriverStopped(
                        "driver thread died") from self._fatal
                if self._state in (_STOPPING, _STOPPED):
                    raise DriverStopped("driver is not accepting requests")
                if len(self._pending) < self._max_queue:
                    break
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        raise DriverQueueFull(
                            f"pending queue held {self._max_queue} requests "
                            f"for {timeout}s")
                    self._cv.wait(remaining)
            self._pending.append(_Pending(req, fut, self._clock()))
            if req.trace is not None:
                req.trace.mark("admit")
            self.stats.n_submitted += 1
            if len(self._pending) > self.stats.queue_peak:
                self.stats.queue_peak = len(self._pending)
            self._cv.notify_all()
        return fut

    def _cache_lookup(self, req: PendingRequest
                      ) -> Optional[RetrievalFuture]:
        """Serve ``req`` from the query cache if possible.

        Runs on the client thread BEFORE the request enters the pending
        queue, so a hit skips batch formation and dispatch entirely.  The
        staleness stamp is read under ``engine.lock`` right here — a
        cached entry from before any store/mask/rebuild bump can never
        match it (the cache flushes on stamp change), so stale hits are
        structurally impossible.  Hits bypass the driver's
        n_submitted/n_completed accounting on purpose: those counters
        reconcile against engine batches, and no batch ran.
        """
        level = self.adaptive.level if self.adaptive is not None else 0
        stamp = self.engine.cache_stamp()
        got = self.cache.lookup(req.query, req.k, req.mask_key, level, stamp)
        if got is None:
            return None
        scores, ids, _kind = got
        now = time.perf_counter()
        st = RequestStats(
            latency_ms=(now - req.t_submit) * 1e3, queue_ms=0.0,
            compute_ms=0.0, bucket=0, batch_fill=0, compiled=False)
        fut = RetrievalFuture()
        fut._finish(result=RetrievalResult(
            -1, scores, ids, st, store_generation=stamp[0], cached=True,
            degraded_level=level))
        return fut

    def retrieve(self, request, *,
                 timeout: Optional[float] = None) -> RetrievalResult:
        """Blocking submit-and-wait (raw vector or `SearchRequest`);
        ``timeout`` bounds the whole round trip."""
        t0 = time.perf_counter()
        fut = self.submit(request, timeout=timeout)
        remaining = (None if timeout is None
                     else max(0.0, timeout - (time.perf_counter() - t0)))
        return fut.result(remaining)

    # -- batching loop -------------------------------------------------------
    def _take_locked(self, n: int) -> List[_Pending]:
        """Take up to ``n`` requests sharing the head's mask key.

        A dispatch applies ONE tenant/filter bitmask, so only same-key
        requests may share a batch; non-matching requests keep their order
        for the next iteration (the head always progresses — FIFO by the
        oldest request, no starvation).  Unfiltered traffic (mask_key None)
        batches exactly as before.
        """
        if not self._pending:
            return []
        key = self._pending[0].mask_key
        taken: List[_Pending] = []
        skipped: List[_Pending] = []
        while self._pending and len(taken) < n:
            p = self._pending.popleft()
            if p.mask_key == key:
                taken.append(p)
            else:
                skipped.append(p)
        self._pending.extendleft(reversed(skipped))
        now = self._clock()
        waits = [(now - p.t_arrival) for p in taken]
        self._h_wait.observe_many([w * 1e3 for w in waits])
        self._wait_samples.extend(waits)     # adaptive-policy p95 window
        # one real-clock read for the whole batch: trace marks live on the
        # perf_counter timebase (not the injectable policy clock)
        t_batch = time.perf_counter()
        for p in taken:
            if p.req.trace is not None:
                p.req.trace.marks["batch"] = t_batch
        return taken

    def _wait_p95_ms(self) -> Optional[float]:
        """p95 of the queue waits observed since the last policy update
        (caller holds the cv).  The window is consumed: stale overload
        samples must not keep blocking recovery once the queue is calm."""
        if not self._wait_samples:
            return None
        xs = sorted(self._wait_samples)
        self._wait_samples.clear()
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))] * 1e3

    def _collect_metrics(self) -> None:
        """Scrape-time collector: queue-depth gauge + counter totals
        (lock order: cv -> registry, same as every hot-path instrument)."""
        with self._cv:
            self._g_depth.set(float(len(self._pending)))
            self.stats.publish()
            if self.adaptive is not None:
                self.adaptive.publish()
        if self.cache is not None:
            self.cache.publish()

    def _finish_locked(self) -> None:
        """Cancel whatever is left and mark the driver stopped."""
        for p in self._pending:
            p.future._finish(error=DriverStopped(
                "driver stopped before this request was dispatched"))
            self.stats.n_cancelled += 1
        self._pending.clear()
        self._state = _STOPPED
        self._cv.notify_all()

    def _dispatch(self, chunk: List[_Pending], reason: str) -> None:
        """Run one flushed chunk through the engine and resolve its futures."""
        if not chunk:
            return
        # count the flush FIRST: the batcher formed and flushed this batch
        # under ``reason`` regardless of what the shedding below leaves of
        # it.  (Counting after the shed dropped the flush entirely for a
        # group whose members had all expired — the batch then vanished
        # from the flush accounting while its sheds still landed in
        # n_expired.)
        if reason == "full":
            self.stats.n_flush_full += 1
        elif reason == "deadline":
            self.stats.n_flush_deadline += 1
        else:
            self.stats.n_flush_drain += 1
        # drop requests whose client deadline already passed: their futures
        # fail with DeadlineExceeded and they never reach the device —
        # under overload this sheds exactly the work nobody waits for
        now = time.perf_counter()
        live: List[_Pending] = []
        for p in chunk:
            if p.req.deadline is not None and now > p.req.deadline:
                self.stats.n_expired += 1
                p.future._finish(error=DeadlineExceeded(
                    f"deadline expired {((now - p.req.deadline) * 1e3):.1f}ms "
                    f"before dispatch"))
            else:
                live.append(p)
        chunk = live
        if not chunk:
            # every member expired: nothing to dispatch — no empty/
            # degenerate batch may reach the engine
            return
        overrides = None
        if self.adaptive is not None:
            overrides = self.engine.overrides_for_level(self.adaptive.level)
        # static path keeps the bare legacy call shape: callers interposing
        # on execute_batch (tests, tracing wrappers) see no new kwarg
        # unless the policy actually degrades the dispatch
        kw = {} if overrides is None or overrides.level == 0 \
            else {"overrides": overrides}
        try:
            results = self.engine.execute_batch([p.req for p in chunk], **kw)
        except Exception as e:
            # fail this batch's clients — or, with bisection enabled,
            # isolate the offender so its co-batched neighbours still get
            # answers — and keep serving the next batch either way
            self.stats.n_batch_errors += 1
            if self._bisect and len(chunk) > 1:
                self.stats.n_bisections += 1
                self._bisect_failed(chunk, kw)
            else:
                for p in chunk:
                    p.future._finish(error=e)
            return
        self._resolve(chunk, results)

    def _bisect_failed(self, chunk: List[_Pending], kw: Dict) -> None:
        """Isolate the poison request(s) in a failing batch by bisection.

        Re-dispatches each half independently; halves that succeed resolve
        normally, halves that keep failing split again.  A failing
        singleton is the offender: its future gets ``RequestFailed`` (the
        HTTP layer's 503) and it is counted quarantined.  Deterministic
        per-request failures (the realistic poison shape: a query that
        trips a device/input bug on every dispatch) are isolated exactly;
        a transient batch-level error simply retries and succeeds.  Cost
        is O(log batch) extra dispatches per poison, paid only on batches
        that already failed.
        """
        mid = len(chunk) // 2
        for half in (chunk[:mid], chunk[mid:]):
            if not half:
                continue
            try:
                results = self.engine.execute_batch(
                    [p.req for p in half], **kw)
            except Exception as e:
                if len(half) == 1:
                    self.stats.n_quarantined += 1
                    half[0].future._finish(error=RequestFailed(
                        f"request isolated by batch bisection: {e}"))
                else:
                    self.stats.n_bisections += 1
                    self._bisect_failed(half, kw)
            else:
                self._resolve(half, results)

    def _resolve(self, chunk: List[_Pending], results) -> None:
        """Resolve a successfully dispatched chunk's futures + cache."""
        for p, res in zip(chunk, results):
            p.future._finish(result=res)
        self.stats.n_completed += len(chunk)
        if self.cache is not None:
            # stamp read AFTER the batch: if a mutation landed mid-window
            # the delivered results carry the older store_generation and
            # are skipped — never inserted against the newer stamp
            stamp = self.engine.cache_stamp()
            for p, res in zip(chunk, results):
                if res.store_generation != stamp[0]:
                    continue
                self.cache.insert(p.req.query, res.scores, res.doc_ids,
                                  p.req.mask_key, res.degraded_level, stamp)

    def _run(self, epoch: int = 0) -> None:
        try:
            while True:
                chunk: Optional[List[_Pending]] = None
                reason = ""
                with self._cv:
                    while chunk is None:
                        if self._epoch != epoch:
                            # a restart() replaced this thread while it was
                            # wedged: stand down without touching shared
                            # state — the replacement owns the queue now
                            return
                        self._hb = self._clock()
                        if self._state == _STOPPING:
                            if not self._drain or not self._pending:
                                self._finish_locked()
                                return
                            chunk = self._take_locked(
                                self.engine.policy.max_size)
                            reason = "drain"
                            break
                        if self.adaptive is not None:
                            # one controller step per loop iteration: the
                            # depth/wait signals are already in hand here,
                            # and single-writer discipline holds (only this
                            # thread moves the level)
                            self.adaptive.update(
                                len(self._pending), self._wait_p95_ms(),
                                self._clock())
                        d = self.batcher.decide(
                            len(self._pending),
                            self._pending[0].t_arrival
                            if self._pending else 0.0,
                            self._clock(),
                        )
                        if d.action == "flush":
                            chunk, reason = self._take_locked(d.n), d.reason
                        elif d.action == "wait":
                            # supervised: cap the batching wait so the loop
                            # wakes to re-stamp the heartbeat — a thread
                            # waiting out a long max_wait_ms with requests
                            # pending is healthy, and must not look hung
                            w = d.wait_s
                            if self._supervised:
                                w = min(w, self.engine.config.fault
                                        .heartbeat_timeout_s / 2)
                            self._cv.wait(w)
                        elif (self.adaptive is not None
                                and self.adaptive.level > 0):
                            # idle while degraded: wake periodically so the
                            # hysteretic recovery can tick even with no
                            # arrivals to prod the loop
                            self._cv.wait(
                                max(0.05, self.adaptive.cfg.hysteresis_s / 4))
                        else:                     # idle: block for arrivals
                            self._cv.wait()
                    self._cv.notify_all()         # queue space freed
                # dispatch outside the cv so producers keep submitting while
                # the device computes (engine.lock still serializes engine
                # access)
                try:
                    self._dispatch(chunk, reason)
                except BaseException:
                    # a dispatch-path error past _dispatch's own handler is
                    # about to kill this thread: fail the chunk's unresolved
                    # futures first so no client blocks forever on a future
                    # nobody owns anymore
                    for p in chunk:
                        if not p.future.done():
                            p.future._finish(error=DriverStopped(
                                "driver thread died mid-dispatch"))
                    raise
                with self._cv:
                    self._hb = self._clock()
        except BaseException as e:
            with self._cv:
                if self._epoch != epoch:
                    return                        # superseded: stay silent
                if self._supervised and self._state == _RUNNING:
                    # supervised crash: record it and die with the pending
                    # queue INTACT — the supervisor restarts a fresh thread
                    # that picks the backlog right back up
                    self._crash = e
                    self.stats.n_driver_crashes += 1
                    return
                self._fatal = e
                self._finish_locked()

    def describe(self) -> str:
        return (
            f"EngineDriver(max_wait_ms={self.batcher.max_wait_s * 1e3:g}, "
            f"max_queue={self._max_queue}, state={self._state}, "
            f"engine={self.engine.describe()})"
        )
