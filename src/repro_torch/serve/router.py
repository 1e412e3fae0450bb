"""Replica routing front-end: health-checked failover over N serving
replicas, with circuit breakers, bounded retries, hedging, and
read-your-writes consistency tokens.

`ReplicaRouter` fronts a set of replica base URLs (one primary + any
number of followers, each a `RetrievalHTTPServer`):

* **Probes** — a background thread hits each replica's
  ``/healthz?deep=1`` every ``probe_interval_s``, recording liveness,
  readiness (recovery/catch-up done), role, and ``applied_seq``/lag.
* **Circuit breaker** — per replica, the `Supervisor` discipline:
  ``failure_threshold`` consecutive failures open it; while open the
  replica gets no traffic; after a capped-exponential backoff one
  half-open probe is allowed through, success closes, failure re-opens
  with a doubled (capped) backoff.
* **Retries** — `RetryPolicy`: bounded attempts with jittered capped
  backoff, only on retryable failures (connection errors, 503, 504) and
  NEVER on 4xx (a 400/403/429 means the request itself, or the tenant's
  quota, is the problem — another replica would answer the same).
  Searches fail over to the next healthy replica immediately; mutations
  retry only on 503/504, never on a connection error (the primary may
  have applied the mutation before the socket died, and a blind resend
  would double-apply).
* **Hedging** — optionally fire a second attempt at a different replica
  once the first has been in flight ``hedge_ms`` (or, at ``hedge_ms=0``,
  an adaptive p95 of recent search latencies); first response wins, the
  loser is cancelled (abandoned if already on the wire — the losing
  replica still finishes serving it, which is the standard cost of
  tail-latency hedging).
* **Read-your-writes** — mutations return the primary's WAL ``seq``;
  a client passing it back as ``min_seq`` is routed to a replica whose
  probed ``applied_seq`` covers it (falling back to the most caught-up
  replica, whose serving path then *blocks* until the seq applies or the
  deadline passes — the guarantee holds even when probe data is stale).

`RouterHTTPServer` exposes the same ``/v1/*`` surface over the router so
clients keep speaking one protocol; its ``/metrics`` carries per-replica
lag/breaker gauges plus hedge/failover/retry counters.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import MetricsRegistry
from repro_torch.serve.http import AsyncHTTPBase, _HTTPError, _Raw

__all__ = ["CircuitBreaker", "ReplicaRouter", "RetryPolicy",
           "RouterHTTPServer", "http_call"]


def http_call(url: str, path: str, body: Optional[Dict] = None, *,
              method: Optional[str] = None,
              timeout: float = 30.0) -> Tuple[int, Dict]:
    """One JSON round trip; returns ``(status, payload)``.

    Never raises: connection-level failures (refused, reset, DNS, socket
    timeout) come back as status ``0`` — the retry policies treat 0 like
    a 503.  Non-JSON bodies degrade to ``{"error": ...}``.
    """
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        headers={"Content-Type": "application/json"} if data else {},
        method=method or ("POST" if data is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read() or b"{}")
        except Exception:
            payload = {"error": str(e)}
        return e.code, payload
    except Exception as e:
        return 0, {"error": f"connection error: "
                            f"{getattr(e, 'reason', None) or e}"}


class RetryPolicy:
    """Bounded retry with jittered, capped exponential backoff.

    Retryable: connection errors (status 0), 503, 504.  Never 4xx — those
    are the request's (or tenant's) fault and will fail identically
    everywhere.  Shared by the router and the ``--connect`` CLI client so
    both ends of the wire apply the same discipline.
    """

    RETRYABLE = (0, 503, 504)

    def __init__(self, *, max_attempts: int = 3, backoff_s: float = 0.05,
                 backoff_max_s: float = 1.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def retryable(self, status: int) -> bool:
        return status in self.RETRYABLE

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (0-based), jittered
        upward by up to ``jitter`` of the base."""
        base = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        return base * (1.0 + self.jitter * self._rng.random())

    def run(self, fn, *, sleep=time.sleep, on_retry=None):
        """Drive ``fn(attempt) -> (status, payload)`` through the policy;
        returns the last ``(status, payload)``."""
        status, payload = 0, {"error": "no attempts made"}
        for attempt in range(self.max_attempts):
            status, payload = fn(attempt)
            if not self.retryable(status) \
                    or attempt == self.max_attempts - 1:
                return status, payload
            if on_retry is not None:
                on_retry(attempt, status)
            sleep(self.backoff(attempt))
        return status, payload


class CircuitBreaker:
    """Per-replica consecutive-failure breaker (`Supervisor` discipline).

    closed -> (``threshold`` consecutive failures) -> open ->
    (capped-exponential backoff elapses) -> half-open: exactly one trial
    request goes through; success closes and resets the backoff, failure
    re-opens with the backoff doubled (capped at ``open_max_s``).
    """

    def __init__(self, *, threshold: int = 3, open_s: float = 0.25,
                 open_max_s: float = 2.0, clock=time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.open_s = float(open_s)
        self.open_max_s = float(open_max_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive = 0
        self.n_trips = 0
        self._retry_at = 0.0
        self._trial_free = True

    def allow(self) -> bool:
        """Non-consuming admission check (see ``on_attempt``)."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return self._clock() >= self._retry_at
            return self._trial_free                    # half-open

    def on_attempt(self) -> None:
        """A request is actually being sent: claim the half-open trial."""
        with self._lock:
            if self.state == "open" and self._clock() >= self._retry_at:
                self.state = "half_open"
                self._trial_free = False
            elif self.state == "half_open":
                self._trial_free = False

    def record_success(self) -> None:
        with self._lock:
            self.state = "closed"
            self.consecutive = 0
            self.n_trips = 0
            self._trial_free = True

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive += 1
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self.consecutive >= self.threshold):
                self.n_trips += 1
                backoff = min(self.open_s * (2 ** (self.n_trips - 1)),
                              self.open_max_s)
                self.state = "open"
                self._retry_at = self._clock() + backoff
                self._trial_free = True
            elif self.state == "open":
                # a straggler failure while already open: push retry out
                pass

    def summary(self) -> Dict:
        with self._lock:
            return {"state": self.state, "consecutive": self.consecutive,
                    "n_trips": self.n_trips,
                    "retry_in_s": max(0.0, self._retry_at - self._clock())
                    if self.state == "open" else 0.0}


class ReplicaEndpoint:
    """Router-side view of one replica."""

    def __init__(self, url: str, breaker: CircuitBreaker):
        self.url = url.rstrip("/")
        self.breaker = breaker
        self.alive = False
        self.ready = False
        self.role = "unknown"
        self.applied_seq = -1
        self.replica_lag = -1
        self.n_probes = 0
        self.n_served = 0
        self.n_errors = 0
        self.last_probe: Optional[Dict] = None

    def status(self) -> Dict:
        return {
            "url": self.url, "alive": self.alive, "ready": self.ready,
            "role": self.role, "applied_seq": self.applied_seq,
            "replica_lag": self.replica_lag, "breaker":
            self.breaker.summary(), "n_probes": self.n_probes,
            "n_served": self.n_served, "n_errors": self.n_errors,
        }


# breaker-state gauge encoding: closed=0, half_open=1, open=2
_BREAKER_CODE = {"closed": 0, "half_open": 1, "open": 2}


class ReplicaRouter:
    """Spreads searches across healthy replicas; mutations to the primary.

    ``search``/``mutate`` return ``(status, payload, served_by_url)`` with
    the same status-code taxonomy the replicas speak, so `RouterHTTPServer`
    (or any embedder) can relay them verbatim.
    """

    def __init__(self, replica_urls: Sequence[str], *,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 failure_threshold: int = 3,
                 breaker_open_s: float = 0.25,
                 breaker_open_max_s: float = 2.0,
                 retry: Optional[RetryPolicy] = None,
                 hedge_ms: Optional[float] = None,
                 request_timeout_s: float = 30.0,
                 registry: Optional[MetricsRegistry] = None):
        if not replica_urls:
            raise ValueError("ReplicaRouter needs at least one replica URL")
        self.replicas = [
            ReplicaEndpoint(u, CircuitBreaker(
                threshold=failure_threshold, open_s=breaker_open_s,
                open_max_s=breaker_open_max_s))
            for u in replica_urls]
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.retry = retry if retry is not None else RetryPolicy()
        self.hedge_ms = hedge_ms
        self.request_timeout_s = float(request_timeout_s)
        self._rr = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self.replicas)),
            thread_name_prefix="router-attempt")
        self._latencies: List[float] = []      # recent search ms, ring
        self.metrics = registry if registry is not None else MetricsRegistry()
        reg = self.metrics
        self._c_req = reg.counter(
            "repro_router_requests_total",
            "Router responses, by route and status", labels=("route",
                                                             "status"))
        self._c_retries = reg.counter(
            "repro_router_retries_total", "Retried attempts")
        self._c_failovers = reg.counter(
            "repro_router_failovers_total",
            "Attempts moved to a different replica after a failure")
        self._c_hedges = reg.counter(
            "repro_router_hedges_total", "Hedge attempts fired")
        self._c_hedge_wins = reg.counter(
            "repro_router_hedge_wins_total",
            "Hedged requests answered first by the hedge")
        self._c_probe_fail = reg.counter(
            "repro_router_probe_failures_total",
            "Failed health probes", labels=("replica",))
        self._g_up = reg.gauge(
            "repro_router_replica_up", "1 = probe ok", labels=("replica",))
        self._g_ready = reg.gauge(
            "repro_router_replica_ready", "1 = replica ready",
            labels=("replica",))
        self._g_lag = reg.gauge(
            "repro_router_replica_lag",
            "Replica WAL records behind the primary", labels=("replica",))
        self._g_breaker = reg.gauge(
            "repro_router_breaker_state",
            "0 closed / 1 half-open / 2 open", labels=("replica",))
        self._h_latency = reg.histogram(
            "repro_router_attempt_ms", "Per-attempt latency",
            labels=("route",))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaRouter":
        """Probe everything once (synchronously), then keep probing in the
        background."""
        self.probe_all()
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._probe_loop, name="router-probe", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None
        self._pool.shutdown(wait=False)

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self.probe_all()

    # -- probing -------------------------------------------------------------
    def probe_all(self) -> None:
        for ep in self.replicas:
            self._probe(ep)

    def _probe(self, ep: ReplicaEndpoint) -> None:
        status, payload = http_call(ep.url, "/healthz?deep=1",
                                    timeout=self.probe_timeout_s)
        ep.n_probes += 1
        if status == 200:
            ep.alive = True
            ep.ready = bool(payload.get("ready", True))
            ep.role = payload.get("role", "single")
            ep.applied_seq = int(payload.get("applied_seq", -1))
            ep.replica_lag = int(payload.get("replica_lag", -1))
            ep.last_probe = {k: payload.get(k) for k in
                             ("status", "n_docs", "ready", "role",
                              "applied_seq", "replica_lag")}
            ep.breaker.record_success()
        else:
            ep.alive = False
            ep.ready = False
            ep.breaker.record_failure()
            self._c_probe_fail.inc(replica=ep.url)
        self._g_up.set(1.0 if ep.alive else 0.0, replica=ep.url)
        self._g_ready.set(1.0 if ep.ready else 0.0, replica=ep.url)
        self._g_lag.set(float(max(ep.replica_lag, 0)), replica=ep.url)
        self._g_breaker.set(float(_BREAKER_CODE[ep.breaker.state]),
                            replica=ep.url)

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 30.0) -> bool:
        """Block until ``n`` replicas (default: all) probe ready."""
        want = len(self.replicas) if n is None else int(n)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.probe_all()
            if sum(1 for ep in self.replicas if ep.ready) >= want:
                return True
            time.sleep(min(0.05, self.probe_interval_s))
        return False

    # -- selection -----------------------------------------------------------
    def _candidates(self, min_seq: Optional[int]) -> List[ReplicaEndpoint]:
        """Healthy replicas in round-robin order; with a ``min_seq`` token,
        caught-up replicas first (stale-probe fallback: the replica itself
        still enforces the token by waiting)."""
        with self._lock:
            i = self._rr
            self._rr += 1
        eps = [ep for ep in self.replicas
               if ep.ready and ep.breaker.allow()]
        if not eps:
            return []
        rot = eps[i % len(eps):] + eps[:i % len(eps)]
        if min_seq is None:
            return rot
        caught = [ep for ep in rot if ep.applied_seq >= min_seq]
        behind = sorted((ep for ep in rot if ep.applied_seq < min_seq),
                        key=lambda ep: -ep.applied_seq)
        return caught + behind

    def _primary(self) -> Optional[ReplicaEndpoint]:
        for ep in self.replicas:
            if ep.role in ("primary", "single") and ep.alive \
                    and ep.breaker.allow():
                return ep
        return None

    # -- attempts ------------------------------------------------------------
    @staticmethod
    def _is_final(status: int) -> bool:
        """Response statuses relayed to the client without failover: any
        success, and every 4xx (including 429 — the tenant's quota follows
        the tenant, not the replica)."""
        return 200 <= status < 500 and status != 0

    def _attempt(self, ep: ReplicaEndpoint, path: str, body: Dict,
                 timeout: float, route: str) -> Tuple[int, Dict]:
        ep.breaker.on_attempt()
        t0 = time.perf_counter()
        status, payload = http_call(ep.url, path, body, timeout=timeout)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._h_latency.observe(dt_ms, route=route)
        if self._is_final(status):
            ep.breaker.record_success()
            ep.n_served += 1
            if route == "search":
                with self._lock:
                    self._latencies.append(dt_ms)
                    if len(self._latencies) > 256:
                        del self._latencies[:128]
        else:
            ep.breaker.record_failure()
            ep.n_errors += 1
        return status, payload

    def _hedge_delay_s(self) -> Optional[float]:
        if self.hedge_ms is None:
            return None
        if self.hedge_ms > 0:
            return self.hedge_ms / 1e3
        with self._lock:                       # hedge_ms == 0: adaptive p95
            lats = list(self._latencies)
        if len(lats) < 8:
            return None
        lats.sort()
        return lats[int(0.95 * (len(lats) - 1))] / 1e3

    # -- client surface ------------------------------------------------------
    def search(self, body: Dict,
               timeout: Optional[float] = None
               ) -> Tuple[int, Dict, Optional[str]]:
        """Route one search; returns ``(status, payload, served_by_url)``."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.request_timeout_s)
        min_seq = body.get("min_seq")
        last: Tuple[int, Dict, Optional[str]] = (
            503, {"error": "no ready replicas"}, None)
        failed: set = set()                    # replicas this call tried
        for attempt in range(self.retry.max_attempts):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                st, pl, by = last
                return (504, {"error": "router deadline exhausted",
                              "last": pl}, by)
            cands = self._candidates(
                int(min_seq) if min_seq is not None else None)
            # fail over to a replica this call has not tried yet: the
            # round-robin counter moves with every concurrent call, so
            # the rotation alone can hand a retry the replica that just
            # failed (until its breaker opens or a probe marks it down)
            cands = [ep for ep in cands if ep.url not in failed] or cands
            if not cands:
                # nothing healthy right now: wait out a probe tick
                if attempt < self.retry.max_attempts - 1:
                    time.sleep(min(self.probe_interval_s, remaining))
                    continue
                break
            (status, payload), ep = self._attempt_maybe_hedged(
                cands, "/v1/search", body, remaining, "search")
            last = (status, payload, ep.url)
            if self._is_final(status):
                self._count("search", status)
                return last
            failed.add(ep.url)
            if attempt < self.retry.max_attempts - 1:
                self._c_retries.inc()
                if len(cands) > 1:
                    # another replica is healthy: fail over immediately
                    self._c_failovers.inc()
                else:
                    time.sleep(min(self.retry.backoff(attempt),
                                   max(0.0, deadline - time.monotonic())))
        self._count("search", last[0])
        return last

    def _attempt_maybe_hedged(
            self, cands: List[ReplicaEndpoint], path: str, body: Dict,
            remaining: float, route: str
    ) -> Tuple[Tuple[int, Dict], ReplicaEndpoint]:
        ep = cands[0]
        delay = self._hedge_delay_s()
        if delay is None or len(cands) < 2 or delay >= remaining:
            return self._attempt(ep, path, body, remaining, route), ep
        f1 = self._pool.submit(self._attempt, ep, path, body, remaining,
                               route)
        try:
            return f1.result(timeout=delay), ep
        except FutureTimeout:
            pass
        self._c_hedges.inc()                   # primary attempt is slow
        ep2 = cands[1]
        f2 = self._pool.submit(self._attempt, ep2, path, body,
                               max(0.0, remaining - delay), route)
        futs = {f1: ep, f2: ep2}
        result, winner = (0, {"error": "hedge bookkeeping"}), ep
        while futs:
            done, _ = futures_wait(set(futs), return_when=FIRST_COMPLETED)
            for f in done:
                e = futs.pop(f)
                result = f.result()
                winner = e
                if self._is_final(result[0]) or not futs:
                    for straggler in futs:     # loser cancelled/abandoned
                        straggler.cancel()
                    if winner is ep2:
                        self._c_hedge_wins.inc()
                    return result, winner
        return result, winner                  # pragma: no cover

    def mutate(self, path: str, body: Dict,
               timeout: Optional[float] = None
               ) -> Tuple[int, Dict, Optional[str]]:
        """Forward a mutation to the primary; retries ONLY on 503/504 —
        a connection error mid-mutation is ambiguous (the primary may have
        logged it) and a blind resend could double-apply, so it surfaces
        to the caller as status 0."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.request_timeout_s)
        last: Tuple[int, Dict, Optional[str]] = (
            503, {"error": "no live primary"}, None)
        for attempt in range(self.retry.max_attempts):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return (504, {"error": "router deadline exhausted",
                              "last": last[1]}, last[2])
            ep = self._primary()
            if ep is None:
                if attempt < self.retry.max_attempts - 1:
                    time.sleep(min(self.probe_interval_s, remaining))
                    continue
                break
            status, payload = self._attempt(ep, path, body, remaining,
                                            "mutate")
            last = (status, payload, ep.url)
            if status not in (503, 504):
                self._count("mutate", status)
                return last
            if attempt < self.retry.max_attempts - 1:
                self._c_retries.inc()
                time.sleep(min(self.retry.backoff(attempt),
                               max(0.0, deadline - time.monotonic())))
        self._count("mutate", last[0])
        return last

    def _count(self, route: str, status: int) -> None:
        self._c_req.inc(route=route, status=status)

    def status(self) -> Dict:
        return {
            "replicas": [ep.status() for ep in self.replicas],
            "n_ready": sum(1 for ep in self.replicas if ep.ready),
            "hedge_ms": self.hedge_ms,
            "probe_interval_s": self.probe_interval_s,
        }


_ROUTER_ROUTE_PATHS = (
    ("GET", "/healthz"), ("GET", "/metrics"), ("GET", "/v1/replicas"),
    ("POST", "/v1/search"), ("POST", "/v1/docs"),
    ("POST", "/v1/docs/delete"),
)


class RouterHTTPServer(AsyncHTTPBase):
    """HTTP front door over a `ReplicaRouter` — clients speak the exact
    same ``/v1/*`` protocol to the router as to a single replica."""

    route_paths = _ROUTER_ROUTE_PATHS

    def __init__(self, router: ReplicaRouter, *, host: str = "127.0.0.1",
                 port: int = 0, max_body: int = 64 << 20):
        super().__init__(host=host, port=port, max_body=max_body)
        self.router = router

    def _observe(self, route: str, status: int, dt_ms: float) -> None:
        self.router.metrics.counter(
            "repro_router_http_requests_total",
            "Router HTTP responses, by route and status",
            labels=("route", "status")).inc(route=route, status=status)

    def _routes(self) -> Dict[Tuple[str, str], Any]:
        return {
            ("GET", "/healthz"): self._do_health,
            ("GET", "/metrics"): self._do_metrics,
            ("GET", "/v1/replicas"): self._do_replicas,
            ("POST", "/v1/search"): self._do_search,
            ("POST", "/v1/docs"): self._do_add,
            ("POST", "/v1/docs/delete"): self._do_delete,
        }

    # -- handlers ------------------------------------------------------------
    def _do_health(self, body: Dict) -> Dict:
        st = self.router.status()
        out = {"status": "ok", "role": "router",
               "n_ready": st["n_ready"],
               "n_replicas": len(st["replicas"])}
        if str(body.get("ready", "")).lower() in ("1", "true", "yes") \
                and st["n_ready"] == 0:
            raise _HTTPError(503, "no ready replicas behind the router")
        if str(body.get("deep", "")).lower() in ("1", "true", "yes"):
            out["deep"] = st
        return out

    def _do_metrics(self, body: Dict) -> _Raw:
        return _Raw(self.router.metrics.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")

    def _do_replicas(self, body: Dict) -> Dict:
        return self.router.status()

    def _relay(self, status: int, payload: Dict,
               served_by: Optional[str]) -> Tuple[Dict, Dict[str, str]]:
        if 200 <= status < 300:
            out = dict(payload)
            out["served_by"] = served_by
            return out, {"served-by": served_by or ""}
        headers = {"Retry-After": "1"} if status in (429, 503) else {}
        raise _HTTPError(status if status != 0 else 503,
                         payload.get("error", "replica error"), headers)

    def _do_search(self, body: Dict) -> Tuple[Dict, Dict[str, str]]:
        timeout = None
        if body.get("deadline_ms") is not None:
            timeout = float(body["deadline_ms"]) / 1e3
        return self._relay(*self.router.search(body, timeout=timeout))

    def _do_add(self, body: Dict) -> Tuple[Dict, Dict[str, str]]:
        return self._relay(*self.router.mutate("/v1/docs", body))

    def _do_delete(self, body: Dict) -> Tuple[Dict, Dict[str, str]]:
        return self._relay(*self.router.mutate("/v1/docs/delete", body))
