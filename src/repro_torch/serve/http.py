"""Stdlib asyncio HTTP/1.1 front-end over the engine driver.

One small server, zero new search code: every request path below ends in
the primitives the engine already exposes.  Tenancy and metadata filters
ride the ``SearchRequest`` mask-key path (the driver batches same-key
requests together and the dispatch ANDs one bitmask into the validity
mask); admission control is `repro_torch.serve.quota.TenantQuotas` in front of
the driver's bounded queue, so a tenant at its cap gets a fast 429 while
the queue keeps serving everyone else.

The handlers touch no tensor: results arrive as numpy arrays, queries and
added vectors leave as float32 numpy arrays (``add_docs`` copies them to
the device once), and the delete path's ownership checks read the store's
host mirrors.  ``engine.lock`` is the only serialisation between executor
threads, the driver thread and a follower's WAL applier.

Endpoints (JSON in, JSON out — except ``/metrics``, which is Prometheus
text exposition):

  GET  /healthz          liveness: 200 once the driver thread is running;
                         ``?ready=1`` additionally 503s until recovery/WAL
                         replay (and, on followers, catch-up within the
                         lag bound) completes — the router probes this;
                         ``?deep=1`` adds driver heartbeat age, supervisor
                         state, WAL lag, replication status and the last
                         recovery report
  GET  /metrics          Prometheus text exposition of the engine registry
  GET  /v1/stats         engine + driver counters, tenants, config, quotas
  GET  /v1/traces        recent request traces + slow-query records
  POST /v1/search        {"query": [f32...], "k", "tenant", "filter",
                          "deadline_ms", "min_seq"} -> {"ids", "scores",
                          "spans", ...}; ``min_seq`` is a read-your-writes
                          token: the replica waits (bounded) until its
                          applied WAL seq covers it, else a retryable 503
  POST /v1/docs          {"vectors": [[f32...]...], "tenant", "metadata"}
                          -> {"ids": [...], "seq"} (seq = the mutation's
                          WAL position: the consistency token)
  POST /v1/docs/delete   {"ids": [...], "tenant"} -> {"n_deleted", "seq"}

Every response is also counted into the engine's metrics registry
(``repro_http_requests_total{route,status}`` +
``repro_http_request_ms{route}``), so the server observes itself through
the same ``/metrics`` surface it serves.

Status mapping — the error taxonomy the engine grew for exactly this:

  400  malformed JSON / bad filter spec (``FilterError``) / bad shapes
  403  a tenant touching another tenant's documents
  404  unknown path          405  wrong method          413  body too large
  429  ``QuotaExceeded`` (per-tenant cap) or ``DriverQueueFull`` (global
       backpressure) — retryable, with a Retry-After hint
  503  driver stopped, or the request was isolated as the poison member
       of a failing batch (``RequestFailed``)
  504  ``DeadlineExceeded`` / result timeout

``require_tenant=True`` (the default) refuses tenantless searches and
mutations with 400: the tenantless pool is the embedded/admin view, not
something to expose over a network socket.  Blocking driver calls run in
the event loop's default executor so slow searches never stall the
accept loop; ``serve_in_thread`` wraps the whole thing for tests, the
launcher and ``chip_smoke.py``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.engine import (
    DeadlineExceeded,
    DriverQueueFull,
    DriverStopped,
    EngineDriver,
    FilterError,
    RequestFailed,
    RetrievalEngine,
    SearchRequest,
)
from repro_torch.serve.quota import QuotaExceeded, TenantQuotas

_REASONS = {
    200: "OK", 400: "Bad Request", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

# (method, path) pairs the server routes — also the bounded label universe
# for the per-route HTTP metrics
_ROUTE_PATHS = (
    ("GET", "/healthz"), ("GET", "/metrics"), ("GET", "/v1/stats"),
    ("GET", "/v1/traces"), ("POST", "/v1/search"), ("POST", "/v1/docs"),
    ("POST", "/v1/docs/delete"),
)


class _HTTPError(Exception):
    """Internal control flow: a handler's early exit with a status code."""

    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.headers = headers or {}


def _body_field(body: Dict, field: str) -> Any:
    try:
        return body[field]
    except KeyError:
        raise _HTTPError(400, f"missing required field {field!r}") from None


@dataclasses.dataclass
class _Raw:
    """A handler's non-JSON response body (e.g. Prometheus exposition)."""

    data: bytes
    content_type: str = "text/plain; charset=utf-8"


class AsyncHTTPBase:
    """Connection plumbing shared by every server in the serving tier.

    Owns the listener lifecycle, HTTP/1.1 request framing (keep-alive,
    body limits), response writing, query-string merging, executor
    dispatch of blocking handlers, and the error-taxonomy -> status-code
    mapping.  Subclasses (`RetrievalHTTPServer`, the router's
    `RouterHTTPServer`) provide a route table via ``_routes()`` and may
    override ``_observe`` to count responses into their own registry.
    """

    # (method, path) pairs the subclass routes — also the bounded label
    # universe for per-route metrics (unknown paths collapse together)
    route_paths: Tuple[Tuple[str, str], ...] = ()

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 max_body: int = 64 << 20):
        self._host = host
        self._port = int(port)
        self.max_body = int(max_body)
        self._server: Optional[asyncio.base_events.Server] = None

    # -- subclass surface ----------------------------------------------------
    def _routes(self) -> Dict[Tuple[str, str], Any]:
        raise NotImplementedError

    def _observe(self, route: str, status: int, dt_ms: float) -> None:
        """Per-response metrics hook (default: none)."""

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def host(self) -> str:
        return self._host

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    # -- connection handling -------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                method, path, body, keep_alive = request
                status, payload, headers = await self._route(
                    method, path, body)
                await self._write_response(
                    writer, status, payload, headers, keep_alive)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass                               # client went away mid-request
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Optional[Tuple[str, str, bytes, bool]]:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise asyncio.IncompleteReadError(line, None)
        method, path, version = parts
        headers: Dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            name, _, value = raw.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > self.max_body:
            # don't read the body; the 413 response closes the connection
            return method, path, b"__too_large__", False
        body = await reader.readexactly(length) if length else b""
        keep_alive = (headers.get(
            "connection",
            "keep-alive" if version == "HTTP/1.1" else "close",
        ).lower() != "close")
        return method, path, body, keep_alive

    async def _write_response(self, writer: asyncio.StreamWriter,
                              status: int, payload: Dict,
                              headers: Dict[str, str],
                              keep_alive: bool) -> None:
        if isinstance(payload, _Raw):
            data, content_type = payload.data, payload.content_type
        else:
            data, content_type = json.dumps(payload).encode(), \
                "application/json"
        head = [
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(data)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}",
        ]
        head += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await writer.drain()

    # -- routing -------------------------------------------------------------
    async def _route(self, method: str, path: str,
                     body: bytes) -> Tuple[int, Dict, Dict[str, str]]:
        """Instrumented routing: every response lands in the subclass's
        per-route status counter and latency histogram (unknown paths
        collapse into one ``__other__`` route so scans can't explode the
        label space past the registry's own series cap)."""
        t0 = time.perf_counter()
        status, payload, headers = await self._route_inner(
            method, path, body)
        bare = path.split("?", 1)[0]
        route = bare if any(p == bare for (_, p) in self.route_paths) \
            else "__other__"
        self._observe(route, status, (time.perf_counter() - t0) * 1e3)
        return status, payload, headers

    async def _route_inner(self, method: str, path: str,
                           body: bytes) -> Tuple[int, Dict, Dict[str, str]]:
        if body == b"__too_large__":
            return 413, {"error": "request body exceeds "
                                  f"{self.max_body} bytes"}, {}
        path, _, qs = path.partition("?")
        params = dict(urllib.parse.parse_qsl(qs)) if qs else {}
        routes = self._routes()
        handler = routes.get((method, path))
        if handler is None:
            if any(p == path for (_, p) in routes):
                return 405, {"error": f"{method} not allowed on {path}"}, {}
            return 404, {"error": f"no route for {path}"}, {}
        if method == "POST":
            try:
                parsed = json.loads(body.decode() or "null")
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                return 400, {"error": f"malformed JSON body: {e}"}, {}
            if not isinstance(parsed, dict):
                return 400, {"error": "request body must be a JSON "
                                      "object"}, {}
        else:
            parsed = {}
        for key, value in params.items():      # body keys win over the qs
            parsed.setdefault(key, value)
        loop = asyncio.get_event_loop()
        try:
            # handlers are blocking (driver futures, device work): run them
            # on the default executor so the accept loop stays responsive
            payload = await loop.run_in_executor(None, handler, parsed)
            if isinstance(payload, tuple):     # (payload, extra headers)
                payload, headers = payload
                return 200, payload, headers
            return 200, payload, {}
        except _HTTPError as e:
            return e.status, {"error": str(e)}, e.headers
        except (FilterError, ValueError, IndexError, TypeError) as e:
            return 400, {"error": str(e)}, {}
        except QuotaExceeded as e:
            return 429, {"error": str(e), "tenant": e.tenant,
                         "limit": e.limit}, {"Retry-After": "1"}
        except DriverQueueFull as e:
            return 429, {"error": str(e),
                         "limit": "queue"}, {"Retry-After": "1"}
        except RequestFailed as e:
            return 503, {"error": str(e), "isolated": True}, {}
        except DriverStopped as e:
            return 503, {"error": str(e)}, {}
        except (DeadlineExceeded, TimeoutError) as e:
            return 504, {"error": str(e)}, {}
        except Exception as e:                 # pragma: no cover
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}


class RetrievalHTTPServer(AsyncHTTPBase):
    """Asyncio HTTP server over one engine + driver pair.

    Args:
      engine:          the engine (used directly for corpus mutations and
                       stats; its lock makes quota-check + add atomic).
      driver:          the running driver that serves searches.
      quotas:          per-tenant admission limits (default: a permissive
                       ``TenantQuotas()`` — 64 in-flight, unlimited docs).
      require_tenant:  refuse tenantless search/add/delete with 400
                       (default True; turn off for single-tenant or admin
                       deployments).
      host/port:       bind address; port 0 picks a free port (read it
                       back from ``server.port`` after ``start()``).
      submit_timeout:  seconds a search waits for driver-queue space
                       before 429 (small on purpose: shed, don't buffer).
      result_timeout:  hard cap on one search round trip before 504.
      max_body:        request-body byte limit (413 past it).
      replication:     this replica's replication surface
                       (``PrimaryReplication`` / ``ReplicaApplier``):
                       drives ``/healthz?ready=1``, the deep-health
                       ``replication`` section, and ``min_seq``
                       read-your-writes waits.  None = unreplicated.
      read_only:       refuse mutations with 403 (follower replicas: the
                       primary owns the log; a 403 is deliberately
                       non-retryable so a misrouted write fails loudly).
    """

    route_paths = _ROUTE_PATHS

    def __init__(
        self,
        engine: RetrievalEngine,
        driver: EngineDriver,
        *,
        quotas: Optional[TenantQuotas] = None,
        require_tenant: bool = True,
        host: str = "127.0.0.1",
        port: int = 0,
        submit_timeout: float = 0.05,
        result_timeout: float = 60.0,
        max_body: int = 64 << 20,
        replication: Optional[Any] = None,
        read_only: bool = False,
    ):
        super().__init__(host=host, port=port, max_body=max_body)
        self.engine = engine
        self.driver = driver
        self.quotas = quotas if quotas is not None else TenantQuotas()
        self.require_tenant = bool(require_tenant)
        self.submit_timeout = float(submit_timeout)
        self.result_timeout = float(result_timeout)
        self.replication = replication
        self.read_only = bool(read_only)
        # HTTP-layer metrics live in the engine's registry so one /metrics
        # scrape covers the whole serving spine; quota rejections join it
        reg = engine.metrics
        self._c_http = reg.counter(
            "repro_http_requests_total",
            "HTTP responses, by route and status code",
            labels=("route", "status"))
        self._h_http = reg.histogram(
            "repro_http_request_ms", "HTTP request handling latency",
            labels=("route",))
        self.quotas.bind_registry(reg)

    def _observe(self, route: str, status: int, dt_ms: float) -> None:
        self._c_http.inc(route=route, status=status)
        self._h_http.observe(dt_ms, route=route)

    def _routes(self) -> Dict[Tuple[str, str], Any]:
        return {
            ("GET", "/healthz"): self._do_health,
            ("GET", "/metrics"): self._do_metrics,
            ("GET", "/v1/stats"): self._do_stats,
            ("GET", "/v1/traces"): self._do_traces,
            ("POST", "/v1/search"): self._do_search,
            ("POST", "/v1/docs"): self._do_add,
            ("POST", "/v1/docs/delete"): self._do_delete,
        }

    # -- handlers (run on executor threads; blocking is fine) ----------------
    def _check_tenant(self, body: Dict) -> Optional[str]:
        tenant = body.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            raise _HTTPError(400, "tenant must be a string")
        if tenant is None and self.require_tenant:
            raise _HTTPError(
                400, "this server requires a tenant on every request "
                     "(start it with require_tenant=False for the "
                     "single-tenant/admin mode)")
        return tenant

    def _do_health(self, body: Dict) -> Dict:
        # liveness: the driver thread is up.  Readiness (?ready=1) is
        # stricter: recovery/WAL replay is done and, on a follower,
        # catch-up is within the configured lag bound — the router's
        # probes use readiness so no traffic lands on a replaying replica
        if not self.driver.running:
            raise _HTTPError(503, "engine driver is not running")
        out: Dict[str, Any] = {"status": "ok", "n_docs": self.engine.n_docs}
        if self.replication is not None:
            out["role"] = self.replication.role
            out["applied_seq"] = self.replication.applied_seq
            out["replica_lag"] = self.replication.lag()
            out["ready"] = self.replication.ready()
        else:
            out["ready"] = True
        if str(body.get("ready", "")).lower() in ("1", "true", "yes"):
            if not out["ready"]:
                raise _HTTPError(
                    503, "replica is not ready: "
                         f"{self.replication.status()}")
        if str(body.get("deep", "")).lower() in ("1", "true", "yes"):
            sup = self.driver.supervisor
            with self.engine.lock:
                stats = self.engine.stats
                out["deep"] = {
                    "driver": self.driver.health(),
                    "supervisor": (sup.summary() if sup is not None
                                   else {"attached": False}),
                    "wal": (self.engine.wal.summary()
                            if self.engine.wal is not None else None),
                    "last_recovery": self.engine.last_recovery,
                    "replication": (self.replication.status()
                                    if self.replication is not None
                                    else None),
                    "n_quarantined": self.driver.stats.n_quarantined,
                    "n_recoveries": stats.n_recoveries,
                    "n_rebuild_failures": stats.n_rebuild_failures,
                }
        return out

    def _do_metrics(self, body: Dict) -> _Raw:
        return _Raw(self.engine.metrics.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")

    def _do_traces(self, body: Dict) -> Dict:
        return {
            "traces": self.engine.trace_ring.snapshot(),
            "slow_queries": self.engine.slow_log.recent(),
        }

    def _do_stats(self, body: Dict) -> Dict:
        with self.engine.lock:
            out = {
                "engine": self.engine.stats.summary(),
                "driver": self.driver.stats.summary(),
                "store": dataclasses.asdict(self.engine.store.stats()),
                # snapshot taken under engine.lock — the counters mutate
                # there on the driver thread, so this read is never torn
                "mask_cache": self.engine.store.mask_cache_stats(),
                "tenants": self.engine.store.tenants(),
                "quotas": self.quotas.snapshot(),
                "config": self.engine.config.to_dict(),
            }
        out["adaptive"] = (self.driver.adaptive.summary()
                           if self.driver.adaptive is not None
                           else {"enabled": False})
        out["cache"] = (self.driver.cache.summary()
                        if self.driver.cache is not None
                        else {"enabled": False})
        return out

    def _do_search(self, body: Dict) -> Tuple[Dict, Dict[str, str]]:
        tenant = self._check_tenant(body)
        # Quota-lifecycle discipline: EVERYTHING that can reject the
        # request (tenant check, query parsing, SearchRequest validation)
        # runs BEFORE quotas.acquire, so a rejection never holds a slot;
        # acquire itself only increments after its cap check passes (no
        # partial state on QuotaExceeded).  From acquire onward every
        # path — check_request raising in submit, DriverQueueFull,
        # DriverStopped racing the submit, result timeout, dispatch
        # errors — unwinds through the try/finally below, so release()
        # always runs exactly once and an in-flight slot can never leak
        # (the regression test hammers these paths and asserts
        # quotas.inflight returns to zero).
        query = np.asarray(_body_field(body, "query"), np.float32)
        request = SearchRequest(
            query=query,
            k=body.get("k"),
            tenant=tenant,
            filter=body.get("filter"),
            deadline_ms=body.get("deadline_ms"),
        )
        min_seq = body.get("min_seq")
        if min_seq is not None:
            # read-your-writes: block (bounded) until this replica has
            # applied the client's consistency token; runs BEFORE acquire
            # so the wait never holds a quota slot
            self._await_min_seq(int(min_seq), request.deadline_ms)
        self.quotas.acquire(tenant)
        try:
            future = self.driver.submit(request,
                                        timeout=self.submit_timeout)
            result = future.result(self.result_timeout)
        finally:
            self.quotas.release(tenant)
        live = result.doc_ids >= 0             # drop padded empty slots
        st = result.stats
        headers: Dict[str, str] = {}
        if self.driver.adaptive is not None:
            headers["degraded"] = str(result.degraded_level)
        if self.driver.cache is not None:
            headers["cache"] = "hit" if result.cached else "miss"
        return {
            "ids": result.doc_ids[live].tolist(),
            "scores": result.scores[live].astype(float).tolist(),
            "request_id": result.request_id,
            "store_generation": result.store_generation,
            "latency_ms": st.latency_ms,
            "cached": result.cached,
            "degraded_level": result.degraded_level,
            # latency decomposition: queue_ms + compute_ms ~= latency_ms;
            # stage0/rescore split the compute only under obs.stage_fences
            # (null otherwise — the keys are always present)
            "spans": {
                "queue_ms": st.queue_ms,
                "compute_ms": st.compute_ms,
                "stage0_ms": st.stage0_ms,
                "rescore_ms": st.rescore_ms,
            },
        }, headers

    def _await_min_seq(self, min_seq: int,
                       deadline_ms: Optional[float]) -> None:
        """Wait until this replica's applied seq covers the client's
        consistency token; retryable 503 if it cannot within the bound
        (the router then fails over to a caught-up replica)."""
        if self.replication is None:
            raise _HTTPError(
                503, "this server tracks no replication state; min_seq "
                     "consistency tokens are not supported here")
        wait_s = self.engine.config.replication.min_seq_wait_s
        if deadline_ms is not None:
            wait_s = min(wait_s, float(deadline_ms) / 1e3)
        if not self.replication.wait_for_seq(min_seq, wait_s):
            raise _HTTPError(
                503, f"replica applied seq "
                     f"{self.replication.applied_seq} has not reached "
                     f"min_seq {min_seq} within {wait_s:.3f}s")

    def _check_writable(self) -> None:
        if self.read_only:
            raise _HTTPError(
                403, "this replica is a read-only follower — send "
                     "mutations to the primary (or through the router)")

    def _do_add(self, body: Dict) -> Dict:
        self._check_writable()
        tenant = self._check_tenant(body)
        vectors = np.asarray(_body_field(body, "vectors"), np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if vectors.ndim != 2:
            raise _HTTPError(
                400, f"vectors must be a (n, d) array, got shape "
                     f"{vectors.shape}")
        metadata = body.get("metadata")
        with self.engine.lock:                 # quota check + add atomically
            self.quotas.check_docs(
                tenant,
                self.engine.store.tenant_doc_count(tenant)
                if tenant is not None else 0,
                len(vectors))
            ids = self.engine.add_docs(vectors, tenant=tenant,
                                       metadata=metadata)
            # seq is the mutation's WAL position — the client's
            # read-your-writes token (pass back as min_seq on searches)
            seq = (self.engine.wal.last_seq
                   if self.engine.wal is not None else None)
        return {"ids": ids.tolist(), "n_added": len(ids), "seq": seq}

    def _do_delete(self, body: Dict) -> Dict:
        self._check_writable()
        tenant = self._check_tenant(body)
        ids = np.asarray(_body_field(body, "ids"), np.int64).reshape(-1)
        with self.engine.lock:                 # ownership check + delete
            store = self.engine.store
            if tenant is not None:
                for doc_id in ids.tolist():
                    if not 0 <= doc_id < store.size:
                        raise _HTTPError(
                            400, f"doc id {doc_id} out of range")
                    owner = store.tenant_of(doc_id)
                    if store.is_live(doc_id) and owner != tenant:
                        raise _HTTPError(
                            403, f"doc {doc_id} does not belong to "
                                 f"tenant {tenant!r}")
            n_deleted = self.engine.delete_docs(ids)
            seq = (self.engine.wal.last_seq
                   if self.engine.wal is not None else None)
        return {"n_deleted": n_deleted, "seq": seq}


@dataclasses.dataclass
class ServerHandle:
    """A server running on its own event-loop thread (see
    ``serve_in_thread``); ``stop()`` is idempotent and joins the thread."""

    server: AsyncHTTPBase
    _loop: asyncio.AbstractEventLoop
    _thread: threading.Thread

    @property
    def url(self) -> str:
        return self.server.url

    @property
    def port(self) -> int:
        return self.server.port

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout)
            if self._thread.is_alive():        # pragma: no cover
                raise TimeoutError("server thread did not stop")

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False


def serve_in_thread(engine: RetrievalEngine, driver: EngineDriver,
                    **kwargs) -> ServerHandle:
    """Boot a ``RetrievalHTTPServer`` on a dedicated event-loop thread.

    Returns once the socket is bound (``handle.url`` is ready to hit).
    The caller keeps ownership of the driver's lifecycle — stopping the
    handle closes the listener but leaves engine and driver running.
    """
    return run_server_in_thread(RetrievalHTTPServer(engine, driver, **kwargs))


def run_server_in_thread(server: AsyncHTTPBase,
                         thread_name: str = "retrieval-http") -> ServerHandle:
    """Boot any ``AsyncHTTPBase`` server on its own event-loop thread."""
    started = threading.Event()
    boot_error: list = []
    loop = asyncio.new_event_loop()

    def run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(server.start())
        except Exception as e:                 # pragma: no cover
            boot_error.append(e)
            started.set()
            loop.close()
            return
        started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(server.stop())
            loop.close()

    thread = threading.Thread(target=run, name=thread_name,
                              daemon=True)
    thread.start()
    started.wait()
    if boot_error:                             # pragma: no cover
        raise boot_error[0]
    return ServerHandle(server, loop, thread)
