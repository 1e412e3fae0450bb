"""HTTP serving front-end: multi-tenant, metadata-filtered search over the
engine driver.

  RetrievalHTTPServer — stdlib asyncio HTTP/1.1 server (health, search,
                        add/delete docs, stats) mapping the engine's error
                        taxonomy onto status codes (429 backpressure,
                        504 deadline, 400 bad filter, 403 cross-tenant);
                        liveness vs readiness split (``/healthz?ready=1``),
                        replication deep-health, read-only follower mode,
                        and ``min_seq`` read-your-writes waits
  ReplicaRouter,
  RouterHTTPServer    — replicated serving front door: health-probed
                        failover, per-replica circuit breakers, bounded
                        retries, request hedging, consistency-token
                        routing (see `repro_torch.serve.router`)
  RetryPolicy,
  CircuitBreaker      — the shared failure-handling primitives (also used
                        by the ``--connect`` CLI client)
  serve_in_thread,
  run_server_in_thread,
  ServerHandle        — boot a server on its own event-loop thread;
                        used by tests, the launcher and ``chip_smoke.py``
  TenantQuotas,
  QuotaExceeded       — per-tenant admission control (in-flight + doc
                        caps) in front of the driver's bounded queue

Tenancy and filtering live in the engine (`repro_torch.engine.SearchRequest`,
``DocStore`` tenant/metadata columns); this package only speaks HTTP.

The wire protocol (paths, fields, status codes, headers, metric families)
is the JAX package's ``repro.serve`` exactly, so a client, router or
health probe of either package works with a server of the other.  The
package is host code: it reads numpy results and host mirrors, never a
tensor, and the searches it submits run the engine's kernels on the card.
"""

from repro_torch.serve.http import (
    AsyncHTTPBase,
    RetrievalHTTPServer,
    ServerHandle,
    run_server_in_thread,
    serve_in_thread,
)
from repro_torch.serve.quota import QuotaExceeded, TenantQuotas
from repro_torch.serve.router import (
    CircuitBreaker,
    ReplicaRouter,
    RetryPolicy,
    RouterHTTPServer,
    http_call,
)

__all__ = [
    "AsyncHTTPBase", "CircuitBreaker", "QuotaExceeded", "ReplicaRouter",
    "RetrievalHTTPServer", "RetryPolicy", "RouterHTTPServer",
    "ServerHandle", "TenantQuotas", "http_call", "run_server_in_thread",
    "serve_in_thread",
]
