"""Serving launcher: closed-loop RAG demo, HTTP server mode, or HTTP client.

The port of ``src/repro/launch/serve.py``.  Three modes sharing one engine
flag surface (``EngineConfig.add_flags``):

* default (closed loop) — RAG pipeline over a synthetic corpus, driven by
  the async engine driver under multi-threaded client traffic.
  ``--clients N`` spawns N open-loop client threads that submit single
  requests through the driver (optionally rate-paced with ``--qps``); the
  driver's background thread coalesces them into shape-bucketed batches
  with a deadline flush (``--max-wait-ms`` is the latency/throughput knob).
  Then the LM greedily decodes ``--new-tokens`` tokens for each request,
  ``--batch`` requests at a time, over the retrieved documents.

      PYTHONPATH=src python -m repro_torch.launch.serve --requests 64 \
          --batch 8 --clients 8 --max-wait-ms 2

* ``--serve-http`` — boot the `repro_torch.serve` HTTP front-end over a
  fresh engine (empty corpus; clients add docs over the wire) and serve
  until interrupted.  Tenancy is on by default (``--allow-anonymous`` turns
  the tenant requirement off); ``--max-inflight`` /
  ``--max-docs-per-tenant`` set the admission quotas.  ``--role`` picks
  ``single`` / ``primary`` / ``follower`` (the latter two share
  ``--state-dir``) or ``router`` (over ``--replicas``).

      PYTHONPATH=src python -m repro_torch.launch.serve --serve-http \
          --port 8080 --backend ivf --d-emb 128

* ``--connect URL`` — open-loop HTTP client against a running server:
  seeds ``--docs`` random documents under ``--tenant``, then drives
  ``--requests`` searches from ``--clients`` threads and reports QPS and
  latency percentiles.

      PYTHONPATH=src python -m repro_torch.launch.serve \
          --connect http://127.0.0.1:8080 --requests 256 --clients 8

``--device`` (where the engine, the LM and the kernels run) defaults to
``cuda``; ``--device cpu`` runs the plain path.  The client mode touches
no device.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.engine import EngineConfig, EngineDriver, RetrievalEngine
from repro_torch.models import lm as LM
from repro_torch.rag import RAGPipeline
from repro_torch.rag.pipeline import mean_pool_embedder


def run_clients(driver, qvecs, n_clients: int, qps: float,
                timeout: float = 120.0):
    """Submit every query from ``n_clients`` open-loop threads.

    Each thread owns a shard of the request stream and submits without
    waiting for results (open loop) — at full speed, or paced so the
    threads jointly target ``qps`` — then gathers its futures.  Returns
    (results in submission order, wall seconds).
    """
    results = [None] * len(qvecs)
    errors = []
    shards = np.array_split(np.arange(len(qvecs)), n_clients)
    period = n_clients / qps if qps > 0 else 0.0
    barrier = threading.Barrier(n_clients + 1)

    def client(shard):
        try:
            barrier.wait()
            futures = []
            t_next = time.perf_counter()
            for i in shard:
                if period:
                    now = time.perf_counter()
                    if now < t_next:
                        time.sleep(t_next - now)
                    t_next += period
                futures.append((i, driver.submit(qvecs[i], timeout=timeout)))
            for i, fut in futures:
                results[i] = fut.result(timeout)
        except Exception as e:                    # surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in shards if len(s)]
    for t in threads:
        t.start()
    barrier.wait()                                # release all clients at once
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, wall


def http_json(url: str, path: str, body=None, method: str = "GET",
              timeout: float = 60.0):
    """One JSON round trip; returns (status, payload)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url.rstrip("/") + path, data=data,
        method=method if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_http(args) -> None:
    """Boot the HTTP front-end over a fresh engine and block until ^C.

    ``--role`` picks the replication mode: ``single`` (default) and
    ``primary`` own the WAL under ``--state-dir`` and serve mutations;
    ``follower`` shares the same ``--state-dir``, bootstraps read-only
    from its newest snapshot, and tails the primary's WAL — mutations get
    403, searches wait on ``min_seq`` tokens.
    """
    from repro_torch.engine import PrimaryReplication, ReplicaApplier
    from repro_torch.serve import TenantQuotas, serve_in_thread

    role = args.role if args.role in ("primary", "follower") else "single"
    if role != "single" and not args.state_dir:
        raise SystemExit(f"--role={role} needs --state-dir (the WAL-shipped "
                         "replication channel is the shared state dir)")
    config = EngineConfig.from_flags(args, d_emb=args.d_emb,
                                     capacity=max(args.docs, 1024))
    engine = RetrievalEngine(config=config, device=args.device)
    replication = None
    applier = None
    if role == "follower":
        applier = ReplicaApplier(engine, args.state_dir)
        report = applier.bootstrap()
        applier.start()
        replication = applier
        print(f"[state]  follower of {args.state_dir}: "
              f"(snapshot={report['snapshot_step']} "
              f"fallbacks={report['fallbacks']} "
              f"in {report['duration_ms']:.1f}ms), tailing WAL")
    elif args.state_dir:
        report = engine.recover(args.state_dir)
        replication = PrimaryReplication(engine)
        print(f"[state]  {args.state_dir}: {report['status']} "
              f"(snapshot={report['snapshot_step']} "
              f"replayed={report['replayed']} "
              f"fallbacks={report['fallbacks']} "
              f"in {report['duration_ms']:.1f}ms)")
    driver = EngineDriver(engine, max_wait_ms=args.max_wait_ms,
                          max_queue=args.max_queue)
    driver.start(supervised=args.supervise)
    supervisor = None
    if args.supervise:
        from repro_torch.engine import Supervisor
        supervisor = Supervisor(driver).start()
        print(f"[watch]  supervisor on (heartbeat timeout "
              f"{config.fault.heartbeat_timeout_s:g}s, max "
              f"{config.fault.max_restarts} restarts)")
    quotas = TenantQuotas(
        max_inflight=args.max_inflight if args.max_inflight > 0 else None,
        max_docs=(args.max_docs_per_tenant
                  if args.max_docs_per_tenant > 0 else None))
    handle = serve_in_thread(
        engine, driver, quotas=quotas,
        require_tenant=not args.allow_anonymous,
        host=args.host, port=args.port,
        replication=replication, read_only=(role == "follower"))
    print(f"[engine] {engine.describe()}")
    print(f"[driver] {driver.describe()}")
    print(f"[http]   serving on {handle.url} role={role} "
          f"(tenancy {'optional' if args.allow_anonymous else 'required'})")
    # SIGTERM (kill, container stop) must take the same graceful path as
    # ^C: drain the driver and cut a final snapshot before exiting
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        while True:
            time.sleep(max(args.snapshot_every_s, 0) or 3600)
            if args.state_dir and role != "follower" \
                    and args.snapshot_every_s > 0:
                step = engine.save_snapshot()
                print(f"[state]  snapshot step {step}")
    except KeyboardInterrupt:
        print("\n[http]   shutting down")
    finally:
        handle.stop()
        if supervisor is not None:
            supervisor.stop()
        driver.stop()
        if applier is not None:
            applier.stop()
        elif args.state_dir:
            # followers never snapshot — the primary owns the state dir
            engine.save_snapshot()
            engine.wal.close()


def serve_router(args) -> None:
    """Boot the replica-routing front door over ``--replicas`` and block."""
    from repro_torch.serve import (ReplicaRouter, RetryPolicy,
                                   RouterHTTPServer, run_server_in_thread)

    urls = [u.strip() for u in args.replicas.split(",") if u.strip()]
    if not urls:
        raise SystemExit("--role=router needs --replicas URL[,URL...]")
    router = ReplicaRouter(
        urls,
        probe_interval_s=args.probe_interval_s,
        hedge_ms=args.hedge_ms if args.hedge_ms >= 0 else None,
        retry=RetryPolicy(max_attempts=args.retries),
    ).start()
    handle = run_server_in_thread(RouterHTTPServer(
        router, host=args.host, port=args.port), thread_name="router-http")
    print(f"[router] serving on {handle.url} over {len(urls)} replicas "
          f"(probe every {args.probe_interval_s:g}s, hedge_ms="
          f"{args.hedge_ms if args.hedge_ms >= 0 else 'off'})")

    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("\n[router] shutting down")
    finally:
        handle.stop()
        router.stop()


def connect_client(args) -> None:
    """Open-loop HTTP client: seed docs, then drive concurrent searches.

    Shares the router's failure discipline: every call carries a
    ``deadline_ms`` and retries 503/504/connection errors with jittered
    backoff (`repro_torch.serve.RetryPolicy`) — 4xx responses are never
    retried, and seeding mutations only retry explicit 503/504 (a dropped
    connection mid-mutation may already have applied).
    """
    from repro_torch.serve import RetryPolicy, http_call

    url = args.connect
    retry = RetryPolicy(max_attempts=max(1, args.retries))
    deadline_ms = args.deadline_ms if args.deadline_ms > 0 else None
    timeout = (deadline_ms / 1e3 + 5.0) if deadline_ms else 60.0

    def call(path, body=None, *, mutation=False):
        def attempt(_n):
            status, payload = http_call(url, path, body, timeout=timeout)
            if mutation and status == 0:
                # ambiguous: the server may have applied it — never re-send;
                # -1 is not retryable, so run() returns it straight through
                return -1, payload
            return status, payload
        status, payload = retry.run(attempt, sleep=time.sleep)
        return (0, payload) if status == -1 else (status, payload)

    status, health = call("/healthz")
    if status != 200:
        raise SystemExit(f"server unhealthy: {status} {health}")
    rng = np.random.default_rng(0)
    d = args.d_emb
    min_seq = None
    if args.docs:
        docs = rng.standard_normal((args.docs, d)).astype(np.float32)
        status, added = call("/v1/docs", {
            "vectors": docs.tolist(), "tenant": args.tenant}, mutation=True)
        if status != 200:
            raise SystemExit(f"seed add failed: {status} {added}")
        min_seq = added.get("seq")
        print(f"[seed]   {added['n_added']} docs under {args.tenant!r}"
              + (f" (seq={min_seq})" if min_seq is not None else ""))
    queries = rng.standard_normal((args.requests, d)).astype(np.float32)
    lat = [None] * args.requests
    codes = [0] * args.requests
    shards = np.array_split(np.arange(args.requests),
                            max(1, min(args.clients, args.requests)))
    barrier = threading.Barrier(len([s for s in shards if len(s)]) + 1)

    def client(shard):
        barrier.wait()
        for i in shard:
            body = {"query": queries[i].tolist(), "tenant": args.tenant,
                    "k": args.final_k}
            if deadline_ms:
                body["deadline_ms"] = deadline_ms
            if min_seq is not None:
                body["min_seq"] = min_seq
            t0 = time.perf_counter()
            codes[i], _ = call("/v1/search", body)
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in shards if len(s)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat_ms = np.asarray([x for x in lat if x is not None]) * 1e3
    n_ok = sum(1 for c in codes if c == 200)
    print(f"[client] {args.requests} requests, {len(threads)} threads: "
          f"qps={args.requests / wall:.1f} "
          f"p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p95={np.percentile(lat_ms, 95):.1f}ms "
          f"ok={n_ok}/{args.requests}")
    if n_ok != args.requests:
        raise SystemExit(1)


def closed_loop(args) -> None:
    """The demo: RAG pipeline + driver under threaded clients."""
    device = torch.device(args.device)
    cfg = LMConfig(name="serve-lm", n_layers=4, d_model=128, n_heads=8,
                   n_kv_heads=4, d_head=16, d_ff=256, vocab=2048,
                   param_dtype="float32", compute_dtype="float32",
                   remat=False)
    rng = np.random.default_rng(0)
    lm = LM.init_lm(cfg, seed=0, device=device)
    doc_tokens = rng.integers(1, cfg.vocab, (args.docs, 24)).astype(np.int32)
    embed = mean_pool_embedder(lm)
    db = embed(doc_tokens)
    econf = EngineConfig.from_flags(args, d_emb=int(db.shape[1]))
    pipe = RAGPipeline(lm, db, doc_tokens,
                       d_start=econf.d_start, k0=econf.k0,
                       buckets=econf.buckets,
                       backend=econf.backend.name,
                       backend_opts=econf.backend.opts() or None,
                       device=device)
    engine = pipe.engine
    print(f"[engine]   {engine.describe()}")

    gt = rng.choice(args.docs, args.requests)
    queries = doc_tokens[gt]
    qvecs = embed(queries).cpu().numpy()

    # Warm the bucket ladder so steady-state percentiles exclude first calls.
    engine.warmup()

    # --- retrieval: N client threads -> async driver -> coalesced batches --
    n_clients = max(1, min(args.clients, args.requests))
    driver = pipe.start_driver(max_wait_ms=args.max_wait_ms,
                               max_queue=args.max_queue)
    print(f"[driver]   {driver.describe()}")
    try:
        results, wall = run_clients(driver, qvecs, n_clients, args.qps)
    finally:
        pipe.stop_driver()
    retrieved = np.stack([r.doc_ids for r in results])
    hits = int((retrieved[:, 0] == gt).sum())
    s = engine.stats.summary()
    ds = driver.stats.summary()
    print(f"[retrieve] {args.requests} requests, {n_clients} clients, "
          f"max_wait={args.max_wait_ms:g}ms, buckets={econf.buckets}: "
          f"qps={args.requests / wall:.1f} "
          f"p50={s['latency_ms_p50']:.1f}ms p95={s['latency_ms_p95']:.1f}ms "
          f"batches={s['n_batches']} padded={s['n_padded_slots']} "
          f"flush(full/deadline/drain)={ds['n_flush_full']}/"
          f"{ds['n_flush_deadline']}/{ds['n_flush_drain']} "
          f"hit-rate={hits / args.requests * 100:.1f}%")

    # --- decode: fixed-size LM batches over the retrieved docs -------------
    lat = []
    for i in range(0, args.requests, args.batch):
        t0 = time.perf_counter()
        pipe.generate(queries[i:i + args.batch], retrieved[i:i + args.batch],
                      max_new_tokens=args.new_tokens)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    print(f"[decode]   batch={args.batch}: "
          f"p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p95={np.percentile(lat_ms, 95):.1f}ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8,
                    help="LM decode batch (retrieval batches via --buckets)")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent open-loop client threads")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="driver deadline: max wait for batch companions")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="aggregate open-loop submit rate (0 = full speed)")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="driver pending-queue bound (backpressure)")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the engine, the LM and the kernels run")
    # HTTP server mode
    ap.add_argument("--serve-http", action="store_true",
                    help="serve the repro_torch.serve HTTP API instead of "
                         "the closed-loop demo")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--d-emb", type=int, default=128,
                    help="embedding dim for --serve-http / --connect")
    ap.add_argument("--allow-anonymous", action="store_true",
                    help="accept tenantless requests (admin mode)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="per-tenant concurrent-search cap (0 = unlimited)")
    ap.add_argument("--max-docs-per-tenant", type=int, default=0,
                    help="per-tenant live-document cap (0 = unlimited)")
    ap.add_argument("--state-dir", type=str, default="",
                    help="durable state directory: recover from the latest "
                         "valid snapshot + WAL tail on boot, log every "
                         "mutation, snapshot on shutdown")
    ap.add_argument("--snapshot-every-s", type=float, default=0.0,
                    help="with --state-dir: also snapshot every N seconds "
                         "(0 = only on shutdown)")
    ap.add_argument("--supervise", action="store_true",
                    help="watchdog the driver thread: restart it with "
                         "capped backoff if it dies or hangs")
    # replication / routing
    ap.add_argument("--replicas", type=str, default="",
                    help="--role=router: comma-separated replica base URLs "
                         "to spread searches across")
    ap.add_argument("--hedge-ms", type=float, default=-1.0,
                    help="--role=router: fire a hedged search after this "
                         "many ms (0 = adaptive p95, <0 = off)")
    ap.add_argument("--probe-interval-s", type=float, default=0.25,
                    help="--role=router: per-replica health-probe period")
    # HTTP client mode
    ap.add_argument("--connect", type=str, default="",
                    help="drive a running HTTP server at this URL instead "
                         "of serving locally")
    ap.add_argument("--tenant", type=str, default="bench",
                    help="--connect: tenant to seed and search under")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="--connect: propagate this per-request deadline "
                         "(0 = none)")
    ap.add_argument("--retries", type=int, default=3,
                    help="--connect/--role=router: max attempts per call "
                         "(retries only 503/504/connection errors)")
    EngineConfig.add_flags(ap)
    args = ap.parse_args()
    if args.serve_http and args.connect:
        raise SystemExit("--serve-http and --connect are mutually exclusive")
    if args.serve_http and args.role == "router":
        serve_router(args)
    elif args.serve_http:
        serve_http(args)
    elif args.connect:
        connect_client(args)
    else:
        closed_loop(args)


if __name__ == "__main__":
    main()
