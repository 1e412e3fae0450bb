"""Serving launcher, closed-loop mode: the RAG pipeline over a synthetic
corpus, driven by the async engine driver under multi-threaded clients.

The port of ``src/repro/launch/serve.py``'s default mode.  ``--clients N``
spawns N open-loop client threads that submit single requests through the
driver (optionally rate-paced with ``--qps``); the driver's background
thread coalesces them into shape-bucketed batches with a deadline flush
(``--max-wait-ms``).  Then the LM greedily decodes ``--new-tokens`` tokens
for each request, ``--batch`` requests at a time, over the retrieved
documents.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 250 \\
        --requests 24 --batch 8 --new-tokens 4 --device cpu

``--device`` defaults to ``cuda``.  The HTTP server, client and router
modes are not ported yet (the serving-surface slice).
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.engine import EngineConfig
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
                    help="where the LM, the corpus and the kernels run")
    EngineConfig.add_flags(ap)
    closed_loop(ap.parse_args())


if __name__ == "__main__":
    main()
