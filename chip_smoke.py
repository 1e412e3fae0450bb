#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
flat progressive-search serving path at the paper's deployment size
(1,000,000 documents x 3584 dims, 2,470 queries, schedule d_start=128,
d_max=3584, k0=64, final_k=10), in phases that each print one JSON line:

  1. device    — ``nvidia-smi`` name and power limit, kernel build time
  2. kernels   — each kernel against its plain PyTorch version on the card,
                 at the serving shapes, with CUDA-event timings
  3. corpus    — synthetic corpus generated on the card from ``--seed``,
                 loaded into a ``RetrievalEngine`` and warmed up
  4. serving   — ``engine.search`` over every query and requests from client
                 threads through ``EngineDriver``; recall@10 / top-1 against
                 an exact full-dim search, agreement with the plain path,
                 and the kernels' launch counts during the phase; then one
                 more search traced with ``torch.profiler`` (device time
                 per kernel, the device's busy share)
  5. mutations — deletes (sources of 50 queries among them) and appends,
                 then searches again: no deleted id may come back
  6. kernels line, card line, and the final ``{"ok": true, ...}`` line.

Any failed check raises and the script exits non-zero.  Run it from the
root of a checkout: ``python3 chip_smoke.py [--seed N]``.  It needs a CUDA
device and ``nvcc``; without a GPU it exits with an error and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# The paper's deployment (configs/paper_rag.py): gte-Qwen2-7B widths, 1M
# docs, 2,470 queries, Table III schedule (128 -> 3584, k0=64); final_k=10
# because a RAG prompt takes several documents.
N_DOCS, D_EMB, N_QUERIES = 1_000_000, 3584, 2470
D_START, K0, FINAL_K = 128, 64, 10
CAPACITY = 1 << 20
N_REQUESTS, N_CLIENTS = 256, 4

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth and
# float32 rate outside the tensor cores — the kernels compute in FMA float32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, *, runs: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` after ``warmup``.

    ``flush`` (a tensor larger than L2) is overwritten before each run so
    the timed launch finds the cache cold, as the serving path does."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, *, rtol: float = 2e-5, atol: float = 1e-3):
    """(max |Δscore| over finite slots, share of slots equal up to ties, tol).

    A slot agrees when the ids match or both scores agree within the
    tolerance (a near-tie swapped two rows).  The tolerance scales with the
    largest finite score: the kernels sum float32 products in another order
    than the plain versions."""
    gs, gi = got
    ws, wi = want
    if gs.shape != ws.shape or gi.shape != wi.shape:
        fail(f"shape mismatch {tuple(gs.shape)} vs {tuple(ws.shape)}")
    fin_g, fin_w = torch.isfinite(gs), torch.isfinite(ws)
    if not torch.equal(fin_g, fin_w):
        fail("finite / non-finite slots differ between kernel and plain")
    if not torch.equal(gi[~fin_g], torch.full_like(gi[~fin_g], -1)):
        fail("a non-finite slot carries an id other than -1")
    scale = float(ws[fin_w].abs().max()) if fin_w.any() else 0.0
    tol = atol + rtol * scale
    diff = (gs[fin_g] - ws[fin_w]).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    close = torch.ones_like(gs, dtype=torch.bool)
    close[fin_g] = (gs[fin_g] - ws[fin_g]).abs() <= tol
    agree = (gi == wi) | close
    return max_err, float(agree.float().mean()), tol


def run(args) -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this test "
              "needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import make_schedule, progressive_search_plain
    from repro_torch.core import truncated as T
    from repro_torch.core.index import prefix_squared_norms
    from repro_torch.engine import EngineConfig, EngineDriver, RetrievalEngine
    from repro_torch.kernels import _build, distance_topk, gather_rescore

    dev = torch.device("cuda")
    card = card_line()

    # -- 1. device + build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.library("distance_topk")
    _build.library("gather_rescore")
    build_s = time.perf_counter() - t0
    ptxas = {stem: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln]
             for stem, rep in _build.ptxas_report.items()}
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": build_s, "nvcc_s": _build.build_seconds,
          "ptxas": ptxas})

    d_emb, d_start, k0, final_k = D_EMB, D_START, K0, FINAL_K
    sched = make_schedule(d_start, d_emb, k0, final_k=final_k)
    cap = CAPACITY
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    scales = (1.0 + torch.arange(d_emb, device=dev, dtype=torch.float32)) ** -0.2
    scales = scales / scales.norm() * d_emb ** 0.5
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB

    # -- 2. kernels against their plain versions -----------------------------
    db = torch.randn((cap, d_emb), generator=gen, device=dev).mul_(scales)
    sq_all = prefix_squared_norms(db, tuple(s.dim for s in sched.stages))
    valid = torch.rand((cap,), generator=gen, device=dev) >= 0.01
    n_valid = int(valid.sum())
    stage_rows = []
    s0 = sched.stages[0]
    sq0 = sq_all[:, 0].contiguous()
    out32 = None
    for nq in (1, 32):
        src_rows = torch.randint(0, cap, (nq,), generator=gen, device=dev)
        q = db[src_rows] + torch.randn((nq, d_emb), generator=gen,
                                       device=dev) * scales
        kern = lambda: distance_topk.l2_topk(q, db, dim=s0.dim, k=s0.k,
                                             sq_at_dim=sq0, valid=valid)
        plain = lambda: T.truncated_search(q, db, dim=s0.dim, k=s0.k,
                                           db_sq_at_dim=sq0, valid=valid)

        def yardstick():
            s = sq0 - 2.0 * torch.matmul(q[:, :s0.dim], db[:, :s0.dim].T)
            return torch.topk(s.masked_fill(~valid, float("inf")), s0.k,
                              dim=1, largest=False)

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, agree, tol = compare(torch, got, want)
        if agree < 1.0 or err > tol:
            fail(f"l2_topk Q={nq}: max|Δ|={err} (tol {tol}), agree={agree}")
        b, by = bound_ms(n_valid * (4 * s0.dim + 4) + cap + nq * s0.dim * 4
                         + nq * s0.k * 8, 2.0 * nq * n_valid * s0.dim)
        row = {"kernel": "distance_topk.l2_topk", "Q": nq, "Ncap": cap,
               "dim": s0.dim, "k": s0.k, "max_abs_err": err, "tol": tol,
               "ids_agree": agree,
               "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
               "matmul_topk_ms": cuda_ms(torch, yardstick),
               "bound_ms": b, "bound_by": by}
        stage_rows.append(row)
        emit({"phase": "kernels", **row})
        if nq == 32:
            q32, out32 = q, got

    # small stores: all rows invalid (every slot (+inf, -1)), and Ncap < k
    for n_small, all_invalid in ((1000, True), (50, False)):
        v_small = torch.full((n_small,), not all_invalid, dtype=torch.bool,
                             device=dev)
        got = distance_topk.l2_topk(q32, db[:n_small], dim=s0.dim, k=s0.k,
                                    sq_at_dim=sq0[:n_small], valid=v_small)
        want = T.truncated_search(q32, db[:n_small], dim=s0.dim, k=s0.k,
                                  db_sq_at_dim=sq0[:n_small], valid=v_small)
        err, agree, tol = compare(torch, got, want)
        n_empty = int((got[1] == -1).sum())
        expect_empty = 32 * (s0.k if all_invalid else s0.k - n_small)
        if agree < 1.0 or err > tol or n_empty != expect_empty \
                or not bool(torch.isinf(got[0][got[1] == -1]).all()):
            fail(f"l2_topk small store n={n_small} all_invalid={all_invalid}:"
                 f" agree={agree} err={err} empty={n_empty}/{expect_empty}")
        emit({"phase": "kernels", "kernel": "distance_topk.l2_topk",
              "case": "all_invalid" if all_invalid else "ncap_below_k",
              "Ncap": n_small, "k": s0.k, "empty_slots": n_empty,
              "ids_agree": agree, "max_abs_err": err})

    ladder_rows = []
    cand = out32[1]
    for j, st in enumerate(sched.stages[1:], start=1):
        sq_j = sq_all[:, j].contiguous()
        c_in = cand
        kern = lambda: gather_rescore.gather_rescore_topk(
            q32, db, c_in, dim=st.dim, k=st.k, sq_at_dim=sq_j, valid=valid)
        plain = lambda: T.rescore_candidates(
            q32, db, c_in, dim=st.dim, k=st.k, db_sq_at_dim=sq_j, valid=valid)

        def yardstick():
            safe = c_in.clamp(min=0).long()
            ip = torch.matmul(db[safe, :st.dim], q32[:, :st.dim, None])[..., 0]
            s = (sq_j[safe] - 2.0 * ip).masked_fill(
                (c_in < 0) | ~valid[safe], float("inf"))
            return torch.topk(s, st.k, dim=1, largest=False)

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, agree, tol = compare(torch, got, want)
        if agree < 1.0 or err > tol:
            fail(f"gather_rescore_topk stage {j}: max|Δ|={err} (tol {tol}), "
                 f"agree={agree}")
        n_c = c_in.shape[1]
        n_real = int(((c_in >= 0) & valid[c_in.clamp(min=0).long()]).sum())
        b, by = bound_ms(32 * n_c * 4 + n_real * (4 * st.dim + 5)
                         + 32 * st.dim * 4 + 32 * st.k * 8,
                         2.0 * n_real * st.dim)
        row = {"kernel": "gather_rescore.gather_rescore_topk", "stage": j,
               "Q": 32, "C": n_c, "dim": st.dim, "k": st.k,
               "max_abs_err": err, "tol": tol, "ids_agree": agree,
               "ms": cuda_ms(torch, kern, flush=flush),
               "plain_ms": cuda_ms(torch, plain, flush=flush),
               "matmul_topk_ms": cuda_ms(torch, yardstick, flush=flush),
               "bound_ms": b, "bound_by": by}
        ladder_rows.append(row)
        emit({"phase": "kernels", **row})
        cand = got[1]
    del db, sq_all, valid, sq0
    torch.cuda.empty_cache()

    # -- 3. corpus on the card ----------------------------------------------
    t0 = time.perf_counter()
    engine = RetrievalEngine(
        config=EngineConfig(d_emb=d_emb, d_start=d_start, k0=k0,
                            final_k=final_k, capacity=cap,
                            buckets=(1, 2, 4, 8, 16, 32)),
        device="cuda")
    n_docs = N_DOCS
    chunk = 1 << 16
    for lo in range(0, n_docs, chunk):
        rows = torch.randn((min(chunk, n_docs - lo), d_emb), generator=gen,
                           device=dev) * scales
        engine.add_docs(rows)
    store = engine.store
    if store.size != n_docs or store.capacity != cap:
        fail(f"store holds {store.size} rows at capacity {store.capacity}")
    nq = N_QUERIES
    src_rows = torch.randperm(n_docs, generator=gen, device=dev)[:nq]
    sig = 1.25 * torch.exp(0.55 * torch.randn((nq,), generator=gen, device=dev))
    queries = (store.db[src_rows] + sig[:, None] * scales
               * torch.randn((nq, d_emb), generator=gen, device=dev))
    engine.warmup()
    torch.cuda.synchronize()
    emit({"phase": "corpus", "n_docs": n_docs, "d_emb": d_emb,
          "capacity": cap, "queries": nq, "schedule": sched.describe(),
          "load_s": time.perf_counter() - t0,
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})

    def exact_top(qs, k):
        """Exact full-dim L2 top-k over live rows (chunked torch.matmul;
        ground truth only)."""
        out = []
        norms = (store.db[:n_store] ** 2).sum(dim=1)
        dead = ~store.valid[:n_store]
        for a in range(0, qs.shape[0], 256):
            s = norms - 2.0 * torch.matmul(qs[a:a + 256], store.db[:n_store].T)
            s.masked_fill_(dead, float("inf"))
            out.append(torch.topk(s, k, dim=1, largest=False).indices)
        return torch.cat(out)

    def recall(ids, truth, k=final_k):
        ids = torch.as_tensor(ids, device=dev).long()
        hit = (ids[:, :k, None] == truth[:, None, :k]).any(dim=2)
        return float(hit.float().mean()), float((ids[:, 0] == truth[:, 0]).float().mean())

    # -- 4. serving ------------------------------------------------------------
    q_host = queries.cpu().numpy()
    n_store = store.size
    truth = exact_top(queries, final_k)
    torch.cuda.synchronize()           # the exact search is not search time
    distance_topk.launches = 0
    gather_rescore.launches = 0
    t0 = time.perf_counter()
    s_eng, i_eng = engine.search(q_host)
    search_s = time.perf_counter() - t0
    launches_search = (distance_topk.launches, gather_rescore.launches)

    stats0 = engine.stats.summary()
    driver = EngineDriver(engine, max_wait_ms=2.0).start()
    per_client = N_REQUESTS // N_CLIENTS
    errors = []
    lat = []
    same = []

    def client(c):
        try:
            base = c * per_client
            futs = [driver.submit(q_host[(base + r) % nq])
                    for r in range(per_client)]
            for r, f in enumerate(futs):
                res = f.result(timeout=120)
                lat.append(res.stats.latency_ms)
                same.append(float((res.doc_ids == i_eng[(base + r) % nq])
                                  .mean()))
        except BaseException as e:            # surfaced below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    driver_s = time.perf_counter() - t0
    driver.stop()
    if errors:
        fail(f"driver phase: {errors[:3]}")
    if len(same) != per_client * N_CLIENTS or statistics.mean(same) < 0.99:
        fail(f"driver results agree with engine.search on "
             f"{statistics.mean(same) if same else 0} of ids")
    launches = {"distance_topk.l2_topk": distance_topk.launches,
                "gather_rescore.gather_rescore_topk": gather_rescore.launches}
    if min(launches_search) <= 0 or distance_topk.launches <= launches_search[0] \
            or gather_rescore.launches <= launches_search[1]:
        fail(f"kernel launch counters did not grow on the main path: "
             f"{launches_search} then {launches}")

    # plain progressive_search on the same CUDA tensors
    plain_ids = []
    for a in range(0, nq, 32):
        _, ids = progressive_search_plain(
            queries[a:a + 32], store.db, engine.sched,
            sq_prefix=store.sq_prefix, index_dims=engine.dims,
            valid=store.valid)
        plain_ids.append(ids[:, :final_k])
    plain_ids = torch.cat(plain_ids)
    r_eng, top1_eng = recall(i_eng, truth)
    r_plain, top1_plain = recall(plain_ids, truth)
    src_host = src_rows.cpu().numpy()
    source_top1 = float((i_eng[:, 0] == src_host).mean())
    source_at_10 = float((i_eng == src_host[:, None]).any(axis=1).mean())
    agree_plain = float((torch.as_tensor(i_eng, device=dev) == plain_ids)
                        .float().mean())
    if abs(r_eng - r_plain) > 0.01:
        fail(f"recall@10 {r_eng} of the kernels vs {r_plain} of the plain path")
    if not (np.isfinite(s_eng).all() and s_eng.shape == (nq, final_k)):
        fail("engine scores not finite or of the wrong shape")
    st = engine.stats.summary()
    emit({"phase": "serving", "queries": nq,
          "search_s": search_s, "search_qps": nq / search_s,
          "driver_requests": per_client * N_CLIENTS,
          "driver_clients": N_CLIENTS, "driver_s": driver_s,
          "driver_qps": per_client * N_CLIENTS / driver_s,
          "latency_ms_p50": st["latency_ms_p50"],
          "latency_ms_p95": st["latency_ms_p95"],
          "compute_ms_p50": st["compute_ms_p50"],
          "driver_latency_ms_p50": statistics.median(lat),
          "driver_ids_equal_search": statistics.mean(same),
          "recall_at_10": r_eng, "top1": top1_eng,
          "source_top1": source_top1, "source_in_10": source_at_10,
          "plain_recall_at_10": r_plain, "plain_top1": top1_plain,
          "ids_equal_plain": agree_plain,
          "launches_search": list(launches_search), "launches": launches,
          "batches": st["n_batches"] - stats0["n_batches"]})
    profile_search(torch, engine, q_host, search_s)

    # -- 5. mutations --------------------------------------------------------
    distance_topk.launches = 0
    gather_rescore.launches = 0
    n_del = n_docs // 100
    extra = torch.randperm(n_docs, generator=gen, device=dev)[:n_del - 50]
    del_ids = torch.unique(torch.cat([src_rows[:50], extra])).cpu().numpy()
    n_gone = engine.delete_docs(del_ids)
    _, i_after = engine.search(q_host)
    deleted = set(int(x) for x in del_ids)
    back = sorted(set(int(x) for x in i_after.ravel()) & deleted)
    if back:
        fail(f"deleted ids returned: {back[:10]}")
    n_new = 10_000
    new_rows = torch.randn((n_new, d_emb), generator=gen, device=dev) * scales
    new_ids = engine.add_docs(new_rows)
    if store.capacity != cap:
        fail("appending within capacity grew the store")
    _, i_new = engine.search(new_rows[:1000].cpu().numpy())
    self_hit = float((i_new[:, 0] == new_ids[:1000]).mean())
    _, i_again = engine.search(q_host)
    back = sorted(set(int(x) for x in i_again.ravel()) & deleted)
    if back:
        fail(f"deleted ids returned after the append: {back[:10]}")
    if self_hit < 0.99:
        fail(f"appended rows found themselves top-1 for only {self_hit}")
    n_store = store.size
    truth2 = exact_top(queries, final_k)
    r_after, top1_after = recall(i_again, truth2)
    emit({"phase": "mutations", "deleted": int(n_gone),
          "deleted_sources": 50, "deleted_returned": 0,
          "appended": n_new, "appended_self_top1": self_hit,
          "recall_at_10": r_after, "top1": top1_after,
          "launches": {"distance_topk.l2_topk": distance_topk.launches,
                       "gather_rescore.gather_rescore_topk":
                           gather_rescore.launches}})
    if min(distance_topk.launches, gather_rescore.launches) <= 0:
        fail("mutation phase searched without launching the kernels")
    finish(torch, card, stage_rows, ladder_rows, launches)


def profile_search(torch, engine, q_host, search_s: float) -> None:
    """Trace one ``engine.search`` over every query with ``torch.profiler``:
    device time per kernel, and the device's busy share of the untraced
    search's wall time ``search_s``."""
    from torch.profiler import ProfilerActivity, profile

    engine.search(q_host[:64])                       # settle the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.search(q_host)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    emit({"phase": "profile", "device_busy_ms": busy,
          "search_wall_ms": search_s * 1e3,
          "device_busy_share": busy / (search_s * 1e3),
          "kernels": rows[:12]})


def finish(torch, card, stage_rows, ladder_rows, launches) -> None:
    """Print the kernels line, the card line and the final result line."""
    s32 = [r for r in stage_rows if r["Q"] == 32][0]
    lad = {key: sum(r[key] for r in ladder_rows)
           for key in ("ms", "plain_ms", "matmul_topk_ms", "bound_ms")}
    kernels = [
        {"name": "distance_topk.l2_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk.py:128",
         "launches": launches["distance_topk.l2_topk"],
         "max_abs_err": max(r["max_abs_err"] for r in stage_rows),
         "ms": s32["ms"], "plain_ms": s32["plain_ms"],
         "bound_ms": s32["bound_ms"], "bound_by": s32["bound_by"],
         "library_ms": None, "matmul_topk_ms": s32["matmul_topk_ms"],
         "shape": f"Q=32 Ncap={s32['Ncap']} dim={s32['dim']} k={s32['k']}"},
        {"name": "gather_rescore.gather_rescore_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_rescore.cu",
         "replaces": "src/repro/kernels/gather_rescore.py:98",
         "launches": launches["gather_rescore.gather_rescore_topk"],
         "max_abs_err": max(r["max_abs_err"] for r in ladder_rows),
         "ms": lad["ms"], "plain_ms": lad["plain_ms"],
         "bound_ms": lad["bound_ms"],
         "bound_by": ladder_rows[-1]["bound_by"], "library_ms": None,
         "matmul_topk_ms": lad["matmul_topk_ms"],
         "shape": "sum of the 5 ladder steps of one Q=32 dispatch, (C,dim,k)="
                  + ",".join(f"({r['C']},{r['dim']},{r['k']})"
                             for r in ladder_rows)},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated tensor (corpus, queries)")
    args = ap.parse_args()
    run(args)


if __name__ == "__main__":
    main()
