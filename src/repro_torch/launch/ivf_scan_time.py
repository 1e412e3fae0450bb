"""Time the IVF stage-0 scans at the serving dispatch shape, for one or more
source trees.

For each tree given (a directory holding ``repro_torch``), in the order
given, a fresh process makes the paper's corpus on the card (1,000,000 x
3,584 rows from ``--seed``, scaled as ``chip_smoke.py`` scales them),
serves it behind the ``ivf`` backend with float32, int8 and PQ slabs (one
engine at a time: 4,096 lists, n_probe 12), deletes 10,000 ids, and times
the stage-0 scan of the engine's own state at the serving dispatch shape
(32 noisy copies of documents, k0 64, the PQ pool 4 x 64) as that tree's
dispatch calls it: the raw member table with the store's validity bits
where the wrapper takes them, else the masking pass and then the wrapper
on the masked table.  Per row:

* ``ms``: CUDA-event time of the dispatch's call (median of 20, the L2
  flushed before each); ``premasked_ms``: the wrapper alone on the masked
  table;
* ``device_ms`` and ``kernels_per_call``: every kernel the dispatch's call
  runs, from ``torch.profiler`` over 10 calls, by name;
* ``host_us``: host time per dispatch call, 200 calls without a
  synchronise (the device runs behind).

To compare two trees on one card, list them in turns::

    python3 -m repro_torch.launch.ivf_scan_time OLD/src src src OLD/src

Needs a CUDA device; prints one JSON line per (tree, slab type).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r'''
import gc, inspect, json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
seed = int(sys.argv[2])
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.ivf import _probe
from repro_torch.core.pq import pq_lut
from repro_torch.engine import EngineConfig, RetrievalEngine
from repro_torch.engine.config import IVFConfig
from repro_torch.kernels import ivf_scan, pq_scan

torch.backends.cuda.matmul.allow_tf32 = False
N_DOCS, D_EMB, D_START, K0, FINAL_K = 1_000_000, 3584, 128, 64, 10
N_DELETE, NQ = 10_000, 32
dev = torch.device("cuda")
scales = (1.0 + torch.arange(D_EMB, device=dev, dtype=torch.float32)) ** -0.2
scales = scales / scales.norm() * D_EMB ** 0.5
flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)


def cuda_ms(fn, runs=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def profiled(fn, runs=10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total, kernels = 0.0, {}
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        total += us
        kernels[ev.key[:60]] = {"per_call": ev.count / runs,
                                "device_ms": us / runs / 1e3}
    return total / runs / 1e3, kernels


def host_us(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


takes_valid = "valid" in inspect.signature(ivf_scan.ivf_scan_topk).parameters
gen = torch.Generator(device=dev)
gen.manual_seed(seed)
del_ids = torch.randperm(N_DOCS, generator=gen, device=dev)[:N_DELETE]
src = torch.randperm(N_DOCS, generator=gen, device=dev)[:NQ]
noise = torch.randn((NQ, D_EMB), generator=gen, device=dev)
for dtype in ("float32", "int8", "pq"):
    engine = RetrievalEngine(
        config=EngineConfig(d_emb=D_EMB, d_start=D_START, k0=K0,
                            final_k=FINAL_K, capacity=1 << 20,
                            buckets=(1, 2, 4, 8, 16, 32),
                            backend=IVFConfig(stage0_dtype=dtype)),
        device="cuda")
    cgen = torch.Generator(device=dev)
    cgen.manual_seed(seed + 1)
    for lo in range(0, N_DOCS, 1 << 16):
        engine.add_docs(torch.randn((min(1 << 16, N_DOCS - lo), D_EMB),
                                    generator=cgen, device=dev) * scales)
    engine.maybe_rebuild(force=True)
    engine.delete_docs(del_ids.cpu().numpy())
    torch.cuda.synchronize()
    st, be = engine.index_state, engine.backend
    valid = engine.store.valid
    lists, pack = st.data["lists"], st.data["pack"]
    q = (engine.store.db[src] + 1.25 * scales * noise).contiguous()
    probe = _probe(q, st.data["centroids"], be.n_probe, "l2",
                   st.data["cent_sq"])
    masked = ivf_scan.mask_members(lists, valid) if hasattr(
        ivf_scan, "mask_members") else torch.where(
            (lists >= 0) & valid[lists.clamp(min=0).long()], lists,
            torch.full_like(lists, -1))
    if dtype == "pq":
        k = K0 * be.pq_oversample
        lut = pq_lut(q[:, :pack["dim"]], pack["codebooks"], pack["cent_sq"])
        scan = lambda m, **kw: pq_scan.pq_ivf_scan_topk(q, probe, m, pack,
                                                        k=k, lut=lut, **kw)
    else:
        k = K0
        scan = lambda m, **kw: ivf_scan.ivf_scan_topk(q, probe, m, pack, k=k,
                                                      **kw)
    if takes_valid:
        dispatch = lambda: scan(lists, valid=valid)
    else:
        dispatch = lambda: scan(torch.where(
            (lists >= 0) & valid[lists.clamp(min=0).long()], lists,
            torch.full_like(lists, -1)))
    premasked = lambda: scan(masked)
    a, b = dispatch(), premasked()
    torch.cuda.synchronize()
    same = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
    dev_ms, kernels = profiled(dispatch)
    pl = probe.long()
    distinct = torch.unique(pl).numel()
    row = {"slabs": dtype, "Q": NQ, "n_probe": be.n_probe,
           "n_lists": lists.shape[0], "max_len": pack["max_len"],
           "dim": pack["dim"], "k": k, "takes_valid": takes_valid,
           "ms": cuda_ms(dispatch), "premasked_ms": cuda_ms(premasked),
           "device_ms": dev_ms,
           "kernels_per_call": sum(v["per_call"] for v in kernels.values()),
           "kernels": kernels, "host_us": host_us(dispatch),
           "valid_route_equals_premasked": same,
           "cluster": (ivf_scan.last_cluster(pq_scan._kernel()[0]
                                             if dtype == "pq" else None)
                       if hasattr(ivf_scan, "last_cluster") else None),
           "distinct_list_share": distinct / pl.numel(),
           "live_slot_share": float((masked[pl] >= 0).float().mean()),
           "card": torch.cuda.get_device_name(0)}
    print(json.dumps(row), flush=True)
    del engine, st, lists, pack, valid, masked, a, b, dispatch, premasked
    gc.collect()
    torch.cuda.empty_cache()
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__))))],
                    help="directories holding repro_torch (default: this one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the corpus, the queries and the deletes")
    args = ap.parse_args()
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, str(args.seed)],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            if line.startswith("{"):
                print(json.dumps({"tree": tree, **json.loads(line)}),
                      flush=True)


if __name__ == "__main__":
    main()
