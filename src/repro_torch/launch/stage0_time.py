"""Time the stage-0 kernel (``distance_topk.l2_topk``) at the serving, the
two-tower and the large-k shapes, for one or more source trees.

For each tree given (a directory holding ``repro_torch``), in the order
given, a fresh process makes 1,048,576 rows of 3,584 dims on the card
(scaled as ``chip_smoke.py`` scales them, 1% of them tombstoned, from
``--seed``) and 2,470 noisy copies of rows as queries, then times the
wrapper on the cases below, the queries' first Q rows, the rows' prefix
norms precomputed.  A case whose k the tree's wrapper refuses is skipped.
Per case:

* ``ms``: CUDA-event time of one call (median of 30 after 3 warm-ups);
* ``device_ms``: the kernels' device time a call from ``torch.profiler``
  over 10 calls (None when the trace lost records);
* ``plan``: the wrapper's plan (pass-1 kernel, query tile, ring stages,
  warpgroups, splits, tiles a split, pass-2 groups).

To compare two trees on one card, list them in turns::

    python3 -m repro_torch.launch.stage0_time OLD/src src src OLD/src

Needs a CUDA device; prints one JSON line per (tree, case).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (case, Q, dim, k)
CASES = (
    ("serving_q32_dim128_k64", 32, 128, 64),
    ("two_tower_q512_dim64_k128", 512, 64, 128),
    ("fma_q32_dim512_k256", 32, 512, 256),
    ("q32_dim128_k1024", 32, 128, 1024),
    ("q32_dim512_k1024", 32, 512, 1024),
    ("sweep_q2470_dim128_k1024", 2470, 128, 1024),
)

_CHILD = r'''
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
seed, cases = int(sys.argv[2]), json.loads(sys.argv[3])
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.index import prefix_squared_norms
from repro_torch.kernels import distance_topk

N, D, NQ = 1 << 20, 3584, 2470
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(seed)
scales = (1.0 + torch.arange(D, device=dev, dtype=torch.float32)) ** -0.2
scales = scales / scales.norm() * D ** 0.5
db = torch.randn((N, D), generator=gen, device=dev).mul_(scales)
valid = torch.rand((N,), generator=gen, device=dev) >= 0.01
src = torch.randint(0, N, (NQ,), generator=gen, device=dev)
queries = db[src] + torch.randn((NQ, D), generator=gen, device=dev) * scales
dims = sorted({c[2] for c in cases})
sq = prefix_squared_norms(db, dims)


def cuda_ms(fn, runs=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, per_call, runs=10):
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if "l2_scan" in ev.key or "l2_merge" in ev.key:
            us += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
            n += ev.count
    return us / runs / 1e3 if n == runs * per_call else None


for case, nq, dim, k in cases:
    if k > distance_topk.MAX_K:
        continue
    q = queries[:nq].contiguous()
    s = sq[:, dims.index(dim)].contiguous()
    fn = lambda: distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=s,
                                       valid=valid)
    plan = distance_topk.plan(q, db, dim, k)
    print(json.dumps({
        "case": case, "Q": nq, "dim": dim, "k": k, "plan": list(plan),
        "ms": cuda_ms(fn),
        "device_ms": device_ms(fn, 2 if plan[-1] == 1 else 3),
        "card": torch.cuda.get_device_name(0)}), flush=True)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__))))],
                    help="directories holding repro_torch (default: this one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the rows, the tombstones and the queries")
    args = ap.parse_args()
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, str(args.seed),
             json.dumps(CASES)],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            if line.startswith("{"):
                print(json.dumps({"tree": tree, **json.loads(line)}),
                      flush=True)


if __name__ == "__main__":
    main()
