"""Time the stage-0 kernel (``distance_topk.l2_topk``) at the serving, the
two-tower, the large-k and the paper's wide-dim shapes, for one or more
source trees.

For each tree given (a directory holding ``repro_torch``), in the order
given, a fresh process makes 1,048,576 rows of 3,584 dims on the card
(scaled as ``chip_smoke.py`` scales them, 1% of them tombstoned, from
``--seed``) and 2,470 noisy copies of rows as queries, then times the
wrapper on the cases below, the queries' first Q rows, the rows' prefix
norms precomputed.  A case whose k the tree's wrapper refuses is skipped.
Per case:

* ``ms``: CUDA-event time of one call (median of 30 after 3 warm-ups; of
  5 after 1 where a call takes more than 50 ms);
* ``device_ms``: the kernels' device time a call from ``torch.profiler``
  over 10 calls (3 where a call takes more than 50 ms; None when the trace
  lost records);
* ``plan``: the wrapper's plan (pass-1 kernel, query tile, ring stages,
  warpgroups, splits, tiles a split, pass-2 groups).

To compare two trees on one card, list them in turns::

    python3 -m repro_torch.launch.stage0_time OLD/src src src OLD/src

``--cases a,b``
keeps the cases named.  ``--plain`` also times, per case,
the plain version (``plain_ms``) and ``torch.matmul`` + ``torch.topk`` in
blocks of 512 queries on the same norms and tombstones (``matmul_topk_ms``,
the yardstick), median of 3 after 1.  ``--wide-patches a,b`` also builds
copies of the tree's ``csrc/distance_topk_wide.cu`` with one section of the
``wide`` kernel switched off each (`WIDE_PATCHES`) into
``build/stage0_patches/`` and times every ``wide`` case through each (``ms``
only, ``"variant"`` the patch's name): beside the unpatched build, what the
section costs.  ``--bigk-patches a,b`` does the same for the large-k
``wgmma`` kernel (`BIGK_PATCHES`, copies of the float32 library's
``csrc/distance_topk.cuh``) on every float32 ``wgmma`` case above k = 256.
A tree without the source skips them.

Needs a CUDA device; prints one JSON line per (tree, case[, variant]).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# Sections of the ``wide`` kernel switched off in a patched copy of its
# source: {name: [(text, replacement)]}.  ``no_products``: a box's twelve
# TF32 products skipped (the scores are the norms alone); ``no_loads``: the
# producer loads nothing (the products and the selection on whatever the
# ring holds); ``rows_only`` / ``queries_only``: only the rows' / only the
# queries' boxes loaded; ``fold_every_box`` / ``fold_at_tile_end``: the
# tensor cores' sums folded into float32 registers every box / once a tile
# (where they drift), not every four boxes.
_WIDE_LOAD = """            mbar_expect_tx(full(st), kStageBytes);
            tma_load_2d(dst, &tm_db, full(st), b * kBox, tile * kRows);
            bulk_load(dst + kRowBytes, qbox + (size_t)b * 2 * NQ * kBox,
                      2 * kQBytes, full(st));"""
_WIDE_ROWS = _WIDE_LOAD[_WIDE_LOAD.index("            tma_load_2d"):
                        _WIDE_LOAD.index("            bulk_load")]
_WIDE_QUERIES = _WIDE_LOAD[_WIDE_LOAD.index("            bulk_load"):]
WIDE_PATCHES = {
    "no_products": [("          for (int j = 0; j < 4; ++j) {\n"
                     "            const uint32_t off = s_stage",
                     "          for (int j = 0; j < 0; ++j) {\n"
                     "            const uint32_t off = s_stage")],
    "no_loads": [(_WIDE_LOAD, "            mbar_expect_tx(full(st), 0);")],
    "rows_only": [(_WIDE_LOAD, "            mbar_expect_tx(full(st), "
                   "kRowBytes);\n" + _WIDE_ROWS.rstrip("\n"))],
    "queries_only": [(_WIDE_LOAD, "            mbar_expect_tx(full(st), "
                      "2 * kQBytes);\n" + _WIDE_QUERIES)],
    "fold_every_box": [("constexpr int kFold = 4;", "constexpr int kFold = 1;")],
    "fold_at_tile_end": [("constexpr int kFold = 4;",
                          "constexpr int kFold = 1 << 20;")],
}

# Sections of the large-k ``wgmma`` kernel (``l2_scan_bigk_kernel`` in
# ``csrc/distance_topk.cuh``) switched off in a patched copy of the float32
# library: ``no_products``: a box's twelve TF32 products skipped (the
# scores are the norms alone); ``no_loads``: the producer loads nothing;
# ``no_appends``: no survivor is stored, so no list is ever tightened and
# each item emits empty lists.  The first and the last patch the pieces
# that ``l2_scan_wgmma_kernel`` shares (``box_products``, ``offer_tile``),
# so only the cases above k = 256 are timed through them.
_BIGK_LOAD = """            mbar_expect_tx(full(st), kStage);
            tma_load_2d(base + st * kStage, &tm_db, full(st), b * kDims,
                        tile * kRows);"""
BIGK_PATCHES = {
    "no_products": [("    for (int j = 0; j < 4; ++j) {\n"
                     "      const uint32_t off = b * NT * 128 + 32 * j;",
                     "    for (int j = 0; j < 0; ++j) {\n"
                     "      const uint32_t off = b * NT * 128 + 32 * j;")],
    "no_loads": [(_BIGK_LOAD, "            mbar_expect_tx(full(st), 0);")],
    "no_appends": [("  if (__any_sync(kFull, mine)) {",
                    "  if (false && __any_sync(kFull, mine)) {")],
}

# (case, Q, dim, k)
CASES = (
    ("serving_q32_dim128_k64", 32, 128, 64),
    ("two_tower_q512_dim64_k128", 512, 64, 128),
    ("fma_q32_dim512_k256", 32, 512, 256),
    ("q32_dim128_k512", 32, 128, 512),
    ("q32_dim128_k1024", 32, 128, 1024),
    ("q32_dim512_k512", 32, 512, 512),
    ("q32_dim512_k1024", 32, 512, 1024),
    ("sweep_q2470_dim128_k1024", 2470, 128, 1024),
    # Fig. 3's other large-k stage 0s below 512 dims (d_start 64 and 256 at
    # k0 1,024, 128 at 512)
    ("sweep_q2470_dim64_k1024", 2470, 64, 1024),
    ("sweep_q2470_dim256_k1024", 2470, 256, 1024),
    ("sweep_q2470_dim128_k512", 2470, 128, 512),
    # the paper's truncated baselines (Table II) and the stage 0 of its
    # progressive searches from 512 dims (Table III's k0 16, Fig. 3's 1,024)
    ("table2_q2470_dim512_k1", 2470, 512, 1),
    ("table2_q2470_dim1024_k1", 2470, 1024, 1),
    ("table2_q2470_dim2048_k1", 2470, 2048, 1),
    ("table2_q2470_dim3584_k1", 2470, 3584, 1),
    ("table3_q2470_dim512_k16", 2470, 512, 16),
    ("fig3_q2470_dim512_k1024", 2470, 512, 1024),
)

_CHILD = r'''
import json, statistics, subprocess, sys
sys.path.insert(0, sys.argv[1])
seed, cases = int(sys.argv[2]), json.loads(sys.argv[3])
patches, with_plain = json.loads(sys.argv[4]), sys.argv[5] == "1"
bigk_patches = json.loads(sys.argv[6])
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
try:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
except (OSError, IndexError):
    card = torch.cuda.get_device_name(0)


def cuda_ms(fn, runs=30):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    if a.elapsed_time(b) > 50.0:
        runs = 5
    else:
        for _ in range(2):
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


def yardstick(q, dim, k, s):
    x = db[:, :dim]
    out = []
    for a in range(0, q.shape[0], 512):
        sc = s - 2.0 * torch.matmul(q[a:a + 512, :dim], x.T)
        out.append(torch.topk(sc.masked_fill(~valid, float("inf")), k, dim=1,
                              largest=False))
    return out


def slow_ms(fn, runs=3):
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
        if any(s in ev.key for s in ("l2_scan", "l2_merge", "wide_split")):
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
    ms = cuda_ms(fn)
    # a wide call launches its query pre-pass, pass 1 and pass 2
    per_call = (2 if plan[-1] == 1 else 3) + (plan[0] == "wide")
    row = {"case": case, "Q": nq, "dim": dim, "k": k, "plan": list(plan),
           "ms": ms,
           "device_ms": device_ms(fn, per_call, 3 if ms > 50 else 10),
           "card": card}
    if with_plain:
        row["plain_ms"] = slow_ms(lambda: distance_topk.l2_topk_plain(
            q, db, dim=dim, k=k, sq_at_dim=s, valid=valid))
        row["matmul_topk_ms"] = slow_ms(lambda: yardstick(q, dim, k, s))
    print(json.dumps(row), flush=True)

from repro_torch.kernels import _build
if patches and (_build.CSRC / "distance_topk_wide.cu").exists():
    libs = _build.build_copies(
        {name: (_build.patched("distance_topk_wide", reps), ())
         for name, reps in patches.items()},
        _build.BUILD_DIR.parent / "stage0_patches")
    for name in patches:
        _build._libs["distance_topk_wide"] = libs[name]
        distance_topk._fns.pop("wide", None)
        for case, nq, dim, k in cases:
            q = queries[:nq].contiguous()
            if distance_topk.route(q, db, dim, k) != "wide":
                continue
            s = sq[:, dims.index(dim)].contiguous()
            ms = cuda_ms(lambda: distance_topk.l2_topk(
                q, db, dim=dim, k=k, sq_at_dim=s, valid=valid))
            print(json.dumps({"case": case, "variant": name, "Q": nq,
                              "dim": dim, "k": k, "ms": ms, "card": card}),
                  flush=True)
header = _build.CSRC / "distance_topk.cuh"
if bigk_patches and header.exists() and "WGMMA_BIGK_PLAN" in header.read_text():
    copies = {}
    for name, reps in bigk_patches.items():
        text = header.read_text()
        for old, new in reps:
            if text.count(old) != 1:
                raise SystemExit(f"the patch {name!r} no longer matches once")
            text = text.replace(old, new)
        copies[name] = ("#define L2_ELEM float\n" + text, ())
    libs = _build.build_copies(copies, _build.BUILD_DIR.parent /
                               "stage0_patches")
    for name in bigk_patches:
        _build._libs["distance_topk"] = libs[name]
        distance_topk._fns.pop(False, None)
        for case, nq, dim, k in cases:
            q = queries[:nq].contiguous()
            if k <= 256 or distance_topk.route(q, db, dim, k) != "wgmma":
                continue
            s = sq[:, dims.index(dim)].contiguous()
            ms = cuda_ms(lambda: distance_topk.l2_topk(
                q, db, dim=dim, k=k, sq_at_dim=s, valid=valid))
            print(json.dumps({"case": case, "variant": name, "Q": nq,
                              "dim": dim, "k": k, "ms": ms, "card": card}),
                  flush=True)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__))))],
                    help="directories holding repro_torch (default: this one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the rows, the tombstones and the queries")
    ap.add_argument("--cases", default="",
                    help="comma-separated case names to keep (default all)")
    ap.add_argument("--wide-patches", default="",
                    help="comma-separated names of WIDE_PATCHES to time")
    ap.add_argument("--bigk-patches", default="",
                    help="comma-separated names of BIGK_PATCHES to time")
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain version and matmul + topk")

    args = ap.parse_args()
    keep = set(filter(None, args.cases.split(",")))
    if keep - {c[0] for c in CASES}:
        raise SystemExit(f"unknown cases {sorted(keep - {c[0] for c in CASES})}")
    cases = [c for c in CASES if not keep or c[0] in keep]
    patches = {name: WIDE_PATCHES[name]
               for name in filter(None, args.wide_patches.split(","))}
    bigk = {name: BIGK_PATCHES[name]
            for name in filter(None, args.bigk_patches.split(","))}
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, str(args.seed),
             json.dumps(cases), json.dumps(patches),
             "1" if args.plain else "0", json.dumps(bigk)],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            if line.startswith("{"):
                print(json.dumps({"tree": tree, **json.loads(line)}),
                      flush=True)


if __name__ == "__main__":
    main()
