"""Time the embedding-bag kernel at the recsys paths' shapes, for one or more
source trees.

For each tree given (a directory holding ``repro_torch``), in the order
given, a fresh process builds that tree's kernels and times its
``embedding_bag`` wrapper on five inputs made on the card from ``--seed``,
the rows of ``chip_smoke.py``:

* ``dlrm_bulk`` / ``dlrm_p99``: DLRM-RM2's stacked tables (26 x 5M x 64
  float32, ``recsys_init``) with the ids of a 262,144- / 512-row batch of
  ``recsys_batch_stream`` (one id a bag);
* ``two_tower_item_build``: the two-tower item tables (4 x 1M x 256
  float32) with every item id once;
* ``L100_padded_sum_float32`` / ``_bfloat16``: 4 x 100,000 x 64 tables,
  4,096 x 4 bags of 100 ids, 30% padding, 64 all-padding bags, ids past V.

Per row: ``ms``, the CUDA-event time of one call with the L2 flushed before
it (median of 20); ``device_ms`` and ``kernels_per_call``, every kernel the
call runs, from ``torch.profiler`` over 10 calls (None unless the trace
holds one embedding-bag kernel a call); ``host_us``, host time a
call over 200 calls without a synchronise (median of 7 such loops);
``bound_ms``, the bytes the function must move (`bound_bytes`) at 3.35
TB/s; the route, the launches a call and whether the output equals the
plain version's.  Then the models around it: DLRM-RM2's forward at both
batches (L2 flushed) and the two-tower item DB build, as ``chip_smoke.py``
times them.

With ``--variants``, a tree whose kernel source sets the L2 cache policies
is also built as the patched copies named (``VARIANTS``: ``l2_normal``, no
policy; ``l2_stores_only``, evict-first stores alone; ``rows_in_l2``, every
id folded onto the first 1,024 rows of its field; ``no_row_loads``, no row
read at all) into ``build/embedding_bag_variants/`` and each row timed
through each copy (the copies' outputs are not checked).  With ``--passes 1,4,...``, each
row is also timed with the ``vec16`` grid's walk taking the fields in
passes of each number given (``tile_plan``'s ``fields_per_pass``; 1 is
field by field, the field count memory order), each checked equal to the
plain version.

To compare two trees on one card, list them in turns::

    python3 -m repro_torch.launch.embedding_bag_time OLD/src src src OLD/src

Needs a CUDA device; prints one JSON line per (tree, row), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# Patched copies of the kernel source: (extra nvcc flags, [(text, replacement)]).
# l2_normal: both cache policies evict-normal (no L2 policy); l2_stores_only:
# the row loads' policy evict-normal, the stores' evict-first; rows_in_l2:
# every id read as one of the first 1,024 rows of its field (all row loads
# hit L2; the output is wrong, the stores and the walk unchanged);
# no_row_loads: the row loads replaced by their address (the ids, the walk
# and the output stream only).
EVICT_LAST = "createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
EVICT_FIRST = "createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
EVICT_NORMAL = "createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
VARIANTS = {
    "l2_normal": ([], [(EVICT_LAST, EVICT_NORMAL), (EVICT_FIRST, EVICT_NORMAL)]),
    "l2_stores_only": ([], [(EVICT_LAST, EVICT_NORMAL)]),
    "rows_in_l2": ([], [(
        "  return min(static_cast<unsigned>(id), last_row);\n",
        "  return min(static_cast<unsigned>(id), last_row) & 1023u;\n")]),
    "no_row_loads": ([], [(
        "__device__ __forceinline__ uint4 load_row16(const char* p, uint64_t pol) {\n",
        "__device__ __forceinline__ uint4 load_row16(const char* p, uint64_t pol) {\n"
        "  if (pol != 1) return make_uint4(static_cast<uint32_t>("
        "reinterpret_cast<uintptr_t>(p)), 0u, 0u, 0u);\n")]),
}

_CHILD = r'''
import ctypes, gc, json, statistics, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
seed, variants = int(sys.argv[2]), [v for v in sys.argv[3].split(",") if v]
VARIANTS = json.loads(sys.argv[5])
passes = [int(v) for v in sys.argv[4].split(",") if v]
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import get_arch
from repro_torch.data.synth import recsys_batch_stream
from repro_torch.kernels import _build
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models import recsys as R

torch.backends.cuda.matmul.allow_tf32 = False
PEAK_BYTES_PER_S = 3.35e12
dev = torch.device("cuda")
flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)


def cuda_ms(fn, runs=20, cold=True):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        if cold:
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
    """(device ms a call, kernels by name); (None, kernels) when the trace
    did not hold one embedding-bag kernel a call (it lost records)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total, kernels, own = 0.0, {}, 0
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        total += us
        own += ev.count if "embedding_bag" in ev.key else 0
        kernels[ev.key[:70]] = {"per_call": ev.count / runs,
                                "device_ms": us / runs / 1e3}
    return (total / runs / 1e3 if own == runs else None), kernels


def host_us(fn, calls=200, repeats=7):
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def copies(names):
    """{variant: (library, entry)} of the tree's kernel patched as VARIANTS
    names them (none for a tree whose source sets no L2 policy)."""
    src = (_build.CSRC / "embedding_bag.cu").read_text()
    if "createpolicy" not in src or not names:
        return {}
    out_dir = _build.BUILD_DIR.parent / "embedding_bag_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        flags, patches = VARIANTS[name]
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name!r} no longer matches")
            text = text.replace(old, new)
        path = out_dir / f"embedding_bag_{name}.cu"
        path.write_text(text)
        lib = out_dir / f"libembedding_bag_{name}-{_build._digest()}.so"
        if lib.exists():
            procs[name] = (None, lib)
            continue
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
               str(_build.CSRC), "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate() if proc else (None, "")
        if proc and proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        dll = ctypes.CDLL(str(lib))
        size = dll.embedding_bag_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        assert size() == eb.ARGS.size
        fn = dll.embedding_bag_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        libs[name] = (dll, fn)
    return libs


def row(case, tables, ids, patched, mode="sum"):
    kern = lambda: eb.embedding_bag(tables, ids, mode=mode)
    got = kern()
    want = eb.embedding_bag_plain(tables, ids, mode=mode)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    del got, want
    n0 = eb.launches
    kern()
    per_call = eb.launches - n0
    dev_ms, kernels = profiled(kern)
    n_bytes = eb.bound_bytes(tables, ids)
    out = {"case": case,
           "shape": f"tables {tuple(tables.shape)} "
                    f"{str(tables.dtype).replace('torch.', '')}, ids "
                    f"{tuple(ids.shape)}, {mode}",
           "route": eb.route(tables, ids) if hasattr(eb, "route") else "cuda",
           "equal_plain": equal, "max_abs_err": err,
           "launches_per_call": per_call, "ms": cuda_ms(kern),
           "device_ms": dev_ms,
           "kernels_per_call": sum(v["per_call"] for v in kernels.values()),
           "kernels": kernels, "host_us": host_us(kern),
           "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3, "bytes": n_bytes}
    saved = eb._fn
    for name, lib in patched.items():
        eb._fn = lib
        out[name] = {"ms": cuda_ms(kern), "device_ms": profiled(kern)[0]}
    eb._fn = saved
    if passes and hasattr(eb, "_plan") and out["route"] == "vec16":
        planned = eb._plan
        for fp in passes:
            fp = min(fp, tables.shape[0])
            eb._plan = lambda *a, fp=fp: {**planned(*a), "fields_per_pass": fp}
            same = bool(torch.equal(kern(), eb.embedding_bag_plain(
                tables, ids, mode=mode)))
            out[f"fields_per_pass_{fp}"] = {
                "ms": cuda_ms(kern), "device_ms": profiled(kern)[0],
                "equal_plain": same}
        eb._plan = planned
    print(json.dumps(out), flush=True)


def batch(cfg, bs, s):
    b = next(recsys_batch_stream(
        np.random.default_rng(s), cfg.family, bs, n_sparse=cfg.n_sparse,
        multi_hot=cfg.multi_hot, vocab=cfg.vocab_per_field,
        n_dense=cfg.n_dense, seq_len=cfg.seq_len))
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def free():
    gc.collect()
    torch.cuda.empty_cache()


eb.embedding_bag(torch.zeros((1, 1, 4), device=dev),
                 torch.zeros((1, 1, 1), dtype=torch.int32, device=dev))
built = copies(variants)
print(json.dumps({"build_s": _build.build_seconds,
                  "ptxas": _build.ptxas_report.get("embedding_bag", "")[-3000:],
                  "variants": sorted(built)}), flush=True)

cfg = get_arch("dlrm-rm2").CONFIG
params = R.recsys_init(cfg, seed=seed, device=dev)
batches = {bs: batch(cfg, bs, seed + 20 + bs) for bs in (512, 262_144)}
row("dlrm_bulk", params["tables"], batches[262_144]["ids"], built)
row("dlrm_p99", params["tables"], batches[512]["ids"], built)
fwd = {str(bs): cuda_ms(lambda b=b: R.recsys_forward(params, b, cfg), runs=10)
       for bs, b in batches.items()}
print(json.dumps({"model": cfg.name, "forward_ms": fwd}), flush=True)
del params, batches
free()

cfg = get_arch("two-tower-retrieval").CONFIG
params = R.recsys_init(cfg, seed=seed, device=dev)
nf = params["item_tables"].shape[0]
items = torch.arange(1_000_000, dtype=torch.int32, device=dev)[
    :, None, None].expand(1_000_000, nf, 1).contiguous()
row("two_tower_item_build", params["item_tables"], items, built)
print(json.dumps({"model": cfg.name, "item_db_build_ms": cuda_ms(
    lambda: R.tower_item(params, items), runs=5, cold=False)}), flush=True)
del params, items
free()

g = torch.Generator(device=dev)
g.manual_seed(seed + 13)
f, v, d, b = 4, 100_000, 64, 4096
for dtype in (torch.float32, torch.bfloat16):
    tabs = (torch.randn((f, v, d), generator=g, device=dev) * d ** -0.5).to(dtype)
    ids = torch.randint(0, v, (b, f, 100), generator=g, device=dev,
                        dtype=torch.int32)
    ids[torch.rand((b, f, 100), generator=g, device=dev) < 0.3] = -1
    ids[:64] = -1
    ids[64:80, :, 0] = v + torch.arange(16, device=dev,
                                        dtype=torch.int32)[:, None]
    row(f"L100_padded_sum_{str(dtype).replace('torch.', '')}", tabs, ids,
        built)
    del tabs, ids
    free()
'''


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__))))],
                    help="directories holding repro_torch (default: this one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the tables and the ids")
    ap.add_argument("--variants", default="",
                    help="comma-separated patched copies to time as well "
                         "(l2_normal, l2_stores_only, rows_in_l2, "
                         "no_row_loads)")
    ap.add_argument("--passes", default="",
                    help="comma-separated fields a pass of the vec16 walk "
                         "to time as well (1 = field by field)")
    args = ap.parse_args()
    for turn, tree in enumerate(args.trees):
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, str(args.seed),
             args.variants, args.passes, json.dumps(VARIANTS)],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            if line.startswith("{"):
                print(json.dumps({"turn": turn, "tree": tree,
                                  **json.loads(line)}), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
