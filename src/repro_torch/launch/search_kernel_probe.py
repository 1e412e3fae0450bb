"""Where the flat PQ scan and the rescore ladder spend their time, on one card.

The profiler gives whole-kernel times only, so this probe builds patched
copies of ``csrc/pq_scan.cu`` with one section switched off each (the
selection: no key is ever taken; the lookups: each table read replaced by
the code's bits read as a float) into ``build/kernel_probe/`` and times
`kernels.pq_scan.pq_scan_topk` through each at the ``quantized_pq`` serving
shape (Q = 32, N = 2^20, M = 16, C = 256, k = 256), at tile sizes 8 and 4.
The difference to the unpatched build is what the section costs.  It also
gives the device time of the scan's two kernels, and times the one-launch
rescore ladder at the flat dispatch shape (Q = 32, C = 64, five stages to
3,584 dims) at every cluster size, the L2 flushed before each call.

Run from the root of a checkout on a machine with the card:

    PYTHONPATH=src python -m repro_torch.launch.search_kernel_probe

Prints one JSON object a line, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build, gather_rescore, pq_scan

# (name, [(text of csrc/pq_scan.cu, replacement)])
PATCHES = {
    "as_built": [],
    "no_selection": [(
        "take = key[v] < thr[v];",
        "take = key[v] < thr[v] && key[v] == 0ull;")],
    "no_lookups": [(
        "    entries<T, V>(lut_s, j, c, b, h, e);\n",
        "    _Pragma(\"unroll\") for (int v = 0; v < V; ++v) "
        "e[v] = __int_as_float(0x3f800000 + b + v + h);\n")],
}


def _build_patched():
    """{name: (library, flat entry)} of every patched copy."""
    built = _build.build_copies(
        {f"pq_scan_{name}": (_build.patched("pq_scan", reps), ())
         for name, reps in PATCHES.items()},
        _build.BUILD_DIR.parent / "kernel_probe")
    libs = {}
    for name in PATCHES:
        dll = built[f"pq_scan_{name}"]
        fn = dll.pq_scan_topk_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (dll, fn, None)
    return libs


def _events_ms(fn, runs=20, flush=None):
    """Median CUDA-event time of one call (after three warm-up calls)."""
    for _ in range(3):
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


def _device_ms(fn, runs=10):
    """{kernel name: device ms a call} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            out[ev.key[:60]] = us / runs / 1e3
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("search_kernel_probe: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    nq, n, m, k = 32, 1 << 20, 16, 256
    lut = torch.randn((nq, m, 256), generator=g, device=dev) * 3 + 10
    codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.arange(n, device=dev, dtype=torch.int32)
    ids[torch.rand((n,), generator=g, device=dev) < 0.01] = -1
    want = pq_scan.pq_scan_topk_plain(lut, codes, ids, k=k)
    built = pq_scan._kernel()
    for name, fn_tuple in _build_patched().items():
        pq_scan._fn = fn_tuple
        for tile in (8, 4):
            call = lambda: pq_scan.pq_scan_topk(lut, codes, ids, k=k, tile=tile)
            got = call()
            row = {"probe": "pq_scan_topk", "variant": name, "tile": tile,
                   "shape": f"Q={nq} N={n} M={m} C=256 k={k}",
                   "ms": _events_ms(call)}
            if name == "as_built":
                row["equal_plain"] = bool(torch.equal(got[0], want[0])
                                          and torch.equal(got[1], want[1]))
                row["device_ms"] = _device_ms(call)
            print(json.dumps(row), flush=True)
    pq_scan._fn = built

    db = torch.randn((n, 3584), generator=g, device=dev)
    q = db[:32] + 0.3 * torch.randn((32, 3584), generator=g, device=dev)
    cand = torch.randint(0, n, (32, 64), generator=g, device=dev,
                         dtype=torch.int32)
    dims = [256, 512, 1024, 2048, 3584]
    sq = torch.stack([(db[:, :d] ** 2).sum(1) for d in dims], 1)
    stages = list(zip(dims, [32, 16, 10, 10, 10]))
    flush = torch.empty(64 << 20, device=dev)
    for r in (1, 2, 4, 8):
        call = lambda: gather_rescore.rescore_ladder_topk(
            q, db, cand, stages, sq_prefix=sq, sq_cols=list(range(5)),
            cluster=r)
        print(json.dumps({"probe": "rescore_ladder_topk", "cluster": r,
                          "shape": "Q=32 C=64 (dim,k)=" + ",".join(
                              f"({d},{kk})" for d, kk in stages),
                          "ms_cold_l2": _events_ms(call, flush=flush)}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
