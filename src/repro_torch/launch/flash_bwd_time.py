"""Times a route of the flash-attention backward on one card, beside SDPA's.

For the tree's source of the route (``--route bwd_wgmma``:
``csrc/flash_attention_bwd_wgmma.cu``; ``bwd_fma``:
``csrc/flash_attention_bwd.cu``), each patched copy named with ``--patch``
(``PATCHES``) and each variant source given (a copy of either route's
source with its C entry and the same argument block, say the parent
commit's from ``git show``; it serves the calls of the route it is timed
for), all built with the tree's flags by ``kernels._build.build_copies``,
it first holds every build against ``flash_attention_backward_plain`` on
shapes off the tiles (within 8e-3 of the largest |plain| in bf16, 1e-4 in
float32, as ``chip_smoke.py``; two calls bit-equal; a variant whose
launcher refuses a head dim, as the parent's ``bwd_fma`` source refuses
bf16 at 64 / 128, is reported and left out at that head dim), then times
each at the route's causal training shapes — ``bwd_wgmma``: StarCoder2-3B's
call at batch 1 and 4 (q (B, 24, 4096, 128), kv (B, 2, ·), v a transposed
view), Mistral-Nemo-12B's group of 4, a head-dim-64 group of 4, and at
head dim 256 Gemma3-4B's call with its 1,024-key window and without it
(global) and DeepSeek-V2's MLA call padded to 256 at its scale 192^-0.5;
``bwd_fma``: Gemma3-4B's windowed call in float32 at 2,048 tokens —
together with SDPA's backward (``torch.autograd.grad`` of
``scaled_dot_product_attention`` on the same tensors, mask and scale) in
turns (builds then SDPA, and back).  Each turn gives ``ms``, CUDA events over 10
calls back to back after 2 (the device stays busy, so the host's enqueue
time hides); ``cold_ms``, ``chip_smoke.py``'s way: the median of 5 single
calls, each after overwriting 256 MB so the L2 is cold, in which the
device waits on whatever the host does before the first kernel; and
``device_ms``, every kernel of one call from ``torch.profiler``
(``kernel_device_ms``: the hand-written ones)::

    git show HEAD~1:src/repro_torch/csrc/flash_attention_bwd.cu \\
        > build/old.cu
    PYTHONPATH=src python3 -m repro_torch.launch.flash_bwd_time \\
        --route bwd_fma --patch prefetch build/old.cu

or, for the head-dim-256 rows that ``bwd_wgmma`` took from ``bwd_fma``,
the parent's FMA source beside the tree's tensor-core route::

    PYTHONPATH=src python3 -m repro_torch.launch.flash_bwd_time build/old.cu

Needs a CUDA device; prints one JSON line per check and per timing, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

CHECKS = {  # b, hq, hkv, sq, skv, dh, causal, window, v transposed, dtype
    "bwd_wgmma": (
        (1, 4, 2, 90, 90, 256, True, 40, False),
        (1, 4, 4, 96, 96, 256, True, None, False),
        (1, 16, 4, 77, 333, 256, False, 100, True),
        (1, 4, 4, 128, 128, 64, False, None, False),
        (2, 8, 2, 100, 100, 64, True, None, False),
        (1, 24, 2, 300, 300, 128, True, None, True),
        (1, 16, 1, 130, 90, 64, True, None, False),
        (1, 8, 2, 77, 150, 64, False, 40, False),
        (1, 12, 1, 70, 70, 128, True, 16, True),
        (2, 16, 4, 1000, 1234, 64, False, 300, False),
        (1, 8, 2, 1, 40, 128, True, None, False),
        (1, 24, 2, 4096, 4096, 128, True, None, True),
        (4, 24, 2, 1024, 1024, 128, True, None, True)),
    "bwd_fma": (
        (1, 4, 2, 90, 90, 256, True, 40, False, "float32"),
        (1, 2, 1, 77, 77, 32, True, 16, True),
        (1, 3, 1, 50, 120, 128, False, 30, False, "float32"),
        (1, 2, 2, 80, 40, 64, True, None, False, "float32"))}
_MLA = 192 ** -0.5
SHAPES = {  # name: b, hq, hkv, s, dh, window, scale, dtype (causal, v a
            # transposed view)
    "bwd_wgmma": {
        "starcoder2_b1": (1, 24, 2, 4096, 128, None, None, "bfloat16"),
        "starcoder2_b4": (4, 24, 2, 4096, 128, None, None, "bfloat16"),
        "mistral_b1": (1, 32, 8, 4096, 128, None, None, "bfloat16"),
        "dh64_group4_b1": (1, 16, 4, 4096, 64, None, None, "bfloat16"),
        "gemma3_window_dh256": (1, 8, 4, 4096, 256, 1024, None, "bfloat16"),
        "gemma3_global_dh256": (1, 8, 4, 4096, 256, None, None, "bfloat16"),
        "mla_padded_group1": (1, 128, 128, 1024, 256, None, _MLA,
                              "bfloat16")},
    "bwd_fma": {"gemma3_window_dh256_float32": (1, 8, 4, 2048, 256, 1024,
                                                None, "float32")}}
TOL = {"bfloat16": 8e-3, "float32": 1e-4}

# Patched copies of the route's source: {route: {name: [(text, replacement)]}}.
# bwd_fma: no_range drops the dQ launch's L2 prefetch of its key range (the
# launch as it was with the forward's lse and before that prefetch);
# k_range keeps K's part of it alone; touch_k and prefetch_dq drop it too
# and instead walk the key range once, loading each K tile into shared
# memory and computing nothing, before the real walk (the load pattern of
# the log-sum-exp pass the launch lost) / ask L2 for the next K and V tile
# before computing on the current one; prefetch does that and the same for
# the next Q and dO tile of the dK / dV launch; dkdv_range asks L2, as each
# q head of the dK / dV launch begins, for the Q and dO rows it will walk.
_RANGE_K = ("  prefetch_rows<T, DH>(kb + k_first * a.st_k[2], a.st_k[2], "
            "k_hi - k_first);\n")
_RANGE_V = ("  prefetch_rows<T, DH>(vb + k_first * a.st_v[2], a.st_v[2], "
            "k_hi - k_first);\n")
_NO_RANGE = (_RANGE_K + _RANGE_V, "")
_TOUCH_K = (
    "  // ---- A = sum_j P dP K, B = sum_j P K, D = sum_j P dP ----\n",
    "  for (int k0 = k_first; k0 < k_hi; k0 += BK) {\n"
    "    __syncthreads();\n"
    "    load_tile<T, DH>(Ks, kb + k0 * a.st_k[2], a.st_k[2],\n"
    "                     min(BK, a.skv - k0), BK);\n"
    "  }\n"
    "  // ---- A = sum_j P dP K, B = sum_j P K, D = sum_j P dP ----\n")
_DQ_LOADS = """    load_tile<T, DH>(Vs, vb + k0 * a.st_v[2], a.st_v[2], nk, BK);
    __syncthreads();
"""
_DQ_NEXT = (_DQ_LOADS, """    load_tile<T, DH>(Vs, vb + k0 * a.st_v[2], a.st_v[2], nk, BK);
    if (k0 + BK < k_hi) {
      const int nn = min(BK, k_hi - k0 - BK);
      prefetch_rows<T, DH>(kb + (k0 + BK) * a.st_k[2], a.st_k[2], nn);
      prefetch_rows<T, DH>(vb + (k0 + BK) * a.st_v[2], a.st_v[2], nn);
    }
    __syncthreads();
""")
_DKDV_LOADS = """      load_tile<T, DH>(dOs, dob + q0 * a.st_do[2], a.st_do[2], nq, BQ);
"""
_DKDV_NEXT = (_DKDV_LOADS, _DKDV_LOADS + """      if (q0 + BQ < i_hi) {
        const int nn = min(BQ, i_hi - q0 - BQ);
        prefetch_rows<T, DH>(qb + (q0 + BQ) * a.st_q[2], a.st_q[2], nn);
        prefetch_rows<T, DH>(dob + (q0 + BQ) * a.st_do[2], a.st_do[2], nn);
      }
""")
_DKDV_HEAD = ("    const long long row_h = (static_cast<long long>(bi) * a.hq + h) "
              "* a.sq;\n")
_DKDV_RANGE = (_DKDV_HEAD, _DKDV_HEAD + """    if (i_lo < i_hi) {
      const int q_first = (i_lo / BQ) * BQ;
      prefetch_rows<T, DH>(qb + q_first * a.st_q[2], a.st_q[2],
                           i_hi - q_first);
      prefetch_rows<T, DH>(dob + q_first * a.st_do[2], a.st_do[2],
                           i_hi - q_first);
    }
""")
PATCHES = {
    "bwd_fma": {
        "no_range": [_NO_RANGE],
        "k_range": [(_RANGE_V, "")],
        "touch_k": [_NO_RANGE, _TOUCH_K],
        "prefetch_dq": [_NO_RANGE, _DQ_NEXT],
        "prefetch": [_NO_RANGE, _DQ_NEXT, _DKDV_NEXT],
        "dkdv_range": [_DKDV_RANGE]},
    "bwd_wgmma": {}}


def timers(torch, dev, own):
    """(events_ms, cold_ms, device_ms) of a call on ``dev``: CUDA events
    over 10 calls back to back after 2; the median of 5 single calls, each
    after overwriting 256 MB so the L2 is cold; and (every kernel's device
    ms of one call, {kernel name matching the regex ``own``: its ms}) from
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def events_ms(call):
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            call()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 10

    def cold_ms(call):
        times = []
        for _ in range(5):
            flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return sorted(times)[2]

    def device_ms(call):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        total, mine = 0.0, {}
        for ev in prof.key_averages():
            ms = getattr(ev, "self_device_time_total",
                         getattr(ev, "device_time_total", 0.0)) / 1e3
            if ms <= 0:
                continue
            total += ms
            found = re.search(own, ev.key)
            if found:
                mine[found.group(0)] = ms
        return total, mine

    return events_ms, cold_ms, device_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    help="other copies of the route's source")
    ap.add_argument("--route", choices=tuple(SHAPES), default="bwd_wgmma")
    ap.add_argument("--patch", action="append", default=[],
                    help="a patched copy of the tree's source (PATCHES)")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_time needs a CUDA device")
    dev = torch.device("cuda")
    route = args.route
    stem = fa._BWD_LIBS[route][0]
    copies = {f"{stem}_{name}": (_build.patched(stem, PATCHES[route][name]),
                                 ()) for name in args.patch}
    copies.update({f"{stem}_variant{i}": (open(src).read(), ())
                   for i, src in enumerate(args.variants)})
    built = _build.build_copies(copies, _build.BUILD_DIR.parent / "flash_bwd")
    libs = {"tree": fa._bwd_kernel(route)}
    entries = [e for _, e in fa._BWD_LIBS.values()]
    for name, key in zip([*args.patch, *args.variants], copies):
        # the copy's own C entry: a variant may be the other route's source
        own = next(e for e in entries if hasattr(built[key], e + "_launch"))
        fn = getattr(built[key], own + "_launch")
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        libs[name] = (built[key], fn)

    def inputs(b, hq, hkv, sq, skv, dh, v_t, seed, dtype="bfloat16"):
        g = torch.Generator(device=dev).manual_seed(seed)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                getattr(torch, dtype))

        q, k = rnd(b, hq, sq, dh), rnd(b, hkv, skv, dh)
        v = (rnd(b, skv, hkv, dh).transpose(1, 2) if v_t
             else rnd(b, hkv, skv, dh))
        return q, k, v, rnd(b, hq, sq, dh)

    def rel(a, b):
        scale = float(b.float().abs().max()) or 1.0
        return float((a.float() - b.float()).abs().max()) / scale

    served = {name: set() for name in libs}   # (head dim, dtype) it takes
    for name, lf in libs.items():
        fa._bwd[route] = lf
        for case in CHECKS[route]:
            b, hq, hkv, sq, skv, dh, causal, window, v_t, *dtype = case
            dtype = (dtype or ["bfloat16"])[0]
            q, k, v, do = inputs(b, hq, hkv, sq, skv, dh, v_t, sq + hq,
                                 dtype)
            if fa.backward_route(q.dtype, dh) != route:
                raise SystemExit(f"{case} is not on {route}")
            _, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                        return_lse=True)
            call = lambda: fa.flash_attention_backward(
                q, k, v, do, lse, causal=causal, window=window)
            try:
                got, again = call(), call()
            except RuntimeError as err:        # the launcher refused it
                if name == "tree":
                    raise
                print(json.dumps({"check": name, "case": case,
                                  "refused": str(err)}), flush=True)
                continue
            served[name].add((dh, dtype))
            want = fa.flash_attention_backward_plain(q, k, v, do,
                                                     causal=causal,
                                                     window=window)
            torch.cuda.synchronize()
            errs = [rel(x, y) for x, y in zip(got, want)]
            equal = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = max(errs) <= TOL[dtype] and equal
            print(json.dumps({"check": name, "case": case, "rel_err": errs,
                              "bit_equal": equal, "ok": ok}), flush=True)
            if not ok:
                raise SystemExit(f"{name}: {case} off")
    fa._bwd[route] = libs["tree"]

    events_ms, cold_ms, device_ms = timers(torch, dev, r"flash_bwd_\w+")

    for shape, (b, hq, hkv, s, dh, window, scale, dtype) in \
            SHAPES[route].items():
        builds = [n for n in libs if (dh, dtype) in served[n]] + ["sdpa"]
        q, k, v, do = inputs(b, hq, hkv, s, s, dh, True, 7, dtype)
        _, lse = fa.flash_attention(q, k, v, causal=True, window=window,
                                    scale=scale, return_lse=True)
        kern = lambda: fa.flash_attention_backward(
            q, k, v, do, lse, causal=True, window=window, scale=scale)
        if window is None:
            sdpa_kw = {"is_causal": True}
        else:
            pos = torch.arange(s, device=dev)
            rel_pos = pos[:, None] - pos[None, :]
            sdpa_kw = {"attn_mask": (rel_pos >= 0) & (rel_pos < window)}
        if scale is not None:
            sdpa_kw["scale"] = scale
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, enable_gqa=True,
                                             **sdpa_kw)
        sdpa = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        for name in builds + builds[::-1]:
            if name != "sdpa":
                fa._bwd[route] = libs[name]
            call = sdpa if name == "sdpa" else kern
            dev_ms, own = device_ms(call)
            print(json.dumps({"route": route, "shape": shape, "build": name,
                              "ms": events_ms(call), "cold_ms": cold_ms(call),
                              "device_ms": dev_ms,
                              "kernel_device_ms": own}), flush=True)
        fa._bwd[route] = libs["tree"]
        del q, k, v, do, lse, leaves, out, sdpa_kw
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
