"""Times the flash-attention forward on one card, beside SDPA's.

The forward's counterpart of ``launch/flash_bwd_time.py``.  Builds the
tree's ``csrc/flash_attention.cu`` (``tree``) and each other copy of the
source given (``variant0``, ...: same C entry and argument block; a copy
edited by hand is how another design is held against the tree), by
``kernels._build.build_copies``.  Each is first held against
``flash_attention_plain`` on shapes off the tiles, including grids that
the (batch, kv head) pairs alone fill (within 2e-2 in bf16, two calls
bit-equal), then timed at the families' bf16 prefill shapes (``SHAPES``:
Gemma3-4B's global and windowed 2,048-token layers, DeepSeek-V2's MLA
call padded to 256, Mistral-Nemo's 512-token prefill at head dim 128)
together with SDPA on the same tensors (MLA's unpadded) in turns (builds
then SDPA, and back).  Each turn gives ``ms`` (CUDA events over 10 calls
back to back), ``cold_ms`` (the median of 5 single calls after an L2
flush, ``chip_smoke.py``'s way) and ``device_ms`` (the profiler; the
hand-written kernel's in ``kernel_device_ms``).  For example, the tree
against the level-major order of the prefill's work items (no rounds)::

    sed 's/const int per = pairs >= grid .*;$/const int per = 0;/' \\
        src/repro_torch/csrc/flash_attention.cu > /tmp/level_order.cu
    PYTHONPATH=src python3 -m repro_torch.launch.flash_fwd_time \\
        /tmp/level_order.cu

Needs a CUDA device; prints one JSON line per check and per timing, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

from repro_torch.launch.flash_bwd_time import timers

CHECKS = (  # b, hq, hkv, sq, skv, dh, causal, window, v transposed
    (1, 8, 4, 300, 300, 256, True, 100, True),
    (1, 16, 4, 77, 333, 256, False, 100, False),
    (2, 128, 128, 200, 200, 256, True, None, False),   # 256 pairs: rounds
    (2, 80, 80, 300, 300, 64, True, None, True),       # 160 pairs, 3 tiles
    (1, 140, 140, 600, 600, 128, True, 200, False),    # 5 tiles, 2 idle slots
    (2, 32, 8, 200, 200, 128, True, None, True))
SHAPES = {  # name: b, hq, hkv, s, dh, window, unpadded (dqk, dv) or None
    "gemma3_global_prefill": (8, 8, 4, 2048, 256, None, None),
    "gemma3_window_prefill": (8, 8, 4, 2048, 256, 1024, None),
    "mla_prefill_padded": (8, 128, 128, 512, 256, None, (192, 128)),
    "mistral_prefill": (8, 32, 8, 512, 128, None, None)}
TOL = 2e-2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    help="other copies of csrc/flash_attention.cu")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_time needs a CUDA device")
    dev = torch.device("cuda")
    copies = {f"flash_attention_variant{i}": (open(src).read(), ())
              for i, src in enumerate(args.variants)}
    built = _build.build_copies(copies, _build.BUILD_DIR.parent / "flash_fwd")
    fa._kernel()
    libs = {"tree": (fa._lib, fa._fn)}
    for key in copies:
        fn = built[key].flash_attention_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
        libs[key.removeprefix("flash_attention_")] = (built[key], fn)

    def use(name):
        fa._lib, fa._fn = libs[name]

    def rnd(g, *shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for name in libs:
        use(name)
        for case in CHECKS:
            b, hq, hkv, sq, skv, dh, causal, window, v_t = case
            g = torch.Generator(device=dev).manual_seed(sq + hq)
            q, k = rnd(g, b, hq, sq, dh), rnd(g, b, hkv, skv, dh)
            v = (rnd(g, b, skv, hkv, dh).transpose(1, 2) if v_t
                 else rnd(g, b, hkv, skv, dh))
            before = dict(fa.launches_by_kernel)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            again = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            served = [n for n in before
                      if fa.launches_by_kernel[n] != before[n]]
            err = float((got.float() - want.float()).abs().max())
            equal = bool(torch.equal(got, again))
            ok = err <= TOL and equal
            print(json.dumps({"check": name, "case": case, "served": served,
                              "max_abs_err": err, "bit_equal": equal,
                              "ok": ok}), flush=True)
            if not ok:
                raise SystemExit(f"{name}: {case} off")
    use("tree")

    events_ms, cold_ms, device_ms = timers(torch, dev, r"flash_attention_\w+")
    builds = [*libs, "sdpa"]
    for shape, (b, hq, hkv, s, dh, window, unpadded) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(s + hq)
        if unpadded is None:
            q, k = rnd(g, b, hq, s, dh), rnd(g, b, hkv, s, dh)
            v = rnd(g, b, s, hkv, dh).transpose(1, 2)
            small = (q, k, v)
            scale = None
        else:
            dqk, dv = unpadded
            small = (rnd(g, b, hq, s, dqk), rnd(g, b, hkv, s, dqk),
                     rnd(g, b, hkv, s, dv))
            q, k, v = (F.pad(x, (0, dh - x.shape[-1])) for x in small)
            scale = dqk ** -0.5
        kern = lambda: fa.flash_attention(q, k, v, causal=True, window=window,
                                          scale=scale)
        if window is None:
            sdpa_kw = {"is_causal": True}
        else:
            pos = torch.arange(s, device=dev)
            rel_pos = pos[:, None] - pos[None, :]
            sdpa_kw = {"attn_mask": (rel_pos >= 0) & (rel_pos < window)}
        if scale is not None:
            sdpa_kw["scale"] = scale
        sdpa = lambda: F.scaled_dot_product_attention(*small, enable_gqa=True,
                                                      **sdpa_kw)
        for name in builds + builds[::-1]:
            if name != "sdpa":
                use(name)
            call = sdpa if name == "sdpa" else kern
            dev_ms, own = device_ms(call)
            print(json.dumps({"shape": shape, "build": name,
                              "ms": events_ms(call), "cold_ms": cold_ms(call),
                              "device_ms": dev_ms,
                              "kernel_device_ms": own}), flush=True)
        use("tree")
        del q, k, v, small, sdpa_kw
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
