"""Host time of one flash-attention decode call, for one or more source trees.

The decode step of the RAG path makes about 1,100 launches and is bound by
the host; this measures what the wrapper costs the host per call.  For each
tree given (a directory holding ``repro_torch``), in the order given, a
fresh process times 1,000 calls of ``flash_attention`` at Mistral-Nemo-12B's
decode shape (bf16 q (8, 32, 1, 128) over an (8, 8, 543, 128) prefix of a
544-position cache) without synchronising, seven times, and prints the
median microseconds per call beside that of a one-element ``Tensor.add_``
(the host cost of a plain PyTorch launch on the same machine).  To compare
two trees on one card, list them in turns::

    python3 -m repro_torch.launch.flash_host_time OLD/src src src OLD/src

Needs a CUDA device; prints one JSON line per tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r'''
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import flash_attention as fa
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
q = torch.randn(8, 32, 1, 128, generator=g, device=dev).bfloat16()
kc = torch.randn(8, 8, 544, 128, generator=g, device=dev).bfloat16()
vc = torch.randn(8, 8, 544, 128, generator=g, device=dev).bfloat16()
k, v = kc[:, :, :543], vc[:, :, :543]
x = torch.zeros(4, device=dev)


def per_call_us(fn):
    fn()
    out = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(out), out


call_us, runs = per_call_us(lambda: fa.flash_attention(q, k, v, causal=True))
add_us, _ = per_call_us(lambda: x.add_(1))
print(json.dumps({"host_us_per_call": call_us, "runs_us": runs,
                  "add_us_per_call": add_us}))
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__))))],
                    help="directories holding repro_torch (default: this one)")
    args = ap.parse_args()
    for tree in args.trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **row}), flush=True)


if __name__ == "__main__":
    main()
