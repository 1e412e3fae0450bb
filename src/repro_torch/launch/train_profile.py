"""Where an LM training step's device time goes, on one card.

Builds the kernels, makes the arch's full config (random weights from the
seed), runs ``--warm`` steps of ``TrainLoop`` on ``lm_batch_stream`` data
(AdamW, lr 3e-4 after 3 warm-up steps, as ``chip_smoke.py``'s train
phase), then ``--steps`` more under ``torch.profiler`` and prints, per
step, the wall ms, the device ms by group (flash forward, flash backward,
matrix products, copies and casts, the rest) and the longest kernels::

    PYTHONPATH=src python3 -m repro_torch.launch.train_profile \\
        --arch starcoder2-3b --batch 4 --seq 4096

Needs a CUDA device; prints JSON lines, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

GROUPS = (  # (group, substrings of a kernel's name), the first match wins
    ("flash_backward", ("flash_bwd",)),
    ("flash_forward", ("flash_attention_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "sm90_", "nvjet")),
    ("copy_cast", ("copy", "Copy", "cast")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import lm_batch_stream
    from repro_torch.models import lm as LM
    from repro_torch.train import TrainLoop

    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA device")
    dev = torch.device("cuda")
    cfg = get_arch(args.arch).CONFIG
    params = LM.param_tree(LM.init_lm(cfg, seed=args.seed, device=dev))
    for p in _leaves(params)[0]:
        p.requires_grad_(True)
    total = args.warm + args.steps
    loop = TrainLoop(lambda p, bt: LM.lm_loss(LM.lm_view(p, cfg), bt),
                     lambda: params,
                     lm_batch_stream(np.random.default_rng(args.seed),
                                     cfg.vocab, args.batch, args.seq),
                     log_every=total, base_lr=3e-4, warmup=3,
                     total_steps=total)
    loop.run(args.warm)
    torch.cuda.synchronize()
    n0 = len(loop.step_times)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.run(args.steps)       # (each run counts its steps from 0)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = len(loop.step_times) - n0
    by_group = collections.Counter()
    kernels = []
    for ev in prof.key_averages():
        ms = getattr(ev, "device_time_total", 0.0) / 1e3
        if ms <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_group[group_of(ev.key)] += ms / steps
        kernels.append((ms / steps, ev.count // steps, ev.key[:120]))
    kernels.sort(reverse=True)
    print(json.dumps({
        "arch": args.arch, "batch": args.batch, "seq": args.seq,
        "steps_profiled": steps,
        "step_ms_unprofiled": [t * 1e3
                               for t in list(loop.step_times)[:n0]],
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": sum(by_group.values()),
        "device_ms_by_group": dict(by_group.most_common()),
        "peak_gb": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    for ms, n, name in kernels[:args.top]:
        print(json.dumps({"kernel": name, "ms_per_step": ms,
                          "calls_per_step": n}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
