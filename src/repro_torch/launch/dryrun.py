"""Dry run on the meta device: every (architecture x input-shape) cell of
the port on the JAX package's production meshes, with no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all        # sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mistral-nemo-12b --shape train_4k --mesh single      # one cell

The port of ``src/repro/launch/dryrun.py``, which lowers and compiles each
cell for 256 or 512 TPU chips.  Here one process is one rank of a 256-rank
(``single``: 16 x 16 ``('data', 'model')``) or 512-rank (``multi``: 2 x 16
x 16 ``('pod', 'data', 'model')``) ``fake`` process group, whose
collectives return at once, and runs the cell's function
(`repro_torch.launch.inputs.build_cell`) on ``meta`` tensors: no value is
computed, every shape is.  A meta tensor takes the plain path of
``kernels/ops.py``, so the run counts the work, not a kernel.

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``:

  arg_bytes_rules   per-rank argument bytes in the rules' layout (the JAX
                    package's sharding rules, which its GSPMD runs: FSDP
                    over ``data``, tensor parallelism over ``model``)
  arg_bytes_port    per-rank argument bytes in the port's layout (every
                    weight whole but the MoE experts; data-parallel inputs)
  out_bytes_port    per-rank output bytes of the run
  fits_80gb         arguments + outputs of the port's layout within one
                    H100's 80 GB (a lower bound on its peak: activations
                    and temporaries are not counted)
  flops             FLOPs of the run (``FlopCounterMode``)
  hbm_bytes         bytes every operator reads and writes (no fusion: the
                    analogue of XLA's "bytes accessed")
  collective_bytes / collective_counts
                    by kind, counted where the port calls ``torch.
                    distributed`` (output bytes, as the JAX package counts
                    them), each with its group's ranks for the roofline
  roofline          compute / memory / collective seconds on H100 ranks
                    (`repro_torch.launch.roofline`) and the dominant term

A cell whose shape has a ``skip_reason`` is written as skipped; ``--all``
runs each cell in a subprocess and writes a failed one as an error with
its stderr, as the JAX package's sweep does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import roofline as R

MESH_RANKS = {"single": 256, "multi": 512}


def init_fake_world(n_ranks: int, rank: int = 0) -> None:
    """This process as rank ``rank`` of a ``fake`` process group of
    ``n_ranks`` (collectives return at once, moving nothing); a group of
    another size is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n_ranks and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", world_size=n_ranks, rank=rank,
                            store=FakeStore())


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor in a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__
                for t in _tensors(getattr(tree, f))]
    return []


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def rules_arg_bytes(cell) -> Tuple[int, List[dict]]:
    """(per-rank argument bytes in the rules' layout, a record a leaf:
    path, whole shape, dtype, its bytes an element, block shape)."""
    from repro_torch.launch.inputs import arg_leaves, rules_block_shape

    total, leaves = 0, []
    for i, (log, arg) in enumerate(zip(cell.logical, cell.args)):
        for path, lg, x in arg_leaves(log, arg, f"[{i}]"):
            blk = rules_block_shape(cell.ctx, lg, x)
            n = 1
            for d in blk:
                n *= d
            total += n * x.element_size()
            leaves.append({"path": path, "shape": list(x.shape),
                           "dtype": str(x.dtype).replace("torch.", ""),
                           "itemsize": x.element_size(),
                           "block": list(blk)})
    return total, leaves


class _Bytes(TorchDispatchMode):
    """Bytes every operator reads and writes: its tensor inputs and
    outputs, views and aliases left out."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not any(r.alias_info is not None for r in func._schema.returns):
            self.total += tree_bytes(list(args) + list((kwargs or {})
                                                      .values()))
            self.total += tree_bytes(out)
        return out


@contextlib.contextmanager
def _count_collectives(records: list):
    """Record (kind, output bytes, group ranks) of every all-gather,
    all-to-all and all-reduce issued inside the block."""
    real = {"all_gather": dist.all_gather,
            "all_to_all_single": dist.all_to_all_single,
            "all_reduce": dist.all_reduce}

    def ranks(group):
        return dist.get_process_group_ranks(group or dist.group.WORLD)

    def all_gather(parts, x, group=None, **kw):
        records.append(("all-gather", tree_bytes(parts), ranks(group)))
        return real["all_gather"](parts, x, group=group, **kw)

    def all_to_all_single(out, x, *a, group=None, **kw):
        records.append(("all-to-all", tree_bytes(out), ranks(group)))
        return real["all_to_all_single"](out, x, *a, group=group, **kw)

    def all_reduce(x, *a, group=None, **kw):
        records.append(("all-reduce", tree_bytes(x), ranks(group)))
        return real["all_reduce"](x, *a, group=group, **kw)

    dist.all_gather, dist.all_to_all_single, dist.all_reduce = (
        all_gather, all_to_all_single, all_reduce)
    try:
        yield
    finally:
        (dist.all_gather, dist.all_to_all_single,
         dist.all_reduce) = real.values()


def measure(cell) -> dict:
    """Run ``cell.fn`` on its local arguments under the FLOP counter, the
    byte counter and the collective tally."""
    records: list = []
    flops = FlopCounterMode(display=False)
    nbytes = _Bytes()
    t0 = time.perf_counter()
    with _count_collectives(records), flops, nbytes:
        out = cell.fn(*cell.local_args)
    coll = {k: 0 for k in R.COLLECTIVES}
    counts = {k: 0 for k in R.COLLECTIVES}
    for kind, b, _ in records:
        coll[kind] += b
        counts[kind] += 1
    return {"flops": float(flops.get_total_flops()),
            "hbm_bytes": float(nbytes.total),
            "out_bytes": tree_bytes(out),
            "collective_bytes": coll, "collective_counts": counts,
            "collective_total_bytes": sum(coll.values()),
            "collective_s": R.collective_seconds(records),
            "run_s": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch.inputs import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    shape = get_arch(arch).SHAPES[shape_name]
    if shape.skip_reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": shape.skip_reason}
    n_ranks = MESH_RANKS[mesh_kind]
    init_fake_world(n_ranks)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type="cpu")
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, mesh)
    t_build = time.perf_counter() - t0
    rules_bytes, leaves = rules_arg_bytes(cell)
    port_bytes = tree_bytes(cell.local_args)
    m = measure(cell)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "n_ranks": n_ranks, "rank": dist.get_rank(),
        "build_s": t_build, "run_s": m["run_s"],
        "arg_bytes_rules": rules_bytes, "arg_bytes_port": port_bytes,
        "out_bytes_port": m["out_bytes"],
        "fits_80gb": port_bytes + m["out_bytes"] <= R.HBM_BYTES,
        "flops": m["flops"], "hbm_bytes": m["hbm_bytes"],
        "collective_bytes": m["collective_bytes"],
        "collective_counts": m["collective_counts"],
        "collective_total_bytes": m["collective_total_bytes"],
        "roofline": R.roofline(m["flops"], m["hbm_bytes"], m["collective_s"],
                               n_ranks),
        "meta": cell.meta, "leaves": leaves,
    }


def _result_path(outdir, arch, shape, mesh_kind):
    return os.path.join(outdir, f"{arch}__{shape}__{mesh_kind}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run every (arch x shape x mesh) cell of the port on "
                    "meta tensors as one rank of a fake 256- or 512-rank "
                    "world; write per-rank bytes, FLOPs, collectives and "
                    "the H100 roofline terms.")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=list(MESH_RANKS), default="single")
    ap.add_argument("--all", action="store_true",
                    help="sweep every cell x mesh in subprocesses")
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    if args.all:
        from repro_torch.configs import get_arch, list_archs
        failures = skipped = 0
        for arch in list_archs():
            for shape in get_arch(arch).SHAPES:
                for mesh_kind in MESH_RANKS:
                    path = _result_path(args.outdir, arch, shape, mesh_kind)
                    if os.path.exists(path) and not args.force:
                        print(f"[dryrun] cached  {arch} x {shape} x "
                              f"{mesh_kind}")
                        continue
                    print(f"[dryrun] running {arch} x {shape} x "
                          f"{mesh_kind} ...", flush=True)
                    r = subprocess.run(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, "--shape", shape, "--mesh",
                         mesh_kind, "--outdir", args.outdir, "--quiet"],
                        capture_output=True, text=True)
                    if r.returncode != 0:
                        failures += 1
                        with open(path, "w") as f:
                            json.dump({"arch": arch, "shape": shape,
                                       "mesh": mesh_kind, "status": "error",
                                       "stderr": r.stderr[-4000:],
                                       "stdout": r.stdout[-1000:]}, f,
                                      indent=2)
                        print(f"[dryrun]   FAILED (see {path})")
                    elif "skipped" in r.stdout:
                        skipped += 1
                        print("[dryrun]   skipped")
                    else:
                        print("[dryrun]   ok")
        print(f"[dryrun] sweep done, {failures} failures, {skipped} skipped")
        sys.exit(1 if failures else 0)

    rec = run_cell(args.arch, args.shape, args.mesh)
    with open(_result_path(args.outdir, args.arch, args.shape, args.mesh),
              "w") as f:
        json.dump(rec, f, indent=2)
    if args.quiet:
        print(f"[dryrun] {args.arch} x {args.shape} x {args.mesh}: "
              f"{rec['status']}")
    else:
        print(json.dumps({k: v for k, v in rec.items() if k != "leaves"},
                         indent=2))


if __name__ == "__main__":
    main()
