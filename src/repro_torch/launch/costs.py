"""Per-rank cost totals of an LM cell for the roofline: the port of
``src/repro/launch/costs.py``.

    PYTHONPATH=src python -m repro_torch.launch.costs \\
        --arch mistral-nemo-12b --shape train_4k

The JAX package compiles one layer of each structurally distinct kind and
composes the totals, because XLA's cost analysis counts a scanned layer
once.  The port runs eagerly, so nothing is hidden in a loop:

  * FLOPs: ``FlopCounterMode`` over the whole step on meta tensors, as one
    rank of the 16 x 16 mesh (`repro_torch.launch.dryrun.measure`): every
    layer, the head and the loss, the backward and the optimizer;
  * collectives: every one the step issues, by kind;
  * HBM bytes as the JAX package defines them (``costs._measure``'s
    "boundary" term): the arguments plus outputs of each layer — what a
    fully fused layer must read and write — times its count, plus the
    embedding / head / loss program, plus (train) the optimizer update over
    the whole tree.  The bytes are this rank's in the port's layout: its
    rows of the batch, the weights whole but its E/ep experts.

Both layouts' per-rank argument bytes come with it, from the dry run.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import torch

from repro_torch.launch import roofline as R
from repro_torch.launch.dryrun import _tensors, tree_bytes

_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _lm_layer_groups(cfg) -> List[Tuple[int, bool, int]]:
    """(count, moe layer, window) of each structurally distinct layer
    kind, in first-seen order."""
    n_dense = cfg.moe.first_k_dense if cfg.moe is not None else 0
    groups: Dict[Tuple[bool, int], int] = {}
    for l in range(cfg.n_layers):
        key = (cfg.moe is not None and l >= n_dense, cfg.layer_window(l))
        groups[key] = groups.get(key, 0) + 1
    return [(n,) + key for key, n in groups.items()]


def boundary_bytes(cfg, kind: str, rows: int, seq: int, params,
                   cache=None) -> float:
    """The JAX package's per-layer boundary bytes of a step of ``kind`` on
    ``rows`` sequences of ``seq`` tokens, with this rank's ``params`` (a
    `param_tree` in the port's layout) and, for decode, its ``cache``."""
    from repro_torch.layers.common import dtype_of

    cdt = _BYTES[dtype_of(cfg.compute_dtype)]
    d = cfg.d_model
    s = seq if kind in ("train", "prefill") else 1
    x = rows * s * d * cdt
    # one layer's weights: a stack's bytes over its layers (MoE layers in
    # "layers" after DeepSeek's dense prefix in "dense_layers")
    n_dense = cfg.moe.first_k_dense if cfg.moe is not None else 0
    stack = tree_bytes(params["layers"]) / (cfg.n_layers - n_dense)
    per_layer = {cfg.moe is not None: stack}
    if n_dense:
        per_layer[False] = tree_bytes(params["dense_layers"]) / n_dense
    total = 0.0
    for n, moe_layer, window in _lm_layer_groups(cfg):
        p = per_layer[moe_layer]
        if kind == "train":
            one = 2 * (p + x)                  # (p, x) in, (dp, dx) out
        elif kind == "prefill":
            if cfg.mla is not None:
                kv = rows * seq * (cfg.mla.kv_lora_rank + cfg.mla.d_rope)
            else:
                kv = rows * seq * 2 * cfg.n_kv_heads * cfg.d_head
            one = p + 2 * x + kv * cdt         # (p, x) in, (y, kv) out
        else:
            one = p + 2 * x + 2 * _layer_cache_bytes(cfg, cache, window)
        total += n * one
    embed = tree_bytes(params["embed"])
    if kind == "train":
        tokens = rows * (seq + 1) * 4
        total += 2 * embed + tokens            # (embed, tokens) -> d embed
        # the optimizer over the tree: (p, g, mu, nu) in, (p, mu, nu) out
        # (g as the parameters, as the JAX package measures it)
        moments = 2 * sum(t.numel() * 4 for t in _tensors(params))
        total += 3 * tree_bytes(params) + 2 * moments
    else:
        total += embed + rows * s * 4 + rows * cfg.vocab * 4
    return total


def _layer_cache_bytes(cfg, cache, window: int) -> float:
    """Bytes of one layer's decode cache (a ring cache for a local layer
    of a local:global config)."""
    if cfg.mla is not None:
        return (tree_bytes(cache["ckv"]) + tree_bytes(cache["krope"])) \
            / cfg.n_layers
    if cfg.local_global_period > 0:
        part = "local" if window > 0 else "global"
        k = cache[f"k_{part}"]
        return 2 * tree_bytes(k) / max(k.shape[0], 1)
    return (tree_bytes(cache["k"]) + tree_bytes(cache["v"])) / cfg.n_layers


def exact_lm_costs(arch: str, shape_name: str, *, cfg=None,
                   shape=None) -> dict:
    """Per-rank totals of an LM cell on the 16 x 16 mesh: FLOPs, boundary
    HBM bytes, collectives and the roofline.  ``cfg`` / ``shape`` replace
    the architecture's ``CONFIG`` and the named shape (a smaller model)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, inputs
    from repro_torch.launch.mesh import make_production_mesh

    mod = get_arch(arch)
    dryrun.init_fake_world(dryrun.MESH_RANKS["single"])
    mesh = make_production_mesh(device_type="cpu")
    cfg = cfg or mod.CONFIG
    shape = shape or mod.SHAPES[shape_name]
    cell = inputs.lm_cell(cfg, shape, mesh)
    m = dryrun.measure(cell)
    kind = shape.kind
    cache = cell.local_args[1] if kind == "decode" else None
    # this rank's rows: the train step cuts its own from the whole batch
    tokens = cell.local_args[{"train": 2, "prefill": 1, "decode": 2}[kind]]
    if kind == "train":
        tokens = cell.ctx.local_block(tokens["tokens"], ("batch", None))
    rows = tokens.shape[0]
    hbm = boundary_bytes(cfg, kind, rows, shape.seq_len, cell.local_args[0],
                         cache)
    rules, _ = dryrun.rules_arg_bytes(cell)
    return {
        "flops": m["flops"], "hbm_bytes": hbm,
        "hbm_bytes_unfused": m["hbm_bytes"],
        "collective_bytes": m["collective_bytes"],
        "collective_counts": m["collective_counts"],
        "coll_total": m["collective_total_bytes"],
        "arg_bytes_rules": rules,
        "arg_bytes_port": dryrun.tree_bytes(cell.local_args),
        "rows": rows,
        "roofline": R.roofline(m["flops"], hbm, m["collective_s"],
                               dryrun.MESH_RANKS["single"]),
        "method": "whole-step FLOP count, per-layer boundary bytes",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Per-rank FLOPs, boundary HBM bytes, collectives and "
                    "the H100 roofline of an LM cell on the 16 x 16 mesh.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--outdir", default="results/costs_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    rec = exact_lm_costs(args.arch, args.shape)
    rec["arch"], rec["shape"] = args.arch, args.shape
    with open(os.path.join(args.outdir, f"{args.arch}__{args.shape}.json"),
              "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec["roofline"], indent=2))


if __name__ == "__main__":
    main()
