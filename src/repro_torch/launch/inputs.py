"""Per-(architecture x shape) dry-run cells: the port of
``src/repro/launch/inputs.py``.

``build_cell(arch, shape_name, mesh)`` returns what the dry run
(`repro_torch.launch.dryrun`) needs, with nothing allocated: every tensor
lies on ``torch.device("meta")``, made by the port's real initialisers.

    fn          the port's function: a train step, ``prefill``,
                ``decode_step``, a serve function or the retrieval search
    args        whole-shape stand-ins of its inputs, leaf for leaf the JAX
                package's ``input_specs`` (same tree, shapes and dtypes)
    logical     each input's logical-axes tree; with ``ctx`` (the JAX
                package's rules and its per-cell overrides) it gives each
                leaf's block in the rules' layout, which GSPMD runs there
    local_args  what ``fn`` takes on one rank in the port's layout: the
                weights whole but the MoE experts, cut to this rank's E/ep
                (`ShardingCtx.held_blocks`), and the optimizer state alike;
                a train step's batch whole (the step takes its own rows);
                prefill and decode inputs this rank's rows of the batch
                (data-parallel replicas); the retrieval DB this rank's
                rows; a graph whole
    meta        kind, tokens / examples / candidates, the schedule

The optimizer state's step is a CPU scalar and ``pos`` a CPU int32
scalar: the port reads both as Python numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import family_of, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.distributed import build_sharded_search_staged
from repro_torch.core.schedule import make_schedule
from repro_torch.models import egnn as EG
from repro_torch.models import lm as LM
from repro_torch.models import recsys as RS
from repro_torch.models.graph import Graph
from repro_torch.optim.adamw import OptState, opt_state_logical
from repro_torch.sharding.specs import (ShardingCtx, _map_logical, make_ctx,
                                        mesh_axes)
from repro_torch.train.loop import make_train_step

META = torch.device("meta")


class Cell(NamedTuple):
    fn: Callable
    args: tuple
    logical: tuple
    ctx: ShardingCtx
    local_args: tuple
    donate_argnums: tuple
    meta: Dict[str, Any]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _whole_opt(params) -> OptState:
    """``adamw_init`` of meta parameters, its step a CPU scalar."""
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, list):
            return [zeros(v) for v in t]
        return _sds(t.shape, torch.float32)

    return OptState(torch.zeros((), dtype=torch.int32), zeros(params),
                    zeros(params))


def _rows(ctx: ShardingCtx, logical: tuple, x: torch.Tensor,
          names=("batch", "rows")) -> torch.Tensor:
    """``x``'s block of this rank over its ``names`` dims only (the port's
    data-parallel split of inputs)."""
    keep = tuple(n if n in names else None for n in logical)
    return ctx.local_block(x, keep)


# ------------------------------------------------------------------ LM ----

_LM_RULES_BY_KIND = {
    "train": {"seq_act": ("model",)},
    "prefill": {"seq_act": ("model",), "kv_seq": ("model",)},
    "decode": {"kv_seq": ("model",)},
    "decode_long": {"kv_seq": ("pod", "data", "model"), "batch": ()},
}

# the JAX package's size-aware FSDP rule: bf16 params + bf16 grads + fp32
# moments = 12 bytes a parameter over 'model' alone, against a 12 GB
# budget (its TPU's HBM)
_FSDP_BYTES_PER_PARAM = 12
_FSDP_HBM_BUDGET = 12e9


def lm_rules_for(cfg, kind: str, mesh) -> dict:
    """The JAX package's rule overrides of an LM cell (``lm_rules_for``):
    a train cell whose state fits over ``model`` alone drops ``embed ->
    data``."""
    rules = dict(_LM_RULES_BY_KIND[kind])
    n_model = mesh_axes(mesh).get("model", 1)
    state_bytes = cfg.param_count() * _FSDP_BYTES_PER_PARAM / n_model
    if kind == "train" and state_bytes < _FSDP_HBM_BUDGET:
        rules["embed"] = ()
    return rules


def lm_cell(cfg, shape: ShapeSpec, mesh) -> Cell:
    """The cell of the LM ``cfg`` at ``shape`` (``_lm_cell``'s, for any
    config: the cost model's smoke runs)."""
    kind = shape.kind
    if kind == "decode" and shape.seq_len >= 262144:
        rules = _LM_RULES_BY_KIND["decode_long"]
    else:
        rules = lm_rules_for(cfg, kind, mesh)
    ctx = make_ctx(mesh, rules)
    params = LM.param_tree(LM.init_lm(cfg, device=META))
    logical = LM.lm_param_logical(cfg)
    held = ctx.held_blocks(logical, params)

    if kind == "train":
        opt = _whole_opt(params)
        olog = opt_state_logical(logical)
        b, s = shape.global_batch, shape.seq_len
        batch = {"tokens": _sds((b, s + 1), torch.int32)}
        blog = {"tokens": ("batch", None)}
        step = make_train_step(
            lambda p, bt: LM.lm_loss(LM.lm_view(p, cfg), bt, ctx=ctx),
            ctx=ctx, grad_dtype="bfloat16",
            held_axes=ctx.held_axes(logical, params))
        return Cell(
            fn=step, args=(params, opt, batch), logical=(logical, olog, blog),
            ctx=ctx, local_args=(held, ctx.held_blocks(olog, opt), batch),
            donate_argnums=(0, 1),
            meta={"kind": "train", "tokens": b * s})

    if kind == "prefill":
        tokens = _sds((shape.global_batch, shape.seq_len), torch.int32)
        tlog = ("batch", None)

        def fn(p, t):
            return LM.prefill(LM.lm_view(p, cfg), t, ctx=ctx)

        return Cell(
            fn=fn, args=(params, tokens), logical=(logical, tlog), ctx=ctx,
            local_args=(held, _rows(ctx, tlog, tokens)), donate_argnums=(),
            meta={"kind": "prefill",
                  "tokens": shape.global_batch * shape.seq_len})

    cache = LM.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device=META)
    clog = LM.cache_logical(cfg)
    tokens = _sds((shape.global_batch, 1), torch.int32)
    tlog = ("batch", None)
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)

    def fn(p, c, t, pos):
        return LM.decode_step(LM.lm_view(p, cfg), c, t, int(pos), ctx=ctx)

    local_cache = _map_logical(lambda log, x: _rows(ctx, log, x), clog, cache)
    return Cell(
        fn=fn, args=(params, cache, tokens, pos),
        logical=(logical, clog, tlog, ()), ctx=ctx,
        local_args=(held, local_cache, _rows(ctx, tlog, tokens), pos),
        donate_argnums=(1,),
        meta={"kind": "decode", "tokens": shape.global_batch})


# ----------------------------------------------------------------- GNN ----

_GRAPH_LOGICAL = Graph(
    nodes=("nodes", None), coords=("nodes", None), senders=("edges",),
    receivers=("edges",), edge_attr=("edges", None), node_mask=("nodes",),
    edge_mask=("edges",), labels=("nodes",))


def _gnn_cell(arch: str, shape: ShapeSpec, mesh) -> Cell:
    base = get_arch(arch).CONFIG
    ctx = make_ctx(mesh)
    if shape.name == "minibatch_lg":
        f = shape.fanout
        n_nodes = shape.batch_nodes * (1 + f[0] + f[0] * f[1])
        n_edges = shape.batch_nodes * f[0] + shape.batch_nodes * f[0] * f[1]
    elif shape.name == "molecule":
        n_nodes = shape.graph_batch * shape.n_nodes
        n_edges = shape.graph_batch * shape.n_edges
    else:
        n_nodes, n_edges = shape.n_nodes, shape.n_edges
    d_feat = shape.d_feat
    cfg = dataclasses.replace(base, d_feat_in=d_feat)
    params = EG.param_tree(EG.egnn_init(cfg, device=META))
    logical = EG.egnn_param_logical(cfg)
    opt = _whole_opt(params)
    olog = opt_state_logical(logical)
    nodes, edges = _round_up(n_nodes, 512), _round_up(n_edges, 512)
    g = Graph(
        nodes=_sds((nodes, d_feat), torch.float32),
        coords=_sds((nodes, 3), torch.float32),
        senders=_sds((edges,), torch.int32),
        receivers=_sds((edges,), torch.int32),
        edge_attr=_sds((edges, 0), torch.float32),
        node_mask=_sds((nodes,), torch.bool),
        edge_mask=_sds((edges,), torch.bool),
        labels=_sds((nodes,), torch.int32))
    step = make_train_step(lambda p, b: EG.egnn_loss(p, b, cfg), ctx=ctx)
    return Cell(
        fn=step, args=(params, opt, g), logical=(logical, olog,
                                                  _GRAPH_LOGICAL),
        ctx=ctx, local_args=(params, opt, g), donate_argnums=(0, 1),
        meta={"kind": "train", "edges": n_edges, "nodes": n_nodes})


# -------------------------------------------------------------- recsys ----

def _recsys_batch(cfg, batch: int) -> Tuple[dict, dict]:
    b = {}
    if cfg.family == "two_tower":
        nf = max(cfg.n_sparse // 2, 1)
        b["user_ids"] = _sds((batch, nf, cfg.multi_hot), torch.int32)
        b["item_ids"] = _sds((batch, nf, cfg.multi_hot), torch.int32)
    elif cfg.family == "din":
        b["hist"] = _sds((batch, cfg.seq_len), torch.int32)
        b["target"] = _sds((batch,), torch.int32)
        b["label"] = _sds((batch,), torch.float32)
    else:
        b["ids"] = _sds((batch, cfg.n_sparse, cfg.multi_hot), torch.int32)
        b["label"] = _sds((batch,), torch.float32)
        if cfg.family == "dlrm":
            b["dense"] = _sds((batch, cfg.n_dense), torch.float32)
    return b, {k: ("batch",) + (None,) * (v.dim() - 1) for k, v in b.items()}


def two_tower_retrieval(cfg, mesh, c: int):
    """(fn, schedule) of the two-tower ``retrieval_cand`` cell over ``c``
    items: ``fn(params, user_ids, db0, db, sqp)`` runs the user tower,
    casts its output to float32 and runs the staged search over this
    rank's rows of the (c, Ds) bf16 block, the (c, d) float32 item DB and
    their (c, 1) stage-0 norms, the rows split over the mesh's batch axes
    (the JAX package's cell function)."""
    d_emb = cfg.tower_mlp[-1]
    sched = make_schedule(cfg.retrieval_d_start, d_emb, cfg.retrieval_k0)
    search = build_sharded_search_staged(mesh, sched, c,
                                         db_axes=_batch_axes(mesh))

    def fn(params, user_ids, db0, db, sqp):
        q = RS.tower_user(params, user_ids).float()
        return search(q, db0, db, sqp)

    return fn, sched


def _recsys_cell(arch: str, shape: ShapeSpec, mesh) -> Cell:
    cfg = get_arch(arch).CONFIG
    ctx = make_ctx(mesh)
    params = RS.param_tree(RS.recsys_init(cfg, device=META))
    logical = RS.recsys_param_logical(cfg, params)

    if shape.name == "train_batch":
        opt = _whole_opt(params)
        olog = opt_state_logical(logical)
        batch, blog = _recsys_batch(cfg, shape.global_batch)
        step = make_train_step(lambda p, b: RS.recsys_loss(p, b, cfg),
                               ctx=ctx)
        return Cell(
            fn=step, args=(params, opt, batch), logical=(logical, olog, blog),
            ctx=ctx, local_args=(params, opt, batch), donate_argnums=(0, 1),
            meta={"kind": "train", "examples": shape.global_batch})

    if shape.name in ("serve_p99", "serve_bulk"):
        batch, blog = _recsys_batch(cfg, shape.global_batch)
        if cfg.family == "two_tower":
            def fn(p, b):
                u = RS.tower_user(p, b["user_ids"])
                v = RS.tower_item(p, b["item_ids"])
                return (u * v).sum(-1)
        else:
            def fn(p, b):
                return RS.recsys_forward(p, b, cfg)
        local = _map_logical(lambda log, x: _rows(ctx, log, x), blog, batch)
        return Cell(
            fn=fn, args=(params, batch), logical=(logical, blog), ctx=ctx,
            local_args=(params, local), donate_argnums=(),
            meta={"kind": "serve", "examples": shape.global_batch})

    c = shape.n_candidates
    if cfg.family == "two_tower":
        # the paper's search over the item DB, with the staged index: the
        # stage-0 prefix a contiguous (C, Ds) bf16 block
        fn, sched = two_tower_retrieval(cfg, mesh, c)
        nf = max(cfg.n_sparse // 2, 1)
        user_ids = _sds((8, nf, cfg.multi_hot), torch.int32)
        db0 = _sds((c, sched.stages[0].dim), torch.bfloat16)
        db = _sds((c, cfg.tower_mlp[-1]), torch.float32)
        sqp = _sds((c, 1), torch.float32)
        rows = ("rows", None)
        args = (params, user_ids, db0, db, sqp)
        return Cell(
            fn=fn, args=args,
            logical=(logical, (None,) * user_ids.dim(), rows, rows, rows),
            ctx=ctx,
            local_args=(params, user_ids) + tuple(
                _rows(ctx, rows, x) for x in (db0, db, sqp)),
            donate_argnums=(),
            meta={"kind": "retrieval", "candidates": c,
                  "schedule": sched.describe(), "staged_index": True})

    batch, blog = _recsys_batch(cfg, 1)
    batch.pop("label", None)
    blog.pop("label", None)
    cand = _sds((c,), torch.int32)

    def fn(p, b, cand):
        return RS.serve_candidates(p, b, cand, cfg)

    return Cell(
        fn=fn, args=(params, batch, cand), logical=(logical, blog, ("cand",)),
        ctx=ctx, local_args=(params, batch, cand), donate_argnums=(),
        meta={"kind": "retrieval", "candidates": c})


# ------------------------------------------------------------- factory ----

def build_cell(arch: str, shape_name: str, mesh) -> Optional[Cell]:
    """The cell, or None for a documented skip (``skip_reason``)."""
    shape = get_arch(arch).SHAPES[shape_name]
    if shape.skip_reason:
        return None
    fam = family_of(arch)
    if fam == "lm":
        return lm_cell(get_arch(arch).CONFIG, shape, mesh)
    if fam == "gnn":
        return _gnn_cell(arch, shape, mesh)
    return _recsys_cell(arch, shape, mesh)


def input_specs(arch: str, shape_name: str, mesh):
    """The whole-shape stand-ins of a cell's inputs (None for a skip)."""
    cell = build_cell(arch, shape_name, mesh)
    return None if cell is None else cell.args


def arg_leaves(logical, tree, prefix: str = "") -> List[tuple]:
    """[(path, logical names, leaf)] of an input tree in the JAX package's
    flatten order, each path as ``jax.tree_util.keystr`` prints it: dicts
    by sorted key (``['k']``), lists and tuples by index (``[i]``),
    ``NamedTuple`` fields by name (``.mu``), a ``Graph`` (a pytree node
    without keys there) by flat index (``[<flat index i>]``)."""
    if isinstance(logical, tuple) and all(
            isinstance(e, (str, type(None))) for e in logical):
        return [(prefix, logical, tree)]
    out = []
    if isinstance(logical, dict):
        for k in sorted(logical):
            out += arg_leaves(logical[k], tree[k], f"{prefix}['{k}']")
    elif isinstance(logical, Graph):
        for i, f in enumerate(dataclasses.fields(Graph)):
            out += arg_leaves(getattr(logical, f.name),
                              getattr(tree, f.name),
                              f"{prefix}[<flat index {i}>]")
    elif hasattr(logical, "_fields"):
        for f in logical._fields:
            out += arg_leaves(getattr(logical, f), getattr(tree, f),
                              f"{prefix}.{f}")
    else:
        for i, (lg, t) in enumerate(zip(logical, tree)):
            out += arg_leaves(lg, t, f"{prefix}[{i}]")
    return out


def rules_block_shape(ctx: ShardingCtx, logical, x) -> Tuple[int, ...]:
    """The shape of ``x``'s block on one rank in the rules' layout (the JAX
    package's ``NamedSharding.shard_shape``)."""
    if ctx.mesh is None or not logical:
        return tuple(x.shape)
    sizes = mesh_axes(ctx.mesh)
    shape = list(x.shape)
    for i, e in enumerate(ctx.spec(logical, tuple(x.shape))):
        if e is not None:
            for a in (e,) if isinstance(e, str) else e:
                shape[i] //= sizes[a]
    return tuple(shape)

