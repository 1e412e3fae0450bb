"""Progressive search over a row-sharded corpus: the port of
``src/repro/core/distributed.py``.

The (N, D) corpus is split by rows over the ``db_axes`` of a mesh (``data``,
or ``('pod', 'data')``); rank i of those axes holds rows [i·N/S, (i+1)·N/S).
The global top-k of stage 0 lies in the union of the shards' top-k, and
every later stage only shrinks each candidate set, so each shard runs the
whole pipeline on its own slab and only (Q, k) (score, id) pairs cross
ranks.  There is no ``shard_map``: the search function runs SPMD, every
rank of the process group calling it with its own slab, and the merge is an
explicit all-gather (`repro_torch.sharding.collectives`).

Two modes:

* ``mode='local'`` (default) — each shard's full pipeline, then one merge.
  On CUDA tensors that is the stage-0 kernel and the one-launch rescore
  ladder on every rank.
* ``mode='global'`` — after stage 0 the shards' candidates are merged and
  every shard refines the same global candidate set: each rescores the
  candidates it owns (the others are -1 slots), and the shards' results
  are merged again at every stage (the paper's semantics across the whole
  corpus).  On CUDA tensors each stage is one launch of the rescore kernel.

A merge takes the k smallest of the gathered (Q, S·k) scores in
``lax.top_k``'s (score, position) order, so ties fall as in the JAX
package; a -1 id stays -1 with its +inf score.

``build_sharded_search_staged`` is the staged index layout: each shard
keeps its rows' stage-0 prefix as a separate (rows, Ds) bfloat16 block
beside the full-precision rows, scans that block at stage 0 (the bf16
route of the stage-0 kernel on CUDA tensors: exact products, float32
sums, half the row bytes), rescores from the float32 rows and merges once.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.index import lookup_prefix
from repro_torch.core.progressive import _topk_first, progressive_search
from repro_torch.core.schedule import ProgressiveSchedule
from repro_torch.kernels import ops
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import mesh_axes

Tensor = torch.Tensor


def _merge_final(scores: Tensor, cand: Tensor, mesh, axes,
                 offset: int) -> Tuple[Tensor, Tensor]:
    """All-gather every shard's (Q, k) results and take the global top-k.

    One gather: the int32 ids ride beside the float32 scores as their bit
    patterns (a gather copies bytes), so a merge costs one collective."""
    cand_g = torch.where(cand >= 0, cand + offset, torch.full_like(cand, -1))
    both = torch.stack([scores.to(torch.float32),
                        cand_g.to(torch.int32).view(torch.float32)], dim=-1)
    gathered = C.all_gather(both, mesh, axes, dim=1)     # (Q, S, k, 2)
    all_s = gathered[..., 0]
    all_i = gathered[..., 1].contiguous().view(torch.int32)
    q_, s_, k_ = all_s.shape
    top, pos = _topk_first(all_s.reshape(q_, s_ * k_), k_)
    return top, torch.gather(all_i.reshape(q_, s_ * k_), 1, pos)


def build_sharded_search(
    mesh,
    sched: ProgressiveSchedule,
    n: int,
    *,
    db_axes: Tuple[str, ...] = ("data",),
    has_prefix: bool = False,
    index_dims: Optional[tuple] = None,
    block_n: int = 16384,
    metric: str = "l2",
    mode: str = "local",
):
    """The search callable ``fn(q, db_local, sq_prefix_local)`` for a corpus
    of ``n`` rows sharded over ``db_axes``, called by every rank of the
    mesh: ``q`` (Q, D) the same on every rank, ``db_local`` this rank's
    (n / shards, D) slab, ``sq_prefix_local`` its prefix norms (ignored
    unless ``has_prefix``).  Returns ((Q, final_k) scores, (Q, final_k)
    int32 global ids), the same on every rank.  Building it makes the
    gather's process groups, so every rank builds it at the same point."""
    if mode not in ("local", "global"):
        raise ValueError(f"unknown mode {mode!r}")
    sizes = mesh_axes(mesh)
    n_shards = math.prod(sizes[a] for a in db_axes)
    if n % n_shards:
        raise ValueError(f"corpus rows {n} not divisible by {n_shards} shards")
    rows_local = n // n_shards
    axes = tuple(db_axes)
    offset = C.axis_index(mesh, axes) * rows_local
    C.axis_group(mesh, axes)
    dims = index_dims

    def merge(s, c):
        return _merge_final(s, c, mesh, axes, offset)

    def fn(q: Tensor, db_l: Tensor, sqp_l: Optional[Tensor] = None):
        if db_l.shape[0] != rows_local:
            raise ValueError(f"this rank's slab has {db_l.shape[0]} rows, "
                             f"not {rows_local} (= {n} / {n_shards})")
        if not has_prefix:
            sqp_l = None
        bn = min(block_n, rows_local)
        if mode == "local":
            s, c = progressive_search(q, db_l, sched, sq_prefix=sqp_l,
                                      index_dims=dims, block_n=bn,
                                      metric=metric)
            return merge(s, c)
        s0 = sched.stages[0]
        s, c = ops.truncated_search(
            q, db_l, dim=s0.dim, k=s0.k,
            db_sq_at_dim=lookup_prefix(sqp_l, dims, s0.dim), block_n=bn,
            metric=metric)
        s, c = merge(s, c)                                  # global (Q, k0)
        for stage in sched.stages[1:]:
            mine = (c >= offset) & (c < offset + rows_local)
            local_c = torch.where(mine, c - offset, torch.full_like(c, -1))
            s_l, c_l = ops.rescore_candidates(
                q, db_l, local_c, dim=stage.dim,
                k=min(stage.k, local_c.shape[1]),
                db_sq_at_dim=lookup_prefix(sqp_l, dims, stage.dim),
                metric=metric)
            s, c = merge(s_l, c_l)
            s, c = s[:, :stage.k], c[:, :stage.k]
        return s, c

    return fn


def build_sharded_search_staged(
    mesh,
    sched: ProgressiveSchedule,
    n: int,
    *,
    db_axes: Tuple[str, ...] = ("data",),
    dtype_wire: torch.dtype = torch.bfloat16,
):
    """The search callable ``fn(q, db0_local, db_local, sqp_local)`` over a
    staged index of ``n`` rows sharded over ``db_axes``, called by every
    rank of the mesh (the JAX package's function of the same name).

      q:         (Q, D) float32 queries, the same on every rank;
      db0_local: this rank's (n / shards, Ds) stage-0 block in
                 ``dtype_wire`` (Ds >= the schedule's first dim);
      db_local:  this rank's (n / shards, D) float32 rows;
      sqp_local: (n / shards, 1) float32 squared norms of the block's rows
                 at the first stage's dim.

    Stage 0 scans the block with q cast to ``dtype_wire`` (k0 candidates a
    shard: a shard of fewer live rows gives (+inf, -1) slots), every later
    stage rescores this shard's candidates from the float32 rows with their
    norms computed there, and one merge ends it.  Returns ((Q, final_k)
    scores, (Q, final_k) int32 global ids), the same on every rank.
    Building it makes the gather's process groups, so every rank builds it
    at the same point."""
    sizes = mesh_axes(mesh)
    n_shards = math.prod(sizes[a] for a in db_axes)
    if n % n_shards:
        raise ValueError(f"corpus rows {n} not divisible by {n_shards}")
    rows_local = n // n_shards
    axes = tuple(db_axes)
    offset = C.axis_index(mesh, axes) * rows_local
    C.axis_group(mesh, axes)
    s0 = sched.stages[0]

    def fn(q: Tensor, db0_l: Tensor, db_l: Tensor, sqp_l: Tensor):
        if db0_l.shape[0] != rows_local or db_l.shape[0] != rows_local:
            raise ValueError(f"this rank's blocks have {db0_l.shape[0]} and "
                             f"{db_l.shape[0]} rows, not {rows_local} "
                             f"(= {n} / {n_shards})")
        s, c = ops.truncated_search(
            q.to(dtype_wire), db0_l, dim=s0.dim, k=s0.k,
            db_sq_at_dim=sqp_l[:, 0], block_n=rows_local)
        for stage in sched.stages[1:]:
            s, c = ops.rescore_candidates(q, db_l, c, dim=stage.dim,
                                          k=stage.k)
        return _merge_final(s, c, mesh, axes, offset)

    return fn


def sharded_progressive_search(
    mesh,
    q: Tensor,
    db: Tensor,
    sched: ProgressiveSchedule,
    *,
    db_axes: Tuple[str, ...] = ("data",),
    sq_prefix: Optional[Tensor] = None,
    index_dims: Optional[tuple] = None,
    block_n: int = 16384,
    metric: str = "l2",
    mode: str = "local",
) -> Tuple[Tensor, Tensor]:
    """Progressive search with the corpus row-sharded over ``db_axes``.

    Called by every rank of ``mesh`` with the same arguments, as the JAX
    function is called once: ``q`` (Q, D) queries, ``db`` the whole (N, D)
    corpus (and ``sq_prefix`` its (N, n_dims) prefix norms), of which each
    rank searches its own rows (a view, no copy).  N must divide evenly by
    the product of the ``db_axes`` sizes.  A corpus too large for one rank
    goes through `build_sharded_search` with each rank's slab.

    Returns ((Q, final_k) scores, (Q, final_k) int32 global indices), the
    same on every rank.
    """
    n = db.shape[0]
    fn = build_sharded_search(
        mesh, sched, n, db_axes=db_axes, has_prefix=sq_prefix is not None,
        index_dims=index_dims, block_n=block_n, metric=metric, mode=mode)
    rows = n // math.prod(mesh_axes(mesh)[a] for a in db_axes)
    lo = C.axis_index(mesh, tuple(db_axes)) * rows
    sqp = None if sq_prefix is None else sq_prefix[lo:lo + rows]
    return fn(q, db[lo:lo + rows], sqp)
