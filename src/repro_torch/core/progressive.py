"""Progressive Retrieval — the paper's contribution (§III.D).

Multi-stage search: stage 0 scans the *entire* database at a low truncated
dimensionality keeping K candidates per query; each later stage doubles the
dimensionality, halves K, and rescores only the surviving candidates; the
final stage runs at the target dimensionality on the remaining pool.  Early
stages are cheap (low dim) but touch everything; late stages are expensive
per row but touch almost nothing — total work collapses from O(N·D_max) to
O(N·D_start + Σ K_s·D_s).

Candidate sets are per query with fixed sizes per stage.  On CUDA tensors
stage 0 is the fused scan kernel and all later stages one launch of the
rescore-ladder kernel (`repro_torch.kernels.ops`); on CPU tensors both are
the plain versions.  ``progressive_search_plain`` runs the plain versions on any
device: it is the reference the kernels' results are checked against.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import truncated as T
from repro_torch.core.index import lookup_prefix
from repro_torch.core.schedule import ProgressiveSchedule
from repro_torch.kernels import ops

Tensor = torch.Tensor


def _progressive(search: Callable, impl, q, db, sched, *,
                 sq_prefix, index_dims, valid, block_n, metric, stage0_only):
    s0 = sched.stages[0]
    scores, cand = search(
        q, db,
        dim=s0.dim, k=s0.k,
        db_sq_at_dim=lookup_prefix(sq_prefix, index_dims, s0.dim),
        valid=valid,
        block_n=block_n, metric=metric,
    )
    if stage0_only:
        return scores, cand
    return impl.rescore_ladder(q, db, cand, sched.stages[1:],
                               sq_prefix=sq_prefix, index_dims=index_dims,
                               valid=valid, metric=metric, scores=scores)


def rescore_ladder(
    q: Tensor,
    db: Tensor,
    cand: Tensor,
    stages,
    *,
    sq_prefix: Optional[Tensor] = None,
    index_dims: Optional[tuple] = None,
    valid: Optional[Tensor] = None,
    metric: str = "l2",
    scores: Optional[Tensor] = None,
    impl=ops,
) -> Tuple[Tensor, Tensor]:
    """Rescore ``cand`` through ``stages`` — the refinement ladder every
    search path shares once it has a candidate table.

    ``scores`` is returned unchanged when ``stages`` is empty (degenerate
    single-stage schedules).  ``impl`` is `repro_torch.kernels.ops` (the
    whole ladder in one kernel launch on CUDA tensors) or ``ops.plain``
    (the plain step chained, on any device, for the ``*_plain`` reference
    entries).
    """
    return impl.rescore_ladder(q, db, cand, stages, sq_prefix=sq_prefix,
                               index_dims=index_dims, valid=valid,
                               metric=metric, scores=scores)


def progressive_search(
    q: Tensor,
    db: Tensor,
    sched: ProgressiveSchedule,
    *,
    sq_prefix: Optional[Tensor] = None,
    index_dims: Optional[tuple] = None,
    valid: Optional[Tensor] = None,
    block_n: int = 65536,
    metric: str = "l2",
    stage0_only: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Per-query progressive search.

    Args:
      q:          (Q, D) queries.
      db:         (N, D) documents.
      sched:      ProgressiveSchedule.
      sq_prefix:  optional (N, len(index_dims)) prefix squared norms
                  (``index['sq_prefix']`` from `repro_torch.core.index`).
      index_dims: tuple of dims matching sq_prefix's columns.
      valid:      optional (N,) bool row-validity mask (deleted / unpopulated
                  rows are unreturnable).
      block_n:    document tile for the plain stage-0 scan (the CUDA kernel
                  picks its own tiling).
      metric:     'l2' or 'cosine' ('cosine' only on CPU tensors).
      stage0_only: return the stage-0 (scores, candidates) without the
                  rescore ladder — the fenced-observability split point
                  (finish via ``rescore_ladder`` on ``stages[1:]``).

    Returns:
      (scores, indices): ((Q, final_k) float32, (Q, final_k) int32).
    """
    return _progressive(ops.truncated_search, ops, q, db,
                        sched, sq_prefix=sq_prefix, index_dims=index_dims,
                        valid=valid, block_n=block_n, metric=metric,
                        stage0_only=stage0_only)


def progressive_search_plain(
    q: Tensor,
    db: Tensor,
    sched: ProgressiveSchedule,
    *,
    sq_prefix: Optional[Tensor] = None,
    index_dims: Optional[tuple] = None,
    valid: Optional[Tensor] = None,
    block_n: int = 65536,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """``progressive_search`` through the plain versions on any device —
    the reference for checking the kernels; the serving path never calls
    it."""
    return _progressive(T.truncated_search, ops.plain, q, db,
                        sched, sq_prefix=sq_prefix, index_dims=index_dims,
                        valid=valid, block_n=block_n, metric=metric,
                        stage0_only=False)


#: Score-block size of the pooled stages: queries are taken in chunks so a
#: (chunk, pool) float32 block holds at most this many values (256 MB).
POOL_BLOCK = 1 << 26


def pool_of(cand: Tensor, bound: int) -> Tensor:
    """A (Q, K) candidate table deduplicated into a (bound,) int32 pool, as
    ``jnp.unique(cand.ravel(), size=bound, fill_value=-1)``: the unique ids
    ascending (a -1 in ``cand`` sorts first and stays), the first ``bound``
    of them, padded at the end with -1."""
    u = torch.unique(cand.reshape(-1)).to(torch.int32)[:bound]
    if u.numel() < bound:
        u = torch.cat([u, torch.full((bound - u.numel(),), -1,
                                     dtype=torch.int32, device=u.device)])
    return u


def _topk_first(s: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k smallest of each row of ``s`` and their positions, ordered by
    (score, position) — ``lax.top_k``'s tie order — whatever order
    ``torch.topk`` picks among equal values: every value below the k-th
    is taken, then the first positions holding the k-th."""
    kth = torch.topk(s, k, dim=1, largest=False).values[:, -1:]
    below = s < kth
    tied = s == kth
    need = k - below.sum(1, keepdim=True, dtype=torch.int32)
    take = below | (tied & (torch.cumsum(tied, 1, dtype=torch.int32) <= need))
    pos = take.nonzero()[:, 1].view(s.shape[0], k)
    sc = torch.gather(s, 1, pos)
    order = torch.sort(sc, dim=1, stable=True).indices
    return torch.gather(sc, 1, order), torch.gather(pos, 1, order)


def _score_pool(q: Tensor, db: Tensor, pool: Tensor, *, dim: int, k: int,
                db_sq_at_dim: Optional[Tensor], valid: Optional[Tensor],
                metric: str) -> Tuple[Tensor, Tensor]:
    """Every query against the whole pool at ``dim`` dims: the pool's rows
    gathered once (bound, dim), one product per chunk of queries, -1 and
    invalid slots +inf, the top k by (score, pool position)."""
    safe = pool.clamp(min=0).long()
    rows = db[safe, :dim].to(torch.float32)
    if metric == "l2":
        sq = (db_sq_at_dim[safe] if db_sq_at_dim is not None
              else (rows * rows).sum(1))
    elif metric == "cosine":
        gn = torch.clamp(torch.linalg.vector_norm(rows, dim=1), min=1e-12)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    dead = pool < 0
    if valid is not None:
        dead = dead | ~valid[safe]
    nq, bound = q.shape[0], pool.shape[0]
    chunk = max(1, POOL_BLOCK // max(bound, 1))
    out_s, out_i = [], []
    for a in range(0, nq, chunk):
        qd = q[a:a + chunk, :dim].to(torch.float32)
        ip = qd @ rows.T
        if metric == "l2":
            s = sq[None, :] - 2.0 * ip
        else:
            qn = torch.clamp(torch.linalg.vector_norm(qd, dim=1, keepdim=True),
                             min=1e-12)
            s = -(ip / (qn * gn[None, :]))
        s = s.masked_fill(dead[None, :], float("inf"))
        top_s, pos = _topk_first(s, k)
        out_s.append(top_s)
        out_i.append(pool[pos])
    top_s, idx = torch.cat(out_s), torch.cat(out_i)
    return top_s, torch.where(torch.isfinite(top_s), idx,
                              torch.full_like(idx, -1))


def _pooled(search: Callable, rescore: Callable, q, db, sched, *, sq_prefix,
            index_dims, valid, block_n, metric):
    nq = q.shape[0]
    s0 = sched.stages[0]
    _, cand = search(
        q, db, dim=s0.dim, k=s0.k,
        db_sq_at_dim=lookup_prefix(sq_prefix, index_dims, s0.dim),
        valid=valid, block_n=block_n, metric=metric)
    scores = None
    for stage in sched.stages[1:]:
        bound = min(nq * stage.pool, db.shape[0])
        scores, cand = _score_pool(
            q, db, pool_of(cand, bound), dim=stage.dim, k=stage.k,
            db_sq_at_dim=lookup_prefix(sq_prefix, index_dims, stage.dim),
            valid=valid, metric=metric)
    if scores is None:  # degenerate single-stage schedule
        scores, cand = rescore(
            q, db, cand, dim=sched.d_max, k=sched.final_k,
            db_sq_at_dim=lookup_prefix(sq_prefix, index_dims, sched.d_max),
            valid=valid, metric=metric)
    return scores, cand


def progressive_search_pooled(
    q: Tensor,
    db: Tensor,
    sched: ProgressiveSchedule,
    *,
    sq_prefix: Optional[Tensor] = None,
    index_dims: Optional[tuple] = None,
    valid: Optional[Tensor] = None,
    block_n: int = 65536,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """Paper-faithful pooled progressive search (§III.D).

    After stage 0, the candidates of *all* queries are merged into one
    deduplicated pool ("collected and saved in the same candidate pool, so
    the duplicate neighbors will be removed"); each later stage scores
    every query against the whole surviving pool and the per-query top-k
    survivors are pooled again.  A stage's pool is bounded by
    ``min(Q * stage.pool, N)`` ids, padded with -1 (`pool_of`).

    Stage 0 is ``ops.truncated_search``: the stage-0 kernel on CUDA
    tensors (which raises for ``metric='cosine'``), its plain version on
    CPU tensors.  The later stages are one plain product of the queries
    with the pool's gathered rows (`_score_pool`: ``torch.matmul`` over
    chunks of queries, `POOL_BLOCK` scores a chunk, then ``torch.topk``):
    the JAX package computes them in XLA over a broadcast pool table
    (``src/repro/core/progressive.py:221-227``), outside any Pallas kernel.
    Ties order by (score, pool position), as ``lax.top_k`` does.

    Returns:
      (scores, indices): ((Q, final_k) float32, (Q, final_k) int32).
    """
    return _pooled(ops.truncated_search, ops.rescore_candidates, q, db, sched,
                   sq_prefix=sq_prefix, index_dims=index_dims, valid=valid,
                   block_n=block_n, metric=metric)


def progressive_search_pooled_plain(
    q: Tensor,
    db: Tensor,
    sched: ProgressiveSchedule,
    *,
    sq_prefix: Optional[Tensor] = None,
    index_dims: Optional[tuple] = None,
    valid: Optional[Tensor] = None,
    block_n: int = 65536,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """``progressive_search_pooled`` with stage 0 on the plain version, on
    any device — the reference for checking the kernel path (the pooled
    stages are the same plain product in both)."""
    return _pooled(T.truncated_search, T.rescore_candidates, q, db, sched,
                   sq_prefix=sq_prefix, index_dims=index_dims, valid=valid,
                   block_n=block_n, metric=metric)
