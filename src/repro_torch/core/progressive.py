"""Progressive Retrieval — the paper's contribution (§III.D).

Multi-stage search: stage 0 scans the *entire* database at a low truncated
dimensionality keeping K candidates per query; each later stage doubles the
dimensionality, halves K, and rescores only the surviving candidates; the
final stage runs at the target dimensionality on the remaining pool.  Early
stages are cheap (low dim) but touch everything; late stages are expensive
per row but touch almost nothing — total work collapses from O(N·D_max) to
O(N·D_start + Σ K_s·D_s).

Candidate sets are per query with fixed sizes per stage.  On CUDA tensors
stage 0 is the fused scan kernel and every later stage the gather-rescore
kernel (`repro_torch.kernels.ops`); on CPU tensors both are the plain
versions.  ``progressive_search_plain`` runs the plain versions on any
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


def _ladder(rescore: Callable, q, db, cand, stages, *, sq_prefix, index_dims,
            valid, metric, scores):
    for stage in stages:
        scores, cand = rescore(
            q, db, cand,
            dim=stage.dim, k=stage.k,
            db_sq_at_dim=lookup_prefix(sq_prefix, index_dims, stage.dim),
            valid=valid,
            metric=metric,
        )
    return scores, cand


def _progressive(search: Callable, rescore: Callable, q, db, sched, *,
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
    return _ladder(rescore, q, db, cand, sched.stages[1:],
                   sq_prefix=sq_prefix, index_dims=index_dims, valid=valid,
                   metric=metric, scores=scores)


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
) -> Tuple[Tensor, Tensor]:
    """Chain ``rescore_candidates`` over ``stages`` — the refinement ladder
    every search path shares once it has a candidate table.

    ``scores`` is returned unchanged when ``stages`` is empty (degenerate
    single-stage schedules).
    """
    return _ladder(ops.rescore_candidates, q, db, cand, stages,
                   sq_prefix=sq_prefix, index_dims=index_dims, valid=valid,
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
    return _progressive(ops.truncated_search, ops.rescore_candidates, q, db,
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
    return _progressive(T.truncated_search, T.rescore_candidates, q, db,
                        sched, sq_prefix=sq_prefix, index_dims=index_dims,
                        valid=valid, block_n=block_n, metric=metric,
                        stage0_only=False)
