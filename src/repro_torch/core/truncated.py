"""Truncated Retrieval — the paper's baseline (§III.C), plain PyTorch.

Brute-force exact k-NN over the full database at a truncated dimensionality,
in matmul form:

    ||q - x||^2 = ||q||^2 - 2 q·x + ||x||^2

``||q||^2`` is constant per query row, so for *ranking* the score is
``s = ||x||^2 - 2 q·x``.  The functions here are the plain versions of the
two CUDA kernels (`repro_torch.kernels.distance_topk`,
`repro_torch.kernels.gather_rescore`): they run on any device, serve the CPU
path, and are what the kernels are checked against on the card.

Result contract (shared with the kernels): scores ascend; ties keep the
lowest row index (stage 0) or the lowest candidate position (rescore); any
slot whose score is not finite carries id -1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def l2_scores(q: Tensor, db: Tensor, db_sq: Optional[Tensor] = None) -> Tensor:
    """Rank-equivalent squared-L2 scores: ``||x||^2 - 2 q·x`` (no ||q||^2 term).

    Args:
      q:     (Q, d) queries.
      db:    (N, d) documents.
      db_sq: optional precomputed (N,) squared norms of db rows.

    Returns:
      (Q, N) float32 scores; argmin over axis 1 == exact 1-NN by L2.
    """
    db = db.to(torch.float32)
    if db_sq is None:
        db_sq = (db * db).sum(dim=-1)
    ip = q.to(torch.float32) @ db.T
    return db_sq[None, :] - 2.0 * ip


def cosine_scores(q: Tensor, db: Tensor, db_sq: Optional[Tensor] = None) -> Tensor:
    """Negated cosine similarity (so lower is better, matching L2 convention)."""
    db = db.to(torch.float32)
    q = q.to(torch.float32)
    if db_sq is None:
        db_sq = (db * db).sum(dim=-1)
    q_n = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                          min=1e-12)
    ip = q_n @ db.T
    return -(ip / torch.clamp(torch.sqrt(db_sq), min=1e-12)[None, :])


_METRICS = {"l2": l2_scores, "cosine": cosine_scores}


def _sentinel_ids(scores: Tensor, ids: Tensor) -> Tensor:
    """Slots whose score is not finite carry id -1, never a row id."""
    return torch.where(torch.isfinite(scores), ids, torch.full_like(ids, -1))


def truncated_search(
    q: Tensor,
    db: Tensor,
    *,
    dim: int,
    k: int = 1,
    db_sq_at_dim: Optional[Tensor] = None,
    valid: Optional[Tensor] = None,
    block_n: int = 65536,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """Exact k-NN over ``db`` truncated to the first ``dim`` dimensions.

    The scan over documents is blocked: each step scores a (Q, block_n) tile
    and folds it into a running per-query top-k (a stable sort over the
    carry followed by the tile, so equal scores keep the lower row index),
    so peak memory is O(Q·(k + block_n)) instead of O(Q·N).

    Args:
      q:            (Q, D) queries (D >= dim; only [:, :dim] is used).
      db:           (N, D) documents.
      dim:          truncation dimensionality.
      k:            neighbours to return (may exceed N: the extra slots are
                    (+inf, -1)).
      db_sq_at_dim: optional (N,) precomputed prefix squared norms at ``dim``
                    (ignored for cosine).
      valid:        optional (N,) bool mask; False rows score +inf and are
                    never returned.
      block_n:      document tile size.
      metric:       'l2' or 'cosine'.

    Returns:
      (scores, indices): ((Q, k) float32, (Q, k) int32), ascending by score.
      L2 scores omit the constant ``||q||^2`` term (rank-equivalent).
    """
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    n = db.shape[0]
    nq = q.shape[0]
    dev = db.device
    qd = q[:, :dim]
    score_fn = _METRICS[metric]
    block_n = max(int(block_n), 1)
    best_s = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for base in range(0, n, block_n):
        blk = db[base:base + block_n, :dim]
        sq = None
        if metric == "l2" and db_sq_at_dim is not None:
            sq = db_sq_at_dim[base:base + block_n]
        s = score_fn(qd, blk, sq)
        if valid is not None:
            s = s.masked_fill(~valid[base:base + block_n][None, :],
                              float("inf"))
        idx = torch.arange(base, base + blk.shape[0], dtype=torch.int32,
                           device=dev)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, idx[None, :].expand(nq, -1)], dim=1)
        order = torch.sort(cat_s, dim=1, stable=True).indices[:, :k]
        best_s = torch.gather(cat_s, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_s, _sentinel_ids(best_s, best_i)


def inject_candidates(cand: Tensor, extra: Optional[Tensor]) -> Tensor:
    """Append a shared (E,) id window to every query's candidate table.

    ``extra`` is -1-padded (scored +inf by ``rescore_candidates``) and must
    be disjoint from ``cand``'s ids so the final top-k carries no
    duplicates.
    """
    if extra is None:
        return cand
    return torch.cat(
        [cand, extra[None, :].expand(cand.shape[0], -1).to(cand.dtype)], dim=1)


def rescore_candidates(
    q: Tensor,
    db: Tensor,
    cand: Tensor,
    *,
    dim: int,
    k: int,
    db_sq_at_dim: Optional[Tensor] = None,
    valid: Optional[Tensor] = None,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """Exact k-NN of each query against *its own* candidate rows at ``dim`` dims.

    Args:
      q:    (Q, D) queries.
      db:   (N, D) documents.
      cand: (Q, C) int32 candidate indices per query (-1 = padding, scored
            +inf).
      dim:  scoring dimensionality.
      k:    candidates kept (k <= C).
      valid: optional (N,) bool mask; candidates pointing at invalid rows are
             scored +inf (guards against rows deleted between stages).

    Returns:
      (scores, indices): ((Q, k) float32, (Q, k) int32 — *global* db
      indices); equal scores keep the lower position in ``cand``.
    """
    qd = q[:, :dim].to(torch.float32)
    safe = torch.clamp(cand, min=0).long()
    gathered = db[safe, :dim].to(torch.float32)           # (Q, C, dim)
    ip = torch.einsum("qd,qcd->qc", qd, gathered)
    if metric == "l2":
        if db_sq_at_dim is not None:
            sq = db_sq_at_dim[safe]
        else:
            sq = (gathered * gathered).sum(dim=-1)
        s = sq - 2.0 * ip
    elif metric == "cosine":
        qn = torch.clamp(torch.linalg.vector_norm(qd, dim=-1, keepdim=True),
                         min=1e-12)
        gn = torch.clamp(torch.linalg.vector_norm(gathered, dim=-1), min=1e-12)
        s = -(ip / (qn * gn))
    else:
        raise ValueError(f"unknown metric {metric!r}")
    keep = cand >= 0
    if valid is not None:
        keep = keep & valid[safe]
    s = s.masked_fill(~keep, float("inf"))
    order = torch.sort(s, dim=1, stable=True).indices[:, :k]
    top_s = torch.gather(s, 1, order)
    idx = torch.gather(cand.to(torch.int32), 1, order)
    return top_s, _sentinel_ids(top_s, idx)
