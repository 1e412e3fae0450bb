"""Device dispatch for the search path's two kernels.

A CUDA tensor always goes to the hand-written kernel; a CPU tensor goes to
the plain version in `repro_torch.core.truncated`.  There is no switch that
sends CUDA tensors down the plain path: on the card it is the kernel or an
exception.  Search code calls these, never the kernels directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import truncated as T
from repro_torch.kernels import distance_topk, gather_rescore

Tensor = torch.Tensor


def _on_cuda(*ts) -> bool:
    return any(t is not None and t.is_cuda for t in ts)


def _contiguous(col: Optional[Tensor]) -> Optional[Tensor]:
    """A prefix-norm column as the kernels take it: unit stride."""
    if col is None or col.shape[0] < 2 or col.stride(0) == 1:
        return col
    return col.contiguous()


def _cuda_metric(metric: str) -> None:
    if metric != "l2":
        raise NotImplementedError(
            f"metric={metric!r} on CUDA is not ported yet: the CUDA kernels "
            f"score L2 only (the CPU path supports 'cosine')")


def truncated_search(
    q: Tensor, db: Tensor, *, dim: int, k: int,
    db_sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
    block_n: int = 65536, metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """Stage 0: exact top-k over the whole buffer at ``dim`` dims."""
    if _on_cuda(q, db):
        _cuda_metric(metric)
        return distance_topk.l2_topk(q, db, dim=dim, k=k,
                                     sq_at_dim=_contiguous(db_sq_at_dim),
                                     valid=valid)
    return T.truncated_search(q, db, dim=dim, k=k, db_sq_at_dim=db_sq_at_dim,
                              valid=valid, block_n=block_n, metric=metric)


def rescore_candidates(
    q: Tensor, db: Tensor, cand: Tensor, *, dim: int, k: int,
    db_sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """One rescore-ladder step: each query's own candidates at ``dim`` dims."""
    if _on_cuda(q, db, cand):
        _cuda_metric(metric)
        return gather_rescore.gather_rescore_topk(
            q, db, cand, dim=dim, k=k, sq_at_dim=_contiguous(db_sq_at_dim),
            valid=valid)
    return T.rescore_candidates(q, db, cand, dim=dim, k=k,
                                db_sq_at_dim=db_sq_at_dim, valid=valid,
                                metric=metric)
