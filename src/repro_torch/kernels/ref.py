"""Plain-PyTorch oracles for the port's kernels.

Each function is the mathematical specification a kernel must match — no
tiling, no masking tricks, just the math — mirroring the JAX package's
oracles of the same names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def l2_topk_ref(
    q: Tensor, db: Tensor, k: int, db_sq: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Exact top-k by rank-equivalent L2 score ``||x||^2 - 2 q.x``.

    Returns ((Q, k) scores ascending, (Q, k) int32 indices); equal scores
    keep the lower row index.
    """
    db = db.to(torch.float32)
    if db_sq is None:
        db_sq = (db * db).sum(dim=-1)
    s = db_sq[None, :] - 2.0 * (q.to(torch.float32) @ db.T)
    top_s, idx = torch.sort(s, dim=1, stable=True)
    return top_s[:, :k], idx[:, :k].to(torch.int32)


def gather_rescore_ref(q: Tensor, db: Tensor, cand: Tensor) -> Tensor:
    """Distances of each query to its own candidate rows at full dims.

    Args:
      q:    (Q, D); db: (N, D); cand: (Q, C) int32, -1 = padding.
    Returns:
      (Q, C) float32 scores, +inf at padded slots.
    """
    rows = db[torch.clamp(cand, min=0).long()].to(torch.float32)  # (Q, C, D)
    sq = (rows * rows).sum(dim=-1)
    ip = torch.einsum("qd,qcd->qc", q.to(torch.float32), rows)
    s = sq - 2.0 * ip
    return s.masked_fill(cand < 0, float("inf"))
