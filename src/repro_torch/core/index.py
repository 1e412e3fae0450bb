"""Vector index: the database-side state for truncated / progressive search.

An index holds the document embedding matrix plus precomputed *prefix squared
norms*: ``sq_prefix[n, j] = sum_{i < dims[j]} db[n, i]^2`` for every stage
dimensionality a schedule can touch.  Precomputing these once at build time
moves O(N·D) work out of every query batch — the same role the ``||x||^2``
cache plays in classic matmul-form L2 search.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.schedule import ProgressiveSchedule

# Rows per cumulative-sum chunk: bounds the float32 temporary to
# ``_NORM_CHUNK * D`` values however large the corpus is.
_NORM_CHUNK = 1 << 15


def stage_dims(sched: ProgressiveSchedule) -> tuple:
    return tuple(s.dim for s in sched.stages)


def prefix_squared_norms(db: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """(N, len(dims)) float32 prefix squared norms of ``db`` rows at each dim.

    One cumulative sum of squares gives every prefix norm at once:
    ``cumsq[:, j] = sum_{i<=j} db[:, i]^2``; the prefix norm at dim k is
    ``cumsq[:, k-1]``.  Rows are processed in chunks so the temporary stays
    small; the result lies on ``db``'s device.
    """
    n = db.shape[0]
    dims = tuple(int(x) for x in dims)
    out = torch.empty((n, len(dims)), dtype=torch.float32, device=db.device)
    if not dims or n == 0:
        return out
    cols = torch.tensor([k - 1 for k in dims], dtype=torch.long,
                        device=db.device)
    d_max = dims[-1]
    for lo in range(0, n, _NORM_CHUNK):
        blk = db[lo:lo + _NORM_CHUNK, :d_max].to(torch.float32)
        out[lo:lo + _NORM_CHUNK] = torch.cumsum(blk * blk, dim=1)[:, cols]
    return out


def build_index(
    db,
    dims: Sequence[int],
    *,
    valid=None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Build a search index over ``db`` with prefix norms at each dim in ``dims``.

    Args:
      db:     (N, D) document embeddings (numpy or tensor).
      dims:   dimensionalities whose prefix squared norms to precompute; must
              be ascending, each in [1, D].
      valid:  optional (N,) bool row-validity mask (False rows are deleted or
              unpopulated); defaults to all-valid.
      dtype:  storage dtype of ``db``.
      device: target device (default: ``db``'s own when it is a tensor).

    Returns:
      dict with 'db' (N, D), 'sq_prefix' (N, len(dims)) float32, 'valid'
      (N,) bool and 'dims' (len(dims),) int32.
    """
    db = torch.as_tensor(db, dtype=dtype, device=device)
    n, d = db.shape
    dims = tuple(int(x) for x in dims)
    if list(dims) != sorted(dims):
        raise ValueError(f"dims must be ascending, got {dims}")
    if dims and dims[0] < 1:
        raise ValueError(f"dims must be >= 1, got {dims}")
    if dims and dims[-1] > d:
        raise ValueError(f"max dim {dims[-1]} exceeds embedding dim {d}")
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=db.device)
    else:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=db.device)
        if tuple(valid.shape) != (n,):
            raise ValueError(f"valid mask shape {tuple(valid.shape)} != ({n},)")
    return {
        "db": db,
        "sq_prefix": prefix_squared_norms(db, dims),
        "valid": valid,
        "dims": torch.tensor(dims, dtype=torch.int32, device=db.device),
    }


def index_for_schedule(db, sched: ProgressiveSchedule,
                       **kw) -> Dict[str, torch.Tensor]:
    """`build_index` at every stage dim of ``sched`` (``kw`` as there)."""
    return build_index(db, stage_dims(sched), **kw)


def prefix_norm_column(index: Dict[str, torch.Tensor], dim: int,
                       dims: Sequence[int]) -> torch.Tensor:
    """Return the (N,) prefix squared-norm column for ``dim``.

    ``dims`` is the tuple the index was built with.
    """
    dims = tuple(int(x) for x in dims)
    try:
        j = dims.index(int(dim))
    except ValueError:
        raise KeyError(f"dim {dim} not precomputed; index has {dims}") from None
    return index["sq_prefix"][:, j]


def lookup_prefix(sq_prefix: Optional[torch.Tensor],
                  dims: Optional[Sequence[int]],
                  dim: int) -> Optional[torch.Tensor]:
    """The (N,) prefix-norm column for ``dim``, or None when not precomputed."""
    if sq_prefix is None or dims is None:
        return None
    dims = tuple(int(x) for x in dims)
    if int(dim) not in dims:
        return None
    return sq_prefix[:, dims.index(int(dim))]
