"""Quantized staged index — precision-progressive search (beyond paper).

The paper's insight is that early search stages need only a *cheap sketch*
of each vector (few leading dimensions).  Precision is the same axis:
stage 0 tolerates int8; only the final exact stage needs full precision.
Composing both, the stage-0 scan reads

    N x Ds x 1 byte      (int8 staged block)

versus ``N x D x 4`` for the naive f32 row-major scan.  Stage 0 here is
plain PyTorch (the JAX package leaves it to XLA as a matmul too): the int8
codes times the folded float32 query, in row blocks so that no (N, Ds)
float copy of the codes is ever made, then a running top-k.  The
progressive rescore at full precision absorbs any stage-0 ranking noise
exactly the way it absorbs truncation noise.

    idx = build_quantized_index(db, sched)
    scores, ids = quantized_progressive_search(q, idx, sched)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import ProgressiveSchedule

Array = torch.Tensor


# -- shared int8 grid helpers -------------------------------------------------
# The one home for per-dimension symmetric int8 bookkeeping: the quantized
# backend, the IVF kernel's member-slab packing, and incremental append
# encoding all share the same grid (fit scale -> encode -> fold the query).

def fit_int8_scale(x: Array, mask: Optional[Array] = None) -> Array:
    """Per-dimension symmetric scale: ``amax/127`` over (masked) rows.

    ``mask`` selects the rows the grid is fit on (live corpus rows — dead /
    padding slots would drag the grid toward zero); codes can still be
    emitted for every row afterwards.
    """
    ax = x.to(torch.float32).abs()
    if mask is not None:
        ax = torch.where(mask[:, None], ax, torch.zeros_like(ax))
    if ax.shape[0] == 0:
        amax = torch.zeros(ax.shape[1:], dtype=torch.float32, device=ax.device)
    else:
        amax = ax.max(dim=0).values
    return torch.clamp(amax, min=1e-12) / 127.0


def int8_encode(x: Array, scale: Array) -> Tuple[Array, Array]:
    """Code rows onto an existing grid.

    Returns (codes (N, D) int8, deq_sq (N,) f32) where ``deq_sq`` holds the
    squared norms of the *dequantized* rows — the norm table every int8
    scoring path pairs with the codes.
    """
    codes = torch.clamp(torch.round(x.to(torch.float32) / scale),
                        -127, 127).to(torch.int8)
    deq = codes.to(torch.float32) * scale
    return codes, (deq * deq).sum(dim=-1)


def fold_int8_query(q: Array, scale: Array) -> Array:
    """Fold a query onto the codes' grid for rank-equivalent int8 scoring.

    Distances in the *scaled* space (x_d / s_d) are NOT rank-equivalent to
    true distances, so the query is quantized onto the same grid and the
    per-dim ``s_d^2`` rescale is folded into the query side:
    ``ip = (round(clip(q/s)) * s^2) @ codes^T`` keeps the db operand — the
    side that dominates memory traffic — int8.
    """
    qq = torch.clamp(torch.round(q.to(torch.float32) / scale), -127, 127)
    return (qq * scale * scale).to(torch.float32)


def pad_pow2(a: np.ndarray) -> np.ndarray:
    """Pad axis 0 up to a power of two by repeating the last element.

    Scatter updates are idempotent under repeats (same dest, same value),
    so padded batches write what the unpadded ones would; bounding the
    batch shape to O(log B) distinct sizes keeps scatter shapes few.
    """
    a = np.asarray(a)
    n = a.shape[0]
    target = 1 << (max(n, 1) - 1).bit_length()
    if target == n:
        return a
    reps = np.ones(n, np.int64)
    reps[-1] = target - n + 1
    return np.repeat(a, reps, axis=0)


# incremental-append scatters, shared by the quantized backend's code block
# and the IVF kernels' member-slab packs.  The JAX package donates the
# target buffers so XLA updates them in place; here they are plain in-place
# ``index_copy_`` writes — absorbing a handful of rows never copies an
# O(corpus) buffer on any device.

def scatter_rows(buf: Array, dests, rows: Array) -> Array:
    """Write ``rows`` into ``buf[dests]`` in place; returns ``buf``."""
    dests = torch.as_tensor(dests, device=buf.device).long()
    return buf.index_copy_(0, dests, rows.to(buf.dtype))


def scatter_rows2(a: Array, b: Array, dests, ra: Array,
                  rb: Array) -> Tuple[Array, Array]:
    """Paired in-place scatter (codes + their norm table), one dest batch."""
    dests = torch.as_tensor(dests, device=a.device).long()
    a.index_copy_(0, dests, ra.to(a.dtype))
    b.index_copy_(0, dests, rb.to(b.dtype))
    return a, b


def quantize_per_dim(x: Array, valid: Optional[Array] = None) -> Tuple[Array, Array]:
    """Symmetric per-dimension int8 quantization.

    Returns (q (N, D) int8, scale (D,) f32) with x ≈ q * scale.  When a
    ``valid`` row mask is given, the scale is fit on live rows only (dead /
    unpopulated buffer slots would otherwise drag the grid toward zero), but
    codes are still emitted for every row.
    """
    scale = fit_int8_scale(x, valid)
    q, _ = int8_encode(x, scale)
    return q, scale


def build_quantized_index(
    db: Array, sched: ProgressiveSchedule, *, valid: Optional[Array] = None
) -> Dict[str, Array]:
    """Stage-0 int8 block + full-precision corpus + stage-0 squared norms."""
    ds = sched.stages[0].dim
    scale0 = fit_int8_scale(db[:, :ds], valid)
    q0, deq_sq = int8_encode(db[:, :ds], scale0)
    return {
        "db": db,
        "db0_q": q0,                 # (N, Ds) int8
        "scale0": scale0,            # (Ds,) f32
        "sq0": deq_sq,               # (N,) norms of the dequantized block
    }


def _scaled_space_topk(
    q: Array, idx: Dict[str, Array], k: int, *, valid: Optional[Array],
    row_limit: Optional[int], block_n: int,
) -> Tuple[Array, Array]:
    """Stage-0 top-k by rank-equivalent scores computed in scaled int8
    space (see `fold_int8_query` for why the rescale rides on the query
    side), one block of code rows at a time: each block is widened to
    float32, multiplied by the folded query, and folded into a running
    top-k by a stable sort, so equal scores keep the lower row index."""
    db0_q = idx["db0_q"]
    n0, ds = db0_q.shape
    nq = q.shape[0]
    dev = db0_q.device
    q_scaled = fold_int8_query(q[:, :ds], idx["scale0"])      # (Q, Ds)
    best_s = torch.full((nq, k), float("inf"), dtype=torch.float32,
                        device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for base in range(0, n0, max(int(block_n), 1)):
        blk = db0_q[base:base + block_n]
        rows = torch.arange(base, base + blk.shape[0], dtype=torch.int32,
                            device=dev)
        s = idx["sq0"][base:base + blk.shape[0]][None, :] \
            - 2.0 * (q_scaled @ blk.to(torch.float32).T)
        keep = torch.ones_like(rows, dtype=torch.bool)
        if valid is not None:
            keep = keep & valid[base:base + blk.shape[0]]
        if row_limit is not None:
            keep = keep & (rows < int(row_limit))
        s = s.masked_fill(~keep[None, :], float("inf"))
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, rows[None, :].expand(nq, -1)], dim=1)
        order = torch.sort(cat_s, dim=1, stable=True).indices[:, :k]
        best_s = torch.gather(cat_s, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    # fully-masked slots must surface the -1 sentinel, not a row id
    best_i = torch.where(torch.isfinite(best_s), best_i,
                         torch.full_like(best_i, -1))
    return best_s, best_i


def quant_rest_stages(sched, *, extra_cand=None, valid=None):
    """Post-stage-0 ladder stages for the quantized / PQ families.

    ``stages[1:]``, except a single-stage schedule with injected or masked
    candidates still needs one exact pass so those candidates carry
    full-precision scores.
    """
    rest = sched.stages[1:]
    if not rest and (extra_cand is not None or valid is not None):
        rest = (sched.stages[0],)
    return rest


def _quantized_search(
    q, idx, sched, *, metric, db, valid, row_limit, extra_cand,
    stage0_only, block_n, impl,
):
    from repro_torch.core import truncated as T
    from repro_torch.core.progressive import rescore_ladder

    s0 = sched.stages[0]
    rescore_db = idx["db"] if db is None else db
    n0 = idx["db0_q"].shape[0]
    scores, cand = _scaled_space_topk(q, idx, min(s0.k, n0), valid=valid,
                                      row_limit=row_limit, block_n=block_n)
    cand = T.inject_candidates(cand, extra_cand)
    if stage0_only:
        # fenced split: injected tail rows ride along unscored — the ladder
        # (`quant_rest_stages` + `rescore_ladder`) scores them exactly
        return scores, cand
    rest = quant_rest_stages(sched, extra_cand=extra_cand, valid=valid)
    return rescore_ladder(q, rescore_db, cand, rest, valid=valid,
                          metric=metric, scores=scores, impl=impl)


def quantized_progressive_search(
    q: Array, idx: Dict[str, Array], sched: ProgressiveSchedule,
    *, metric: str = "l2",
    db: Optional[Array] = None,
    valid: Optional[Array] = None,
    row_limit: Optional[int] = None,
    extra_cand: Optional[Array] = None,
    stage0_only: bool = False,
    block_n: int = 65536,
) -> Tuple[Array, Array]:
    """Progressive search with an int8 stage-0 block.

    Stage 0 ranks with quantized scores; every later stage rescores the
    survivors at full precision (the rescore kernel on CUDA tensors), so
    the final results carry exact distances.

    Mutable-corpus extensions (all optional, used by the engine's
    ``QuantizedProgressiveBackend``):

      db:         rescore buffer when the index's ``db`` snapshot is stale.
      valid:      (N,) bool row mask over ``db``; invalid rows are scored
                  +inf at stage 0 and at every rescore.
      row_limit:  rows >= it are excluded from stage-0 ranking (their codes
                  predate them); pair with ``extra_cand`` to keep them
                  reachable.
      extra_cand: (E,) int32 ids injected after stage 0 (-1 padded), rescored
                  at full precision; must be disjoint from stage-0 rows.
      block_n:    code rows widened to float32 per stage-0 step.
    """
    from repro_torch.kernels import ops
    return _quantized_search(
        q, idx, sched, metric=metric, db=db, valid=valid,
        row_limit=row_limit, extra_cand=extra_cand, stage0_only=stage0_only,
        block_n=block_n, impl=ops)


def quantized_progressive_search_plain(
    q: Array, idx: Dict[str, Array], sched: ProgressiveSchedule,
    *, metric: str = "l2",
    db: Optional[Array] = None,
    valid: Optional[Array] = None,
    row_limit: Optional[int] = None,
    extra_cand: Optional[Array] = None,
    block_n: int = 65536,
) -> Tuple[Array, Array]:
    """``quantized_progressive_search`` through the plain versions on any
    device — the reference for checking the kernels; the serving path
    never calls it."""
    from repro_torch.kernels import ops
    return _quantized_search(
        q, idx, sched, metric=metric, db=db, valid=valid,
        row_limit=row_limit, extra_cand=extra_cand, stage0_only=False,
        block_n=block_n, impl=ops.plain)
