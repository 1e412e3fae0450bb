"""Device dispatch for the search path's, the LM's, the recsys models' and
EGNN's kernels.

A CUDA tensor always goes to the hand-written kernel; a CPU tensor goes to
the kernel's plain version.  There is no switch that sends CUDA tensors
down the plain path: on the card it is the kernel or an exception.  Search
and LM code call these, never the kernels directly.

The three kernels a training step reaches — flash attention, the
embedding bag and the sorted segment sum — each have a hand-written
backward behind a ``torch.autograd.Function``.  An entry takes the
``Function`` only when gradients are asked for (grad mode on and an input
that requires grad); otherwise it calls the wrapper as before, so serving
launches exactly what it launched.

``plain`` holds the search, embedding-bag and segment-sum entry points
bound to the plain versions on any device; the ``*_plain`` reference
searches pass it (as ``impl=``), and a check on the card may put its
entries in place of this module's to run a path on the plain versions.
"""

from __future__ import annotations

import types
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import truncated as T
from repro_torch.kernels import (distance_topk, embedding_bag as eb,
                                 flash_attention as fa, gather_rescore,
                                 ivf_scan, pq_scan, segment_sum as ss)

Tensor = torch.Tensor


def _on_cuda(*ts) -> bool:
    return any(t is not None and t.is_cuda for t in ts)


def _wants_grad(*ts) -> bool:
    """Gradients asked for: grad mode on and an input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


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


def _ladder_args(stages, sq_prefix, index_dims):
    """((dim, k) of each stage, the ``sq_prefix`` column holding each
    stage's norms or None, or None when there are no norm columns)."""
    pairs = [(st.dim, st.k) for st in stages]
    if sq_prefix is None or index_dims is None:
        return pairs, None
    dims = tuple(int(x) for x in index_dims)
    return pairs, [dims.index(d) if d in dims else None for d, _ in pairs]


def _rescore_ladder_plain(
    q: Tensor, db: Tensor, cand: Tensor, stages, *,
    sq_prefix: Optional[Tensor] = None, index_dims: Optional[tuple] = None,
    valid: Optional[Tensor] = None, metric: str = "l2",
    scores: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    if not stages:
        return scores, cand
    pairs, cols = _ladder_args(stages, sq_prefix, index_dims)
    return gather_rescore.rescore_ladder_topk_plain(
        q, db, cand, pairs, sq_prefix=sq_prefix, sq_cols=cols, valid=valid,
        metric=metric)


def rescore_ladder(
    q: Tensor, db: Tensor, cand: Tensor, stages, *,
    sq_prefix: Optional[Tensor] = None, index_dims: Optional[tuple] = None,
    valid: Optional[Tensor] = None, metric: str = "l2",
    scores: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The rescore ladder over ``stages`` (each with ``dim`` and ``k``):
    one kernel launch on CUDA tensors, the plain step chained on CPU
    tensors.  ``scores`` comes back unchanged when ``stages`` is empty."""
    if not _on_cuda(q, db, cand):
        return _rescore_ladder_plain(q, db, cand, stages, sq_prefix=sq_prefix,
                                     index_dims=index_dims, valid=valid,
                                     metric=metric, scores=scores)
    if not stages:
        return scores, cand
    _cuda_metric(metric)
    pairs, cols = _ladder_args(stages, sq_prefix, index_dims)
    return gather_rescore.rescore_ladder_topk(
        q, db, cand, pairs, sq_prefix=None if cols is None else sq_prefix,
        sq_cols=cols, valid=valid)


def ivf_scan_topk(q: Tensor, probe: Tensor, member_ids: Tensor, pack: Dict,
                  *, k: int, valid: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """IVF stage 0 over float32 or int8 member slabs; ``valid`` marks the
    live ids (read in the kernel on CUDA, masked first on the CPU)."""
    if _on_cuda(q):
        return ivf_scan.ivf_scan_topk(q, probe, member_ids, pack, k=k,
                                      valid=valid)
    return ivf_scan.ivf_scan_topk_plain(q, probe, member_ids, pack, k=k,
                                        valid=valid)


def pq_scan_topk(lut: Tensor, codes: Tensor, ids: Tensor,
                 *, k: int) -> Tuple[Tensor, Tensor]:
    """Flat PQ ADC stage 0 over the whole code block."""
    if _on_cuda(lut):
        return pq_scan.pq_scan_topk(lut, codes, ids, k=k)
    return pq_scan.pq_scan_topk_plain(lut, codes, ids, k=k)


def pq_ivf_scan_topk(q: Tensor, probe: Tensor, member_ids: Tensor,
                     pack: Dict, *, k: int, valid: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """IVF-PQ ADC stage 0 over list-major code slabs; ``valid`` as in
    `ivf_scan_topk`."""
    if _on_cuda(q):
        return pq_scan.pq_ivf_scan_topk(q, probe, member_ids, pack, k=k,
                                        valid=valid)
    return pq_scan.pq_ivf_scan_topk_plain(q, probe, member_ids, pack, k=k,
                                          valid=valid)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> Tensor:
    """Fused attention (prefill and decode), queries aligned to the end of kv."""
    if _wants_grad(q, k, v):
        return fa.FlashAttentionFn.apply(q, k, v, causal, window, scale)
    if _on_cuda(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale)
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    scale=scale)


def embedding_bag(tables: Tensor, ids: Tensor, *, mode: str = "sum") -> Tensor:
    """EmbeddingBag over stacked (F, V, D) tables with (B, F, L) ids (or one
    (V, D) table with (B, L) ids): float32 per-bag sum / mean / max."""
    if mode != "max" and _wants_grad(tables):
        if tables.dim() == 2:
            return embedding_bag(tables[None], ids[:, None], mode=mode)[:, 0]
        return eb.EmbeddingBagFn.apply(tables, ids, mode)
    if _on_cuda(tables, ids):
        if mode == "max":
            raise NotImplementedError(
                "mode='max' on CUDA is not ported yet: the CUDA kernel "
                "reduces 'sum' and 'mean' only (the CPU path supports 'max')")
        return eb.embedding_bag(tables, ids, mode=mode)
    return eb.embedding_bag_plain(tables, ids, mode=mode)


def segment_sum(data: Tensor, seg_ids: Tensor, *, num_segments: int) -> Tensor:
    """Float32 segment sum of unsorted rows; ids outside [0, N) dropped."""
    if _wants_grad(data) and _on_cuda(data, seg_ids):
        order, seg_s, indptr = ss.sort_by_segment(seg_ids, num_segments)
        return sorted_segment_sum(data[order], seg_s, indptr,
                                  num_segments=num_segments)
    if _on_cuda(data, seg_ids):
        return ss.segment_sum(data, seg_ids, num_segments=num_segments)
    return ss.segment_sum_plain(data, seg_ids, num_segments=num_segments)


def sorted_segment_sum(data: Tensor, seg_ids: Tensor, indptr: Tensor, *,
                       num_segments: int) -> Tensor:
    """Float32 segment sum of rows sorted by segment, with CSR ``indptr``."""
    if _wants_grad(data):
        return ss.SortedSegmentSumFn.apply(data, seg_ids, indptr,
                                           num_segments)
    if _on_cuda(data, indptr):
        return ss.sorted_segment_sum(data, seg_ids, indptr,
                                     num_segments=num_segments)
    return ss.sorted_segment_sum_plain(data, seg_ids, indptr,
                                       num_segments=num_segments)


plain = types.SimpleNamespace(
    truncated_search=T.truncated_search,
    rescore_candidates=T.rescore_candidates,
    rescore_ladder=_rescore_ladder_plain,
    ivf_scan_topk=ivf_scan.ivf_scan_topk_plain,
    pq_scan_topk=pq_scan.pq_scan_topk_plain,
    pq_ivf_scan_topk=pq_scan.pq_ivf_scan_topk_plain,
    embedding_bag=eb.embedding_bag_plain,
    segment_sum=ss.segment_sum_plain,
    sorted_segment_sum=ss.sorted_segment_sum_plain,
)
