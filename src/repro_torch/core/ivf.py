"""IVF-Flat approximate search — beyond-paper ANN comparator.

An inverted-file (IVF) index — k-means coarse quantizer + per-list exact
scan — prunes the search space before exact scoring.  It composes with
progressive search: probing runs at a truncated dimensionality and the
final rescore at full dims (`ivf_progressive_search_sched` and the kernel
route `ivf_progressive_search_kernel`), the paper's "future work:
integration with ANN".

k-means draws its initial centroids from a ``torch.Generator`` seeded from
``seed`` (the JAX package draws from ``jax.random``; the two differ, so
parity with it is tested on carried-over centroids and lists).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import truncated as T
from repro_torch.core.index import lookup_prefix
from repro_torch.core.schedule import ProgressiveSchedule

Array = torch.Tensor


def balanced_assign(
    choices: np.ndarray,
    confidence_order: np.ndarray,
    n_lists: int,
    cap: int,
) -> np.ndarray:
    """Capacity-bounded list assignment (host-side, build time).

    Plain nearest-centroid assignment over real corpora is heavily skewed,
    and the IVF member table is dense: its width is the *longest* list, so
    every query pays the skew in padded candidate slots.  Bounding every
    list at ``cap`` members keeps the table width near the mean.

    Rows are admitted to their most-preferred list with free capacity,
    confident rows first.  Rows exhausting all ``m`` choices spill into
    whatever lists still have spare capacity, lowest-indexed first.

    Args:
      choices:          (N, m) int centroid preference order per row.
      confidence_order: (N,) row indices, most-confident first.
      n_lists:          number of lists.
      cap:              max members per list; needs n_lists * cap >= N.

    Returns:
      (N,) int32 list assignment.
    """
    n, m = choices.shape
    if n_lists * cap < n:
        raise ValueError(f"cap {cap} x {n_lists} lists cannot hold {n} rows")
    assign = np.full(n, -1, np.int32)
    counts = np.zeros(n_lists, np.int64)
    rank = np.empty(n, np.int64)
    rank[confidence_order] = np.arange(n)
    remaining = confidence_order.copy()
    for j in range(m):
        if remaining.size == 0:
            break
        pref = choices[remaining, j]
        # stable-sort by list, keeping confidence order within each list,
        # then admit each list's first (cap - occupancy) rows
        by_list = np.argsort(pref, kind="stable")
        pref_sorted = pref[by_list]
        group_start = np.searchsorted(pref_sorted, pref_sorted)
        pos_in_group = np.arange(remaining.size) - group_start
        admit = pos_in_group < (cap - counts[pref_sorted])
        rows = remaining[by_list[admit]]
        assign[rows] = pref_sorted[admit]
        np.add.at(counts, pref_sorted[admit], 1)
        remaining = remaining[by_list[~admit]]
        remaining = remaining[np.argsort(rank[remaining])]  # restore order
    if remaining.size:
        free = np.repeat(np.arange(n_lists), cap - counts)
        assign[remaining] = free[: remaining.size].astype(np.int32)
    return assign


def pack_lists(
    assign: np.ndarray,
    n_lists: int,
    *,
    ids: Optional[np.ndarray] = None,
    spare: int = 0,
    round_pow2: bool = False,
) -> np.ndarray:
    """Pack a (N,) list assignment into a dense -1-padded member table.

    Args:
      assign:     (N,) int list assignment.
      n_lists:    number of lists.
      ids:        (N,) global ids to store (default ``arange(N)``).
      spare:      reserved free slots per list beyond the max occupancy
                  (incremental appends land here between rebuilds).
      round_pow2: round the table width up to a power of two (shape
                  stability across rebuilds).

    Returns:
      (n_lists, width) int32 member table, -1 padded.
    """
    n = len(assign)
    if ids is None:
        ids = np.arange(n)
    counts = np.bincount(assign, minlength=n_lists)
    width = max(int(counts.max()) if n else 0, 0) + int(spare)
    width = max(width, 1)
    if round_pow2:
        width = 1 << (width - 1).bit_length()
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    table = np.full((n_lists, width), -1, np.int32)
    sorted_lists = assign[order]
    table[sorted_lists, np.arange(n) - starts[sorted_lists]] = ids[order]
    return table


def kmeans(db: Array, n_lists: int, *, n_iter: int = 10, seed: int = 0) -> Array:
    """Lloyd's k-means over db rows. Returns (n_lists, D) float32 centroids.

    The initial centroids are ``n_lists`` distinct rows drawn by a
    ``torch.Generator`` seeded from ``seed``; cluster sums accumulate with
    ``index_add_`` (no one-hot matrix), and an empty cluster keeps its
    centroid.
    """
    from repro_torch.core.pq import _lloyd

    gen = torch.Generator().manual_seed(int(seed))
    init = torch.randperm(db.shape[0], generator=gen)[:n_lists]
    cents = db[init.to(db.device)].to(torch.float32)
    return _lloyd(db, cents, n_iter)


def build_ivf(
    db: Array, n_lists: int, *, seed: int = 0, n_iter: int = 10
) -> Dict[str, Array]:
    """Build an IVF index: centroids + a dense (n_lists, max_len) -1-padded
    member table (plain nearest-centroid assignment, through the same
    `balanced_assign` + `pack_lists` path the engine backend uses)."""
    cents = kmeans(db, n_lists, seed=seed, n_iter=n_iter)
    s = T.l2_scores(db.to(torch.float32), cents)
    choices = torch.argmin(s, dim=1).cpu().numpy()[:, None]
    n = choices.shape[0]
    assign_np = balanced_assign(choices, np.arange(n), n_lists, cap=n)
    table = pack_lists(assign_np, n_lists)
    return {
        "centroids": cents,
        "lists": torch.as_tensor(table, device=db.device),
        "assign": torch.as_tensor(assign_np.astype(np.int32),
                                  device=db.device),
    }


def _smallest_cols(s: Array, k: int) -> Array:
    """Columns of the k smallest entries per row, ties to the lower column
    (the order ``lax.top_k`` gives)."""
    return torch.sort(s, dim=1, stable=True).indices[:, :k]


def _probe(q: Array, centroids: Array, n_probe: int, metric: str,
           cent_sq: Optional[Array]) -> Array:
    """(Q, n_probe) int32 nearest lists, nearest first."""
    d_probe = centroids.shape[1]
    cs = T._METRICS[metric](q[:, :d_probe], centroids, cent_sq)
    return _smallest_cols(cs, min(n_probe, centroids.shape[0])).to(torch.int32)


def ivf_search(
    q: Array, db: Array, ivf: Dict[str, Array], *, n_probe: int, k: int,
    dim: Optional[int] = None, valid: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """IVF-Flat search: probe ``n_probe`` nearest lists, exact-scan their
    members (plain PyTorch; ``dim`` truncates probing and scan)."""
    d = dim or db.shape[1]
    qd = q[:, :d]
    probe = _probe(qd, ivf["centroids"][:, :d], n_probe, "l2", None)
    cand = ivf["lists"][probe.long()].reshape(q.shape[0], -1)
    return T.rescore_candidates(qd, db[:, :d], cand, dim=d, k=k, valid=valid)


def ivf_progressive_search(
    q: Array, db: Array, ivf: Dict[str, Array], *, n_probe: int, k: int,
    d_probe: int, d_final: int, valid: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """IVF probing at truncated dims + exact rescore at full dims."""
    _, cand = ivf_search(q, db, ivf, n_probe=n_probe, k=k * 8,
                         dim=d_probe, valid=valid)
    return T.rescore_candidates(q, db, cand, dim=d_final, k=k, valid=valid)


def _sched_search(q, db, centroids, lists, sched, *, n_probe, valid,
                  sq_prefix, index_dims, extra_cand, metric, cent_sq,
                  stage0_only, impl):
    from repro_torch.core.progressive import rescore_ladder

    s0 = sched.stages[0]
    probe = _probe(q, centroids, n_probe, metric, cent_sq)
    cand = lists[probe.long()].reshape(q.shape[0], -1)  # (Q, n_probe*max_len)
    cand = T.inject_candidates(cand, extra_cand)
    if cand.shape[1] < s0.k:
        # the top-k needs k <= C; -1 columns score +inf and change nothing
        cand = torch.nn.functional.pad(cand, (0, s0.k - cand.shape[1]),
                                       value=-1)
    if stage0_only:
        # fenced split: probing produced candidates but no scores — the
        # ladder (ALL schedule stages, scores=None) finishes the search
        return None, cand
    # the probed members replace the stage-0 full scan; every schedule
    # stage (stage 0 included) is a rescore over them
    return rescore_ladder(q, db, cand, sched.stages, sq_prefix=sq_prefix,
                          index_dims=index_dims, valid=valid, metric=metric,
                          impl=impl)


def ivf_progressive_search_sched(
    q: Array,
    db: Array,
    centroids: Array,
    lists: Array,
    sched: ProgressiveSchedule,
    *,
    n_probe: int,
    valid: Optional[Array] = None,
    sq_prefix: Optional[Array] = None,
    index_dims: Optional[tuple] = None,
    extra_cand: Optional[Array] = None,
    metric: str = "l2",
    cent_sq: Optional[Array] = None,
    stage0_only: bool = False,
) -> Tuple[Array, Array]:
    """Full progressive schedule with IVF probing replacing the stage-0 scan.

    Probing runs at the centroids' own dimensionality; probed members —
    plus optional ``extra_cand`` rows (the engine's un-indexed tail
    window) — are rescored through the schedule's stages at full precision
    (the rescore kernel on CUDA tensors).  On CUDA the candidate table
    (n_probe·max_len + tail) must fit the rescore kernel's ``MAX_C``.

    Args:
      centroids:  (n_lists, d_probe) coarse quantizer; d_probe <= q dim.
      lists:      (n_lists, max_len) int32 member table, -1 padded.
      extra_cand: optional (E,) int32 ids injected into every query's
                  candidate list (-1 padded); disjoint from list members.
      valid:      optional (N,) bool row mask threaded through every stage.
      cent_sq:    optional (n_lists,) precomputed centroid squared norms.
    """
    from repro_torch.kernels import ops
    return _sched_search(
        q, db, centroids, lists, sched, n_probe=n_probe, valid=valid,
        sq_prefix=sq_prefix, index_dims=index_dims, extra_cand=extra_cand,
        metric=metric, cent_sq=cent_sq, stage0_only=stage0_only, impl=ops)


def ivf_progressive_search_sched_plain(
    q: Array, db: Array, centroids: Array, lists: Array,
    sched: ProgressiveSchedule, *, n_probe: int,
    valid: Optional[Array] = None, sq_prefix: Optional[Array] = None,
    index_dims: Optional[tuple] = None, extra_cand: Optional[Array] = None,
    metric: str = "l2", cent_sq: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """``ivf_progressive_search_sched`` through the plain versions on any
    device — a reference only; the serving path never calls it."""
    from repro_torch.kernels import ops
    return _sched_search(
        q, db, centroids, lists, sched, n_probe=n_probe, valid=valid,
        sq_prefix=sq_prefix, index_dims=index_dims, extra_cand=extra_cand,
        metric=metric, cent_sq=cent_sq, stage0_only=False, impl=ops.plain)


def _kernel_search(q, db, centroids, lists, sched, *, n_probe, valid,
                   sq_prefix, index_dims, extra_cand, metric, cent_sq, pack,
                   pq_oversample, stage0_only, impl):
    from repro_torch.core.progressive import rescore_ladder

    s0 = sched.stages[0]
    probe = _probe(q, centroids, n_probe, metric, cent_sq)

    # the raw member table and the live bits: the scan skips list padding
    # (-1) and tombstoned ids (the packed member vectors are a build-time
    # snapshot); the plain versions mask the table first, the kernels read
    # ``valid`` per slot
    if pack["dtype"] == "pq":
        # oversampled survivor pool: the classic PQ remedy for ADC ranking
        # noise — the full-precision rescore ladder cuts it back
        k0_eff = s0.k * pq_oversample
        scores, cand = impl.pq_ivf_scan_topk(q, probe, lists, pack, k=k0_eff,
                                             valid=valid)
    else:
        k0_eff = s0.k
        scores, cand = impl.ivf_scan_topk(q, probe, lists, pack, k=k0_eff,
                                          valid=valid)

    if extra_cand is not None:
        # the un-indexed tail window competes in stage 0 exactly as the
        # sched path's inject_candidates placement: rescore the (few) tail
        # rows at the stage-0 dim and fold them into the scan's top-k; the
        # stable sort keeps scanned rows ahead of tail rows on equal scores
        e = extra_cand.shape[0]
        tail_tbl = extra_cand[None, :].expand(q.shape[0], e).contiguous()
        ts, ti = impl.rescore_candidates(
            q, db, tail_tbl, dim=s0.dim, k=min(k0_eff, e),
            db_sq_at_dim=lookup_prefix(sq_prefix, index_dims, s0.dim),
            valid=valid, metric=metric,
        )
        cat_s = torch.cat([scores, ts], dim=1)
        cat_i = torch.cat([cand, ti], dim=1)
        order = _smallest_cols(cat_s, k0_eff)
        scores = torch.gather(cat_s, 1, order)
        cand = torch.gather(cat_i, 1, order)

    if stage0_only:
        return scores, cand
    return rescore_ladder(q, db, cand, sched.stages[1:], sq_prefix=sq_prefix,
                          index_dims=index_dims, valid=valid, metric=metric,
                          scores=scores, impl=impl)


def ivf_progressive_search_kernel(
    q: Array,
    db: Array,
    centroids: Array,
    lists: Array,
    sched: ProgressiveSchedule,
    *,
    n_probe: int,
    valid: Optional[Array] = None,
    sq_prefix: Optional[Array] = None,
    index_dims: Optional[tuple] = None,
    extra_cand: Optional[Array] = None,
    metric: str = "l2",
    cent_sq: Optional[Array] = None,
    pack: Optional[Dict] = None,
    block_m: int = 128,
    pq_oversample: int = 1,
    stage0_only: bool = False,
) -> Tuple[Array, Array]:
    """`ivf_progressive_search_sched` with the IVF scan kernel as stage 0.

    Same results (identical top-k id sets under fixed probes), but stage 0
    runs `repro_torch.kernels.ivf_scan.ivf_scan_topk` — or, for
    ``dtype='pq'`` packs, `repro_torch.kernels.pq_scan.pq_ivf_scan_topk` —
    over the probed lists' list-major member slabs, instead of gathering a
    candidate table and rescoring it.  The tail ``extra_cand`` window is
    rescored at the stage-0 dim and merged into the scan's top-k.

    Extra args over the sched path:
      pack:          `pack_ivf_lists` build artifact (member slabs at the
                     stage-0 dim; packed on the fly when None, which costs
                     a full gather).
      block_m:       slab padding of on-the-fly packs.
      pq_oversample: 'pq' packs only — the stage-0 survivor pool widens to
                     ``pq_oversample × k0``.
    """
    from repro_torch.kernels import ops
    pack = _pack_for(db, lists, sched, sq_prefix, index_dims, metric, pack,
                     block_m)
    return _kernel_search(
        q, db, centroids, lists, sched, n_probe=n_probe, valid=valid,
        sq_prefix=sq_prefix, index_dims=index_dims, extra_cand=extra_cand,
        metric=metric, cent_sq=cent_sq, pack=pack,
        pq_oversample=pq_oversample, stage0_only=stage0_only, impl=ops)


def ivf_progressive_search_kernel_plain(
    q: Array, db: Array, centroids: Array, lists: Array,
    sched: ProgressiveSchedule, *, n_probe: int,
    valid: Optional[Array] = None, sq_prefix: Optional[Array] = None,
    index_dims: Optional[tuple] = None, extra_cand: Optional[Array] = None,
    metric: str = "l2", cent_sq: Optional[Array] = None,
    pack: Optional[Dict] = None, block_m: int = 128, pq_oversample: int = 1,
) -> Tuple[Array, Array]:
    """``ivf_progressive_search_kernel`` through the plain versions on any
    device — the reference for checking the kernels; the serving path
    never calls it."""
    from repro_torch.kernels import ops
    pack = _pack_for(db, lists, sched, sq_prefix, index_dims, metric, pack,
                     block_m)
    return _kernel_search(
        q, db, centroids, lists, sched, n_probe=n_probe, valid=valid,
        sq_prefix=sq_prefix, index_dims=index_dims, extra_cand=extra_cand,
        metric=metric, cent_sq=cent_sq, pack=pack,
        pq_oversample=pq_oversample, stage0_only=False, impl=ops.plain)


def _pack_for(db, lists, sched, sq_prefix, index_dims, metric, pack,
              block_m):
    if metric != "l2":
        raise ValueError(
            f"the fused IVF kernel scores L2 only, got metric={metric!r} "
            f"(use ivf_progressive_search_sched)")
    if pack is not None:
        return pack
    from repro_torch.kernels.ivf_scan import pack_ivf_lists
    s0 = sched.stages[0]
    return pack_ivf_lists(
        db, lists, dim=s0.dim,
        db_sq_at_dim=lookup_prefix(sq_prefix, index_dims, s0.dim),
        block_m=block_m)
