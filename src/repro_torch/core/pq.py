"""Product-quantized stage 0 — the compression frontier past int8.

The stage-0 block is split into ``M`` subspaces of ``dsub = Ds/M`` dims,
each k-means-quantized to ``C ≤ 256`` centroids, so a row's sketch is ``M``
uint8 codes — **M bytes/row** against ``Ds`` for int8 and ``4·Ds`` for f32.
Queries never decode rows: an **asymmetric-distance (ADC)** lookup table of
the query's distance to every centroid of every subspace (``(M, C)``
floats, resident in shared memory in the CUDA scan kernel) turns scoring a
row into ``M`` table lookups, and the full-precision progressive rescore
absorbs the quantization noise exactly the way it absorbs truncation noise.

Rank-equivalence convention: ADC tables drop the per-query ``‖q‖²``
constant — ``lut[m, c] = ‖c‖² − 2·q_m·c`` — so ADC sums are directly
comparable with `truncated.l2_scores` / `rescore_candidates` outputs and
exact tail-window rescores merge into a PQ top-k without a unit mismatch.

Codebook training draws its initial centroids from a ``torch.Generator``
seeded from ``seed`` (the JAX package draws them from ``jax.random``; the
two give different codebooks from the same seed, so parity with it is
tested on carried-over codebooks).

    idx = build_pq_index(db, sched, m=8)
    scores, ids = pq_progressive_search(q, idx, sched)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import truncated as T
from repro_torch.core.schedule import ProgressiveSchedule

Array = torch.Tensor


def auto_pq_m(d0: int) -> int:
    """Default subspace count for a ``d0``-dim stage-0 block: aim dsub = 8.

    ``d0 // 8`` when that divides evenly (8-dim subspaces quantize well at
    256 codes); otherwise a single subspace — coarse, but the progressive
    rescore runs at full precision either way, and an explicit ``pq_m`` is
    always available.
    """
    if d0 >= 16 and d0 % 8 == 0:
        return d0 // 8
    return 1


def pq_dims(codebooks: Array) -> Tuple[int, int, int]:
    """(M, C, dsub) of a codebook tensor."""
    m, c, dsub = codebooks.shape
    return int(m), int(c), int(dsub)


def pq_cent_sq(codebooks: Array) -> Array:
    """(M, C) squared centroid norms — the ADC tables' constant term."""
    cb = codebooks.to(torch.float32)
    return (cb * cb).sum(dim=-1)


def _lloyd(x: Array, cents: Array, n_iter: int) -> Array:
    """``n_iter`` Lloyd steps from ``cents``; cluster sums by ``index_add_``
    (no one-hot matrix).  An empty cluster keeps its centroid."""
    x = x.to(torch.float32)
    n_c = cents.shape[0]
    for _ in range(n_iter):
        assign = torch.argmin(T.l2_scores(x, cents), dim=1)
        counts = torch.bincount(assign, minlength=n_c).to(torch.float32)
        sums = torch.zeros_like(cents).index_add_(0, assign, x)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def train_pq(
    x: Array, *, m: int, n_codes: int = 256, n_iter: int = 10, seed: int = 0
) -> Array:
    """Train PQ codebooks: independent k-means per subspace.

    Args:
      x:       (N, Ds) training rows (live corpus rows; Ds % m == 0).
      m:       subspace count.
      n_codes: centroids per subspace (≤ 256 so codes fit uint8).
      n_iter:  Lloyd iterations.
      seed:    seeds the ``torch.Generator`` the initial centroids are
               drawn from (one draw per subspace, in order).

    Returns:
      (m, n_codes, Ds//m) float32 codebooks on ``x``'s device.

    Subspaces are fit one after another, so peak memory is one (N, n_codes)
    assignment matrix.  When N < n_codes the init samples with replacement
    — duplicate centroids are harmless (encoding ties break to the lowest
    code) and keep every shape fixed across corpus sizes.
    """
    if n_codes > 256:
        raise ValueError(f"n_codes must be <= 256 (uint8 codes), got {n_codes}")
    n, ds = x.shape
    if ds % m:
        raise ValueError(f"stage-0 dim {ds} is not divisible by pq m={m}")
    dsub = ds // m
    gen = torch.Generator().manual_seed(int(seed))
    subs = x.to(torch.float32).reshape(n, m, dsub)
    out = []
    for j in range(m):
        if n < n_codes:
            init = torch.randint(0, n, (n_codes,), generator=gen)
        else:
            init = torch.randperm(n, generator=gen)[:n_codes]
        sub = subs[:, j, :]
        out.append(_lloyd(sub, sub[init.to(x.device)], n_iter))
    return torch.stack(out)


def _encode_block(x: Array, codebooks: Array, cent_sq: Array) -> Array:
    m, _, dsub = codebooks.shape
    xs = x.to(torch.float32).reshape(x.shape[0], m, dsub)
    ip = torch.einsum("nmd,mcd->nmc", xs, codebooks.to(torch.float32))
    s = cent_sq[None, :, :] - 2.0 * ip                 # rank-equivalent
    return torch.argmin(s, dim=-1).to(torch.uint8)


def pq_encode(x: Array, codebooks: Array, *, block_n: int = 8192) -> Array:
    """Encode rows to (N, M) uint8 codes (nearest centroid per subspace;
    ties to the lowest code).

    Blocked over rows so the (block, M, C) assignment scores never
    materialize for the whole corpus at once.
    """
    cent_sq = pq_cent_sq(codebooks)
    n = x.shape[0]
    if n <= block_n:
        return _encode_block(x, codebooks, cent_sq)
    return torch.cat([_encode_block(x[lo: lo + block_n], codebooks, cent_sq)
                      for lo in range(0, n, block_n)])


def pq_decode(codes: Array, codebooks: Array) -> Array:
    """Reconstruct (N, Ds) float32 rows from (N, M) codes."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codes.device)[None, :]
    rows = codebooks.to(torch.float32)[sub, codes.long()]   # (N, M, dsub)
    return rows.reshape(codes.shape[0], -1)


def pq_lut(q: Array, codebooks: Array, cent_sq: Optional[Array] = None) -> Array:
    """Per-query ADC lookup tables: (Q, M, C) rank-equivalent distances.

    ``lut[q, m, c] = ‖c‖² − 2·q_m·c`` — summing a row's M entries gives the
    rank-equivalent L2 score of the query against that row's
    *reconstruction* (`pq_decode`).
    """
    m, _, dsub = codebooks.shape
    if cent_sq is None:
        cent_sq = pq_cent_sq(codebooks)
    qs = q.to(torch.float32).reshape(q.shape[0], m, dsub)
    ip = torch.einsum("qmd,mcd->qmc", qs, codebooks.to(torch.float32))
    return cent_sq[None, :, :] - 2.0 * ip


def pq_adc_scores(lut: Array, codes: Array) -> Array:
    """(Q, N) ADC scores: M table lookups per row, summed over m in order
    (the order the CUDA scan kernel sums in), no decode."""
    idx = codes.long()
    acc = lut[:, 0, :][:, idx[:, 0]]
    for j in range(1, idx.shape[1]):
        acc = acc + lut[:, j, :][:, idx[:, j]]
    return acc


def build_pq_index(
    db: Array,
    sched: ProgressiveSchedule,
    *,
    m: Optional[int] = None,
    n_codes: int = 256,
    n_iter: int = 10,
    train_rows: int = 65536,
    valid: Optional[Array] = None,
    seed: int = 0,
) -> Dict[str, Array]:
    """Stage-0 PQ code block + full-precision corpus + codebooks.

    Codebooks are fit on (a bounded sample of) live rows only — the sample
    is drawn with numpy's generator exactly as the JAX package draws it;
    codes are emitted for every buffer row (dead/unpopulated slots are
    masked at search time).
    """
    ds = sched.stages[0].dim
    m = m or auto_pq_m(ds)
    x = db[:, :ds]
    n = x.shape[0]
    if valid is not None:
        live = np.nonzero(valid[:n].cpu().numpy())[0]
    else:
        live = np.arange(n)
    if live.size == 0:
        live = np.arange(min(n, 1))
    rng = np.random.default_rng(seed)
    if live.size > train_rows:
        live = np.sort(rng.choice(live, train_rows, replace=False))
    train = x[torch.as_tensor(live, device=db.device)]
    codebooks = train_pq(train, m=m, n_codes=n_codes, n_iter=n_iter,
                         seed=seed)
    codes = pq_encode(x, codebooks)
    return {
        "db": db,
        "codes": codes,                   # (N, M) uint8
        "codebooks": codebooks,           # (M, C, dsub) f32
        "cent_sq": pq_cent_sq(codebooks),  # (M, C) f32
    }


def _stage0_ids(codes: Array, valid: Optional[Array],
                row_limit: Optional[int]) -> Array:
    """(N,) int32 ids with every stage-0-unreturnable slot masked to -1."""
    n0 = codes.shape[0]
    ids = torch.arange(n0, dtype=torch.int32, device=codes.device)
    keep = torch.ones((n0,), dtype=torch.bool, device=codes.device)
    if valid is not None:
        keep = keep & valid[:n0]
    if row_limit is not None:
        keep = keep & (ids < int(row_limit))
    return torch.where(keep, ids, torch.full_like(ids, -1))


def _finish(q, rescore_db, sched, scores, cand, *, valid, extra_cand, metric,
            stage0_only, impl):
    """Shared post-stage-0 path: tail injection + the rescore ladder."""
    from repro_torch.core.progressive import rescore_ladder
    from repro_torch.core.quant import quant_rest_stages

    cand = T.inject_candidates(cand, extra_cand)
    if stage0_only:
        return scores, cand
    rest = quant_rest_stages(sched, extra_cand=extra_cand, valid=valid)
    return rescore_ladder(q, rescore_db, cand, rest, valid=valid,
                          metric=metric, scores=scores, impl=impl)


def _check_l2(metric: str) -> None:
    if metric != "l2":
        raise ValueError(
            f"PQ ADC scores are rank-equivalent L2 distances; got "
            f"metric={metric!r}")


def _lut_of(q, idx):
    cb = idx["codebooks"]
    ds = cb.shape[0] * cb.shape[2]
    return pq_lut(q[:, :ds], cb, idx["cent_sq"])


def pq_progressive_search(
    q: Array, idx: Dict[str, Array], sched: ProgressiveSchedule,
    *, metric: str = "l2",
    db: Optional[Array] = None,
    valid: Optional[Array] = None,
    row_limit: Optional[int] = None,
    extra_cand: Optional[Array] = None,
    oversample: int = 1,
    stage0_only: bool = False,
) -> Tuple[Array, Array]:
    """Progressive search with a plain-PyTorch ADC stage-0 scan (the
    ``use_kernel=False`` route; the ladder still runs the rescore kernel on
    CUDA tensors).

    Stage 0 ranks every coded row by ADC lookup; every later stage rescores
    the survivors at full precision.  ``oversample`` widens the stage-0
    survivor pool to ``oversample × k0`` — the classic PQ remedy for ADC
    ranking noise.  ``db``/``valid``/``row_limit``/``extra_cand`` mean what
    they mean for `repro_torch.core.quant.quantized_progressive_search`.
    """
    from repro_torch.kernels import ops

    _check_l2(metric)
    s0 = sched.stages[0]
    codes = idx["codes"]
    n0 = codes.shape[0]
    scores = pq_adc_scores(_lut_of(q, idx), codes)
    ids = _stage0_ids(codes, valid, row_limit)
    scores = scores.masked_fill(ids[None, :] < 0, float("inf"))
    kk = min(s0.k * oversample, n0)
    top_s, cand = torch.sort(scores, dim=1, stable=True)
    top_s, cand = top_s[:, :kk], cand[:, :kk].to(torch.int32)
    # fully-masked slots must surface the -1 sentinel, not a row id
    cand = torch.where(torch.isfinite(top_s), cand, torch.full_like(cand, -1))
    return _finish(q, idx["db"] if db is None else db, sched, top_s, cand,
                   valid=valid, extra_cand=extra_cand, metric=metric,
                   stage0_only=stage0_only, impl=ops)


def _pq_kernel_search(q, idx, sched, *, metric, db, valid, row_limit,
                      extra_cand, oversample, stage0_only, impl):
    _check_l2(metric)
    s0 = sched.stages[0]
    codes = idx["codes"]
    n0 = codes.shape[0]
    ids = _stage0_ids(codes, valid, row_limit)
    scores, cand = impl.pq_scan_topk(_lut_of(q, idx), codes, ids,
                                     k=min(s0.k * oversample, n0))
    return _finish(q, idx["db"] if db is None else db, sched, scores, cand,
                   valid=valid, extra_cand=extra_cand, metric=metric,
                   stage0_only=stage0_only, impl=impl)


def pq_progressive_search_kernel(
    q: Array, idx: Dict[str, Array], sched: ProgressiveSchedule,
    *, metric: str = "l2",
    db: Optional[Array] = None,
    valid: Optional[Array] = None,
    row_limit: Optional[int] = None,
    extra_cand: Optional[Array] = None,
    oversample: int = 1,
    stage0_only: bool = False,
) -> Tuple[Array, Array]:
    """`pq_progressive_search` with the fused ADC scan kernel as stage 0
    (`repro_torch.kernels.pq_scan.pq_scan_topk`: on CUDA tensors the LUT
    sits in shared memory while the uint8 code rows stream through; on CPU
    tensors its plain version).  Same results as the plain route."""
    from repro_torch.kernels import ops
    return _pq_kernel_search(
        q, idx, sched, metric=metric, db=db, valid=valid,
        row_limit=row_limit, extra_cand=extra_cand, oversample=oversample,
        stage0_only=stage0_only, impl=ops)


def pq_progressive_search_kernel_plain(
    q: Array, idx: Dict[str, Array], sched: ProgressiveSchedule,
    *, metric: str = "l2",
    db: Optional[Array] = None,
    valid: Optional[Array] = None,
    row_limit: Optional[int] = None,
    extra_cand: Optional[Array] = None,
    oversample: int = 1,
) -> Tuple[Array, Array]:
    """``pq_progressive_search_kernel`` through the plain versions on any
    device — the reference for checking the kernels; the serving path
    never calls it."""
    from repro_torch.kernels import ops
    return _pq_kernel_search(
        q, idx, sched, metric=metric, db=db, valid=valid,
        row_limit=row_limit, extra_cand=extra_cand, oversample=oversample,
        stage0_only=False, impl=ops.plain)
