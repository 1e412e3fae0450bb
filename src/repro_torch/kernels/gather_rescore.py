"""The rescore ladder in one launch: wrapper for the CUDA kernel.

Replaces the TPU kernel ``gather_rescore`` of the JAX package
(``src/repro/kernels/gather_rescore.py:98``, body ``:41``, ``pallas_call``
``:128``) together with the top-k of ``gather_rescore_topk`` (``:150``),
for every stage of progressive search's rescore ladder at once
(`rescore_ladder_topk`); one step (`gather_rescore_topk`, the IVF tail
injection's call) is the one-stage case of the same kernel.  The kernel
(``csrc/gather_rescore.cu``) gathers each query's candidate rows straight
from device memory — the (Q, C, dim) gathered tensor is never built —
keeps each stage's survivors in shared memory in rank order, carries each
survivor's dot product (and row norm) to the next stage, so a row's prefix
is read once up to its deepest dim, and writes only the last stage's
(Q, k).

Bound on an H100 SXM at the flat serving dispatch (32 queries, five
stages from (C, dim) = (64, 256) to (10, 3584)): about 7.5 MB, 2.2 µs at
3.35 TB/s.  Launch latency and the chain gather → reduce → select of each
stage are what a call costs; one cluster of CTAs per query
(`cluster_size`) spreads a stage's rows over more SMs than there are
queries.

On CPU tensors the wrappers run the plain versions (the chained steps of
`gather_rescore_topk_plain`); on a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import truncated as T
from repro_torch.kernels import _build

Tensor = torch.Tensor

#: Largest candidate count per query (survivors and scores sit in shared
#: memory; the rank-count selection is quadratic in it).
MAX_C = 4096
#: Most stages one launch runs (the argument block's per-stage arrays).
MAX_STAGES = 8
#: Most CTAs a cluster (a query) takes: the portable cluster size.
MAX_CLUSTER = 8
#: Dims of one (candidate, chunk) work item; the kernel adds the chunks'
#: partial sums in order, so the arithmetic depends on the dims alone.
CHUNK = 512
#: Chunk partials a CTA buffers (a stage with more runs in waves).
PARTIALS = 4096

#: Calls that launched the kernel on the card, in all and by kind:
#: ``ladder`` (two or more stages in the launch) and ``step`` (one).
launches = 0
launches_by_kernel: Dict[str, int] = {"ladder": 0, "step": 0}

# LadderArgs of csrc/gather_rescore.cu: q, db, cand, sq, valid, out_s,
# out_i, stream; ld_q, ld_db, ld_sq, sq_cs, nq, n, c, n_stages, cluster,
# vec, nrm, b_cap, p_cap; dim[8], k[8], sq_col[8]; the tail padding of a
# struct aligned to 8 bytes
_ARGS = struct.Struct(f"@8Q13i{3 * MAX_STAGES}i4x")
_lib = None
_fn = None
_local = threading.local()        # a packing buffer for each thread
_sms: Dict[int, int] = {}


def _kernel():
    global _lib, _fn
    if _fn is None:
        lib = _build.library("gather_rescore")
        size = lib.rescore_ladder_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != _ARGS.size:
            raise RuntimeError(f"gather_rescore: the library's argument "
                               f"block is {size()} bytes, the wrapper packs "
                               f"{_ARGS.size}")
        fn = lib.rescore_ladder_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        _lib, _fn = lib, fn
    return _fn


def _args_buffer():
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = ctypes.create_string_buffer(_ARGS.size)
        _local.addr = ctypes.addressof(buf)
    return buf, _local.addr


def cluster_size(nq: int, sms: int) -> int:
    """CTAs a query takes: as many as fill the SMs with one CTA each, 1 to
    `MAX_CLUSTER` (32 queries on 132 SMs: 4)."""
    return max(1, min(MAX_CLUSTER, sms // max(nq, 1)))


@functools.lru_cache(maxsize=256)
def plan(c: int, stages: Tuple[Tuple[int, int], ...]) -> Tuple[int, int]:
    """(entries of the second survivor buffer, entries of the partial
    buffer) of a launch: the larger k of the stages whose survivors go to
    it, and the most (candidate, chunk) items of a stage, capped at
    `PARTIALS`."""
    b_cap = max((k for _, k in stages[:-1]), default=0)
    items, cin, prev = 1, c, 0
    for dim, k in stages:
        lo = prev if 0 < prev < dim else 0
        items = max(items, cin * -(-(dim - lo) // CHUNK))
        cin, prev = k, dim
    return b_cap, min(items, PARTIALS)


def gather_rescore_topk_plain(
    q: Tensor, db: Tensor, cand: Tensor, *, dim: int, k: int,
    sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """One step in plain PyTorch (any device)."""
    return T.rescore_candidates(q, db, cand, dim=dim, k=k,
                                db_sq_at_dim=sq_at_dim, valid=valid)


def rescore_ladder_topk_plain(
    q: Tensor, db: Tensor, cand: Tensor, stages: Sequence[Tuple[int, int]],
    *, sq_prefix: Optional[Tensor] = None,
    sq_cols: Optional[Sequence[Optional[int]]] = None,
    valid: Optional[Tensor] = None, metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """The ladder in plain PyTorch (any device): the plain step chained
    over ``stages``, each fed the one before's ids in rank order."""
    scores = None
    for j, (dim, k) in enumerate(stages):
        col = None if sq_cols is None else sq_cols[j]
        scores, cand = T.rescore_candidates(
            q, db, cand, dim=dim, k=k,
            db_sq_at_dim=None if col is None else sq_prefix[:, col],
            valid=valid, metric=metric)
    return scores, cand


def rescore_ladder_mirror(
    q: Tensor, db: Tensor, cand: Tensor, stages: Sequence[Tuple[int, int]],
    *, sq_prefix: Optional[Tensor] = None,
    sq_cols: Optional[Sequence[Optional[int]]] = None,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The kernel's arithmetic in plain PyTorch, for checking it on the
    CPU: survivors carried in rank order with their dot products and
    norms; a stage deeper than the one before adds only its new dims, in
    `CHUNK`-dim partial sums added in chunk order; a slot with no finite
    score carries id -1 into every later stage."""
    nq, c = cand.shape
    n = db.shape[0]
    ids = cand.long()
    dot = torch.zeros((nq, c), dtype=torch.float32)
    nrm = torch.zeros((nq, c), dtype=torch.float32)
    prev, s = 0, None
    for j, (dim, k) in enumerate(stages):
        lo = prev if 0 < prev < dim else 0
        if lo == 0:
            dot, nrm = torch.zeros_like(dot), torch.zeros_like(nrm)
        ok = (ids >= 0) & (ids < n)
        safe = torch.where(ok, ids, 0)
        if valid is not None:
            ok &= valid[safe]
        for d0 in range(lo, dim, CHUNK):
            x = db[safe, d0:min(dim, d0 + CHUNK)].to(torch.float32)
            dot = dot + (x * q[:, None, d0:min(dim, d0 + CHUNK)]).sum(-1)
            nrm = nrm + (x * x).sum(-1)
        col = None if sq_cols is None else sq_cols[j]
        norm = nrm if col is None else sq_prefix[safe, col]
        s = (norm - 2.0 * dot).masked_fill(~ok, float("inf"))
        s = s.nan_to_num(nan=float("inf"), posinf=float("inf"),
                         neginf=float("-inf"))
        order = torch.sort(s, dim=1, stable=True).indices[:, :k]
        s = torch.gather(s, 1, order)
        ids = torch.where(s < float("inf"), torch.gather(ids, 1, order),
                          torch.full_like(order, -1))
        dot, nrm = torch.gather(dot, 1, order), torch.gather(nrm, 1, order)
        prev = dim
    return s, ids.to(torch.int32)


def _check(q, db, cand, stages, sq, sq_cols, valid):
    if q.device.type != "cuda" or db.device != q.device \
            or cand.device != q.device:
        raise ValueError(f"q, db and cand must share one CUDA device, got "
                         f"{q.device}, {db.device}, {cand.device}")
    if q.dtype != torch.float32 or db.dtype != torch.float32:
        raise ValueError(f"q and db must be float32, got {q.dtype}, {db.dtype}")
    if cand.dtype != torch.int32:
        raise ValueError(f"cand must be int32, got {cand.dtype}")
    if q.dim() != 2 or db.dim() != 2 or cand.dim() != 2 \
            or cand.shape[0] != q.shape[0]:
        raise ValueError(f"need q (Q, D), db (N, D), cand (Q, C); got "
                         f"{tuple(q.shape)}, {tuple(db.shape)}, "
                         f"{tuple(cand.shape)}")
    if q.stride(1) != 1 or db.stride(1) != 1:
        raise ValueError("q and db need a contiguous last dimension")
    if not cand.is_contiguous():
        raise ValueError("cand must be contiguous")
    c = cand.shape[1]
    if c > MAX_C:
        raise ValueError(f"{c} candidates per query exceed the kernel's {MAX_C}")
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"{len(stages)} stages outside [1, {MAX_STAGES}]")
    width, cin = min(q.shape[1], db.shape[1]), c
    for dim, k in stages:
        if not 1 <= dim <= width:
            raise ValueError(f"dim={dim} outside [1, {width}]")
        if not 1 <= k <= cin:
            raise ValueError(f"k={k} outside [1, C={cin}]")
        cin = k
    n = db.shape[0]
    if sq is not None:
        if sq.device != db.device or sq.dtype != torch.float32 \
                or sq.dim() != 2 or sq.shape[0] != n:
            raise ValueError(f"sq_prefix must be a ({n}, n_dims) float32 "
                             f"tensor on {db.device}, got {tuple(sq.shape)} "
                             f"{sq.dtype} on {sq.device}")
        if any(col is not None and not 0 <= col < sq.shape[1]
               for col in sq_cols):
            raise ValueError(f"sq_cols {list(sq_cols)} outside the "
                             f"{sq.shape[1]} columns of sq_prefix")
    if valid is not None and (valid.device != db.device
                              or valid.dtype != torch.bool
                              or tuple(valid.shape) != (n,)
                              or (n > 1 and valid.stride(0) != 1)):
        raise ValueError(f"valid must be a contiguous ({n},) bool tensor on "
                         f"{db.device}, got {tuple(valid.shape)} "
                         f"{valid.dtype} on {valid.device}")


def _launch(q, db, cand, stages, sq, sq_cols, valid, cluster):
    """Check, pack the argument block, launch once; returns (Q, k_last)."""
    global launches
    _check(q, db, cand, stages, sq, sq_cols, valid)
    nq, c = cand.shape
    dev = q.device
    k_last = stages[-1][1]
    out_s = torch.empty((nq, k_last), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k_last), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    if sq is None:
        sq_cols = [None] * len(stages)
    cols = [-1 if col is None else int(col) for col in sq_cols]
    nrm = any(col < 0 for col in cols)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if cluster is None:
        sms = _sms.get(idx)
        if sms is None:
            sms = _sms[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
        cluster = cluster_size(nq, sms)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster={cluster} outside [1, {MAX_CLUSTER}]")
    b_cap, p_cap = plan(c, stages)
    dims = [d for d, _ in stages]
    vec = (all(d % 4 == 0 for d in dims) and q.stride(0) % 4 == 0
           and db.stride(0) % 4 == 0 and q.data_ptr() % 16 == 0
           and db.data_ptr() % 16 == 0)
    pad = [0] * (MAX_STAGES - len(stages))
    fn = _kernel()
    buf, addr = _args_buffer()
    _ARGS.pack_into(
        buf, 0, q.data_ptr(), db.data_ptr(), cand.data_ptr(),
        0 if sq is None else sq.data_ptr(),
        0 if valid is None else valid.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch._C._cuda_getCurrentRawStream(idx),
        q.stride(0), db.stride(0), *((0, 0) if sq is None else sq.stride()),
        nq, db.shape[0], c, len(stages), cluster, int(vec), int(nrm),
        b_cap, p_cap, *dims, *pad, *[k for _, k in stages], *pad,
        *cols, *pad)
    _build.check(_lib, fn(addr), "rescore_ladder")
    launches += 1
    launches_by_kernel["ladder" if len(stages) > 1 else "step"] += 1
    return out_s, out_i


def rescore_ladder_topk(
    q: Tensor, db: Tensor, cand: Tensor, stages: Sequence[Tuple[int, int]],
    *, sq_prefix: Optional[Tensor] = None,
    sq_cols: Optional[Sequence[Optional[int]]] = None,
    valid: Optional[Tensor] = None, cluster: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Every stage of a rescore ladder in one launch.

    Args:
      q:         (Q, D) float32 queries.
      db:        (Ncap, D) float32 rows.
      cand:      (Q, C) int32 row ids, -1 = padding.
      stages:    (dim, k) of each stage, in order: stage s scores the k of
                 stage s - 1 (the C of ``cand`` for the first) at ``dim``
                 dims and keeps k; 1 <= k <= its input.
      sq_prefix: optional (Ncap, n_dims) float32 prefix squared norms (any
                 strides: the store keeps each column contiguous).
      sq_cols:   per stage, the column of ``sq_prefix`` holding the norms at
                 its dim, or None (the norm is summed from the rows).
      valid:     optional (Ncap,) bool; candidates on False rows score +inf.
      cluster:   CTAs a query (`cluster_size` when None); the result does
                 not depend on it.

    Returns:
      ((Q, k) float32 ascending, (Q, k) int32 row ids) of the last stage;
      equal scores keep the lower position in the stage's input (the
      previous stage's rank), and a slot with no finite score is (+inf, -1),
      as the plain steps chained give.
    """
    stages = tuple((int(d), int(k)) for d, k in stages)
    if _build.off_card(q, db, cand):
        return rescore_ladder_topk_plain(q, db, cand, stages,
                                         sq_prefix=sq_prefix, sq_cols=sq_cols,
                                         valid=valid)
    if sq_prefix is not None and sq_cols is None:
        raise ValueError("sq_prefix needs sq_cols")
    return _launch(q, db, cand, stages, sq_prefix, sq_cols, valid, cluster)


def gather_rescore_topk(
    q: Tensor, db: Tensor, cand: Tensor, *, dim: int, k: int,
    sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Rescore each query's own candidate rows at ``dim`` dims; keep the best k.

    The one-stage case of `rescore_ladder_topk`.

    Args:
      q:         (Q, D) float32 queries.
      db:        (Ncap, D) float32 rows.
      cand:      (Q, C) int32 row ids, -1 = padding.
      dim:       scoring dimensionality.
      k:         candidates kept, 1 <= k <= C.
      sq_at_dim: optional (Ncap,) float32 prefix squared norms at ``dim``
                 (looked up as ``sq_at_dim[cand]``, any stride); computed
                 from the gathered rows when None.
      valid:     optional (Ncap,) bool; candidates on False rows score +inf.

    Returns:
      ((Q, k) float32 ascending, (Q, k) int32 row ids ``cand[q, pos]``);
      equal scores keep the lower position in ``cand``, and a slot with no
      finite score is (+inf, -1).
    """
    if _build.off_card(q, db, cand):
        return gather_rescore_topk_plain(q, db, cand, dim=dim, k=k,
                                         sq_at_dim=sq_at_dim, valid=valid)
    sq = None
    if sq_at_dim is not None:
        if sq_at_dim.dim() != 1:
            raise ValueError(f"sq_at_dim must be (Ncap,), got "
                             f"{tuple(sq_at_dim.shape)}")
        sq = sq_at_dim[:, None]          # stride (s, 1): column 0
    return _launch(q, db, cand, ((int(dim), int(k)),), sq, [0], valid, None)
