"""Candidate gather + rescore with fused top-k: wrapper for the CUDA kernel.

Replaces the TPU kernel ``gather_rescore`` of the JAX package
(``src/repro/kernels/gather_rescore.py:98``, body ``:41``, ``pallas_call``
``:128``) together with the top-k of ``gather_rescore_topk`` (``:150``):
one step of the rescore ladder.  The kernel (``csrc/gather_rescore.cu``)
gathers each query's candidate rows straight from device memory over their
``[:dim]`` prefix — the (Q, C, dim) gathered tensor is never built — and
selects the top-k in the same launch.

Bound on an H100 SXM at the serving shapes: about 2 MB per step (32 queries,
(C, dim) from (64, 256) to (10, 3584)), well under a microsecond of memory
time, so each launch is bound by launch latency and the per-block chain
gather → reduce → select.  One block per query with a warp per candidate
keeps that chain short; the selection is an exact rank count in shared
memory.

On a CPU tensor the wrapper runs the plain version
(`gather_rescore_topk_plain`); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import truncated as T
from repro_torch.kernels import _build

Tensor = torch.Tensor

#: Largest candidate count per query (scores sit in shared memory and the
#: rank-count selection is quadratic in it).
MAX_C = 4096

#: Calls that launched the kernel on the card.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("gather_rescore")
        fn = lib.gather_rescore_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def gather_rescore_topk_plain(
    q: Tensor, db: Tensor, cand: Tensor, *, dim: int, k: int,
    sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (any device)."""
    return T.rescore_candidates(q, db, cand, dim=dim, k=k,
                                db_sq_at_dim=sq_at_dim, valid=valid)


def _check(q, db, cand, dim, k, sq_at_dim, valid):
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
    if not 1 <= dim <= min(q.shape[1], db.shape[1]):
        raise ValueError(f"dim={dim} outside [1, {min(q.shape[1], db.shape[1])}]")
    c = cand.shape[1]
    if c > MAX_C:
        raise ValueError(f"{c} candidates per query exceed the kernel's {MAX_C}")
    if not 1 <= k <= c:
        raise ValueError(f"k={k} outside [1, C={c}]")
    n = db.shape[0]
    for name, t, dt in (("sq_at_dim", sq_at_dim, torch.float32),
                        ("valid", valid, torch.bool)):
        if t is None:
            continue
        if t.device != db.device or t.dtype != dt or tuple(t.shape) != (n,) \
                or (n > 1 and t.stride(0) != 1):
            raise ValueError(f"{name} must be a contiguous ({n},) {dt} tensor "
                             f"on {db.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def gather_rescore_topk(
    q: Tensor, db: Tensor, cand: Tensor, *, dim: int, k: int,
    sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Rescore each query's own candidate rows at ``dim`` dims; keep the best k.

    Args:
      q:         (Q, D) float32 queries.
      db:        (Ncap, D) float32 rows.
      cand:      (Q, C) int32 row ids, -1 = padding.
      dim:       scoring dimensionality.
      k:         candidates kept, 1 <= k <= C.
      sq_at_dim: optional (Ncap,) float32 prefix squared norms at ``dim``
                 (looked up as ``sq_at_dim[cand]``); computed from the
                 gathered rows when None.
      valid:     optional (Ncap,) bool; candidates on False rows score +inf.

    Returns:
      ((Q, k) float32 ascending, (Q, k) int32 row ids ``cand[q, pos]``);
      equal scores keep the lower position in ``cand``, and a slot with no
      finite score is (+inf, -1).
    """
    if q.device.type == "cpu" and db.device.type == "cpu" \
            and cand.device.type == "cpu":
        return gather_rescore_topk_plain(q, db, cand, dim=dim, k=k,
                                         sq_at_dim=sq_at_dim, valid=valid)
    global launches
    _check(q, db, cand, dim, k, sq_at_dim, valid)
    nq, c = cand.shape
    dev = q.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    lib, fn = _kernel()
    vec = (dim % 4 == 0 and q.stride(0) % 4 == 0 and db.stride(0) % 4 == 0
           and q.data_ptr() % 16 == 0 and db.data_ptr() % 16 == 0)
    err = fn(q.data_ptr(), db.data_ptr(), cand.data_ptr(),
             None if sq_at_dim is None else sq_at_dim.data_ptr(),
             None if valid is None else valid.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(),
             nq, db.shape[0], q.stride(0), db.stride(0), c, dim, k, int(vec),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "gather_rescore_topk")
    launches += 1
    return out_s, out_i
