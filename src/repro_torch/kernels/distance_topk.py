"""Stage-0 fused truncated-L2 scan with top-k: wrapper for the CUDA kernel.

Replaces the TPU kernel ``l2_topk`` of the JAX package
(``src/repro/kernels/distance_topk.py:128``, body ``:84``, ``pallas_call``
``:176``).  The kernel (``csrc/distance_topk.cu``) reads only each row's
``[:dim]`` prefix at the buffer's row stride — never a contiguous copy of
``db[:, :dim]`` — and keeps the per-query top-k in shared memory, so the
(Q, N) score matrix never reaches device memory.

Bound on an H100 SXM at the serving shape (1M rows, dim 128, bucket 32):
one read of N·(4·dim + 5) bytes (542 MB, 0.16 ms at 3.35 TB/s) against
2·Q·N·dim float32 operations (8.6 GFLOP, 0.13 ms at 67 TFLOP/s) — memory-
bound with compute close behind.  The design streams each row once per
query tile, splits the doc axis over enough blocks to fill every SM (a
Hopper grid cannot carry a top-k the way the TPU's sequential grid does)
and merges the per-block lists in a second small kernel.

On a CPU tensor the wrapper runs the plain version (`l2_topk_plain`); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import truncated as T
from repro_torch.kernels import _build

Tensor = torch.Tensor

#: Largest k the kernel keeps per query (its per-query lists live in shared
#: memory); larger k raises ValueError.
MAX_K = 256
_TILE_N = 128            # rows per tile, as in csrc/distance_topk.cu

#: Calls that launched the kernel pair (scan + merge) on the card.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("distance_topk")
        fn = lib.l2_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem = lib.l2_topk_scan_smem
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_size_t
        _fn = (lib, fn, smem)
    return _fn


def l2_topk_plain(
    q: Tensor, db: Tensor, *, dim: int, k: int,
    sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (any device)."""
    return T.truncated_search(q, db, dim=dim, k=k, db_sq_at_dim=sq_at_dim,
                              valid=valid)


def _check(q, db, dim, k, sq_at_dim, valid):
    if q.device.type != "cuda" or db.device != q.device:
        raise ValueError(f"q and db must share one CUDA device, got "
                         f"{q.device} and {db.device}")
    if q.dtype != torch.float32 or db.dtype != torch.float32:
        raise ValueError(f"q and db must be float32, got {q.dtype}, {db.dtype}")
    if q.dim() != 2 or db.dim() != 2:
        raise ValueError(f"q and db must be 2-D, got {tuple(q.shape)}, "
                         f"{tuple(db.shape)}")
    if q.stride(1) != 1 or db.stride(1) != 1:
        raise ValueError("q and db need a contiguous last dimension")
    if not 1 <= dim <= min(q.shape[1], db.shape[1]):
        raise ValueError(f"dim={dim} outside [1, {min(q.shape[1], db.shape[1])}]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]: the stage-0 kernel keeps "
                         f"at most {MAX_K} candidates per query")
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


def l2_topk(
    q: Tensor, db: Tensor, *, dim: int, k: int,
    sq_at_dim: Optional[Tensor] = None, valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Exact top-k rows of ``db`` by truncated L2 for each query row.

    Args:
      q:         (Q, D) float32 queries; only ``[:, :dim]`` is read.
      db:        (Ncap, D) float32 rows; only ``[:, :dim]`` is read.
      dim:       truncation dimensionality.
      k:         neighbours kept, 1 <= k <= MAX_K (k may exceed Ncap).
      sq_at_dim: optional (Ncap,) float32 prefix squared norms at ``dim``;
                 computed from the rows when None.
      valid:     optional (Ncap,) bool; False rows score +inf.

    Returns:
      ((Q, k) float32 ``||x||² − 2 q·x`` ascending, (Q, k) int32 row ids);
      equal scores keep the lower row id, and a slot with no finite score
      is (+inf, -1).
    """
    if q.device.type == "cpu" and db.device.type == "cpu":
        return l2_topk_plain(q, db, dim=dim, k=k, sq_at_dim=sq_at_dim,
                             valid=valid)
    global launches
    _check(q, db, dim, k, sq_at_dim, valid)
    nq, n = q.shape[0], db.shape[0]
    dev = q.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    lib, fn, smem_fn = _kernel()
    props = torch.cuda.get_device_properties(dev)
    # queries per warp: as many as the batch needs and shared memory holds
    # (each query's candidate list lives in the block's shared memory)
    rq = 1 if nq <= 8 else 2 if nq <= 16 else 4
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    while rq > 1 and smem_fn(rq, dim) > limit:
        rq //= 2
    q_tiles = -(-nq // (8 * rq))
    n_tiles = max(-(-n // _TILE_N), 1)
    # one block per SM: split the doc axis so every SM gets one block
    n_split = min(n_tiles, max(1, -(-props.multi_processor_count // q_tiles)))
    tiles_per_split = -(-n_tiles // n_split)
    n_split = -(-n_tiles // tiles_per_split)
    part_s = torch.empty((nq, n_split, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, n_split, k), dtype=torch.int32, device=dev)
    vec = (dim % 4 == 0 and q.stride(0) % 4 == 0 and db.stride(0) % 4 == 0
           and q.data_ptr() % 16 == 0 and db.data_ptr() % 16 == 0)
    err = fn(q.data_ptr(), db.data_ptr(),
             None if sq_at_dim is None else sq_at_dim.data_ptr(),
             None if valid is None else valid.data_ptr(),
             part_s.data_ptr(), part_i.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(),
             nq, n, q.stride(0), db.stride(0), dim, k, rq, int(vec),
             n_split, tiles_per_split,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "l2_topk")
    launches += 1
    return out_s, out_i
