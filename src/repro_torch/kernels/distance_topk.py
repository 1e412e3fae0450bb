"""Stage-0 fused truncated-L2 scan with top-k: wrapper for the CUDA kernel.

Replaces the TPU kernel ``l2_topk`` of the JAX package
(``src/repro/kernels/distance_topk.py:128``, body ``:84``, ``pallas_call``
``:176``).  The kernels (``csrc/distance_topk.cuh``, built as two
libraries — ``distance_topk.cu`` for float32 rows, ``distance_topk_bf16.cu``
for bf16 rows —, and ``csrc/distance_topk_wide.cu`` for float32 rows above
256 dims, all three compiling side by side and sharing the selection and
pass 2 of ``csrc/l2_select.cuh``) read only each row's ``[:dim]`` prefix at
the buffer's row stride — never a contiguous copy of ``db[:, :dim]`` — and
keep the per-query top-k in shared memory, so the (Q, N) score matrix
never reaches device memory.

``q`` and ``db`` are both float32 or both bfloat16 (the JAX kernel takes
either, with a float32 accumulator); scores, prefix norms and the top-k
are float32 in both cases.

Bound on an H100 SXM (the data sheet's 3.35 TB/s, 989 TFLOP/s bf16, 495
TF32) at the serving shape (1M rows, dim 128, bucket 32): one read of
N·(4·dim + 5) bytes (542 MB, 0.16 ms) against 2·Q·N·dim operations —
memory-bound; bf16 rows halve the row bytes (N·(2·dim + 5), 0.08 ms).  At
the two-tower's stage 0 (Q 512, dim 64, 1M rows) the operations lead: 67
GFLOP, 0.41 ms as 3xTF32 (three TF32 products) and 0.068 ms as one bf16
product.  At the paper's truncated baseline (Q 2,470, dim 3,584, 1M rows)
the 3xTF32 operations lead by far: 53 TFLOP, 107 ms.

Three pass-1 kernels, chosen from the shapes, strides and dtype alone
(`route`):

- ``wgmma``: the tensor-core scan up to 256 dims — TMA loads of the rows'
  prefix, query tiles of 8, 16 or 32 kept whole in shared memory, two or
  three consumer warpgroups (`warpgroups`); float32 rows as split TF32
  (3xTF32) products, bf16 rows as one bf16 product a k16 step.  For a row
  buffer that TMA can read (16-byte aligned base; float32: a row stride
  and a dim that are multiples of 4; bf16: a row stride that is a multiple
  of 8 and a dim that is a multiple of 16).
- ``wide``: float32 rows that TMA can read, above 256 dims
  (``csrc/distance_topk_wide.cu``, its own library): the same 3xTF32
  products with the dims as a K loop — the queries split into TF32 hi and
  lo once a call by a pre-pass, their boxes streamed through the ring
  beside the rows' —, query tiles of up to 64 sized by k (`wide_plan`,
  mirroring the source's ``WIDE_PLAN`` table), and a persistent grid
  walking (row range, query tile) items doc-major (`persistent_splits`).
- ``fma``: everything else (rows TMA cannot read, a dim that is not a
  multiple of 4, bf16 rows above 256 dims) — FMA in float32 from shared
  memory, the first kernel of this port; bf16 rows are widened on their
  way in.

``wgmma`` and ``fma`` have a float32 and a bf16 instantiation.  Every route
splits the doc axis over enough blocks to fill every SM (a Hopper grid
cannot carry a top-k the way the TPU's sequential grid does) and merges
the per-block lists in pass 2, over groups of lists first when the batch is
too small to fill the card.  Above k = 256 (up to `MAX_K`, the paper's
k0 sweep) each query's list has `list_slots` (1,024 or 2,048) slots, and
pass 2 folds fewer lists a round.  On ``wgmma`` such a call goes to its
large-k kernel: the lists live in a global scratch (one set a CTA of a
persistent grid walking (row range, query tile) items,
`persistent_splits`), so a tile holds 64 queries at every dim up to 256
(`wgmma_bigk_plan`, mirroring the source's ``WGMMA_BIGK_PLAN``); a list
is tightened by a radix select that reads it once into registers and, at
an item's end, cut to its top k and sorted in shared memory.  ``wide`` and
``fma`` keep such lists in shared memory, 16 queries a block at k <= 512
and 8 above, tightened and sorted there.  `scores_3xtf32` spells
out the tensor-core kernels' float32 arithmetic in plain PyTorch for the
tests; on bf16 rows every product is exact in float32, so both kernels'
scores are the plain version's up to the order of the float32 sums.

On a CPU tensor the wrapper runs the plain version (`l2_topk_plain`); on a
CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import Optional, Tuple

import torch

from repro_torch.core import truncated as T
from repro_torch.kernels import _build

Tensor = torch.Tensor

#: Largest k the kernel keeps per query (its per-query lists live in shared
#: memory); larger k raises ValueError.
MAX_K = 1024
#: Slots of a per-query pass-1 list up to k = 256 (`list_slots` above).
LIST_SLOTS = 512
TILE_ROWS = 128          # rows per pass-1 tile of the FMA kernel
#: Consumer warpgroups of the tensor-core kernel (64 rows of a tile each),
#: by k (`warpgroups`): three hide more of the selection's latency; above
#: k = 128 a 192-row tile leaves a list too little room above k.
WGMMA_WARPGROUPS = (3, 2)
#: Query tiles of the tensor-core kernel; it takes dims up to WGMMA_MAX_DIM
#: (its query hi / lo tiles, 32 x dim floats each, stay in shared memory).
WGMMA_TILES = (8, 16, 32)
WGMMA_MAX_DIM = 256
WGMMA_MAX_STAGES = 8
#: The tensor-core kernel's plan above k = 256 by dim, as ``WGMMA_BIGK_PLAN``
#: in ``csrc/distance_topk.cuh``: (largest dim, queries a tile, ring
#: stages), the first row whose dim covers the call's.  Its tiles are 128
#: rows (two consumer warpgroups), and a warp's sort scratch holds
#: `BIGK_SORT_SLOTS` (score, id) slots; the eight warps' scratch shares one
#: region with the query tiles of an item.
WGMMA_BIGK_PLANS = ((128, 64, 8), (256, 64, 6))
WGMMA_BIGK_ROWS = 128
BIGK_SORT_SLOTS = 1024
#: A batch smaller than two of the plan's tiles makes at least this many
#: query tiles (``kBigkMinQTiles``).
BIGK_MIN_Q_TILES = 2
#: What an item of the large-k kernel costs beyond its rows, in tiles per
#: unit of k: its lists refill from empty (every row of its first tiles
#: enters them, then about seven tightens), so few long row ranges beat
#: many short ones (the ``item_tiles`` of `persistent_splits`).
BIGK_ITEM_TILES_PER_K = 0.7
#: The wide-dim tensor-core kernel's plan by k, as ``WIDE_PLAN`` in
#: ``csrc/distance_topk_wide.cu``: (largest k, queries a tile, slots a
#: list, ring stages), the first row whose k covers the call's.
WIDE_PLANS = ((64, 64, 256, 3), (256, 32, 512, 4), (512, 16, 1024, 4),
              (1024, 8, 2048, 5))
#: Rows of a wide-kernel tile (two consumer warpgroups of 64).
WIDE_ROWS = 128
#: The bytes the pass-1 lists (Q, n_split, k) of a persistent kernel
#: (``wide``, and ``wgmma`` above k = 256) may take, which caps its splits.
PART_BYTES = 256 << 20
#: Lists a pass-2 block folds (one round of its 32 warps).
MERGE_GROUP = 32
#: Shared memory a block may use on the H100 (227 KB).
SMEM_LIMIT = 232448

#: Calls that launched a pass-1 kernel and its merge on the card, in all and
#: by pass-1 kernel and input type (`counter_key`).
launches = 0
launches_by_kernel = {"wgmma": 0, "fma": 0, "wide": 0, "wgmma_bf16": 0,
                      "fma_bf16": 0}

# L2Args of csrc/distance_topk.cuh: q, db, sq, valid, part_s, part_i, mid_s,
# mid_i, out_s, out_i, lists, stream; ld_q, ld_db; nq, n, dim, k, kind,
# tile_q, vec, n_split, tiles_per_split, n_groups, stages, wgs, bf16, grid
_ARGS = struct.Struct("@12Q2q14i")
_KIND = {"fma": 0, "wgmma": 1}
# WideArgs of csrc/distance_topk_wide.cu: q, db, sq, valid, qsplit, part_s,
# part_i, mid_s, mid_i, out_s, out_i, stream; ld_q, ld_db; nq, n, dim, k,
# tile_q, slots, stages, n_split, grid, n_groups
_WIDE_ARGS = struct.Struct("@12Q2q10i")
_local = threading.local()
_fns = {}


def _kernel(bf16: bool = False):
    """(library, its launcher, its FMA shared-memory function) of the
    float32 or the bf16 build."""
    if bf16 not in _fns:
        lib = _build.library("distance_topk_bf16" if bf16 else
                             "distance_topk")
        size = lib.l2_topk_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != _ARGS.size:
            raise RuntimeError(f"l2_topk: the library's argument block is "
                               f"{size()} bytes, the wrapper packs "
                               f"{_ARGS.size}")
        fn = lib.l2_topk_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        smem = lib.l2_topk_scan_smem
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_size_t
        wg_smem = lib.l2_topk_wgmma_smem
        wg_smem.argtypes = [ctypes.c_int] * 5
        wg_smem.restype = ctypes.c_size_t
        slots = lib.l2_topk_list_slots
        slots.argtypes, slots.restype = [ctypes.c_int], ctypes.c_int
        for k in (1, 256, 257, 512, 513, MAX_K):
            for b16 in (0, 1):
                if slots(k) != list_slots(k) or wg_smem(
                        32, 100, 3, 3, b16) != wgmma_smem_bytes(
                        32, 100, 3, 3, bool(b16)):
                    raise RuntimeError(
                        "l2_topk: the library's list slots or shared-memory "
                        "layout differ from list_slots / wgmma_smem_bytes")
        _fns[bf16] = (lib, fn, smem)
        for nq in (1, 9, 33, 2470):
            for dim in (4, 64, 128, 132, 256):
                if built_bigk_plan(nq, dim, bf16) != wgmma_bigk_plan(nq, dim):
                    del _fns[bf16]
                    raise RuntimeError(
                        f"l2_topk: the library's large-k plan at nq={nq}, "
                        f"dim={dim} is {built_bigk_plan(nq, dim, bf16)}, the "
                        f"wrapper's {wgmma_bigk_plan(nq, dim)}")
    return _fns[bf16]


def wgmma_bigk_plan(nq: int, dim: int) -> Tuple[int, int, int]:
    """(queries a tile, ring stages, dynamic shared memory) of the
    tensor-core kernel above k = 256 for nq queries at ``dim``, as
    ``bigk_plan`` and ``bigk_smem_bytes`` in ``csrc/distance_topk.cuh``
    reckon them: the first `WGMMA_BIGK_PLANS` row whose dim covers
    ``dim``, its tile cut to the smallest of 8, 16, 32, 64 that makes at
    least `BIGK_MIN_Q_TILES` query tiles of the batch; the shared memory is
    1,024 bytes of alignment, the ring (a 128-row box of 128 bytes a
    stage), the region of the query tiles (float32 hi and lo tiles at the
    row's largest dim) and the warps' sort scratch (8 x `BIGK_SORT_SLOTS`
    x 8 bytes), whichever is larger, the counts and thresholds, the
    barriers."""
    for max_dim, tile, stages in WGMMA_BIGK_PLANS:
        if dim <= max_dim:
            t = 8
            while t * BIGK_MIN_Q_TILES < nq and t < tile:
                t *= 2
            region = max(2 * -(-max_dim // 32) * t * 128,
                         8 * BIGK_SORT_SLOTS * 8)
            smem = (1024 + stages * WGMMA_BIGK_ROWS * 128 + region
                    + t * 12 + 8 + stages * 16)
            return t, stages, smem
    raise ValueError(f"dim={dim} above the large-k plan's "
                     f"{WGMMA_BIGK_PLANS[-1][0]}")


def built_bigk_plan(nq: int, dim: int, bf16: bool = False
                    ) -> Tuple[int, int, int]:
    """`wgmma_bigk_plan` as the built float32 or bf16 library reports it
    (``l2_topk_bigk_plan``); builds the library, so it needs the CUDA
    toolchain."""
    lib = _fns[bf16][0] if bf16 in _fns else _kernel(bf16)[0]
    fn = lib.l2_topk_bigk_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    _build.check(lib, fn(nq, dim, out), f"l2_topk_bigk_plan({nq}, {dim})")
    return tuple(out)


def bigk_lists_bytes(grid: int, tile: int, k: int) -> int:
    """Bytes of the large-k kernel's global lists: ``tile`` lists of
    `list_slots` (score, id) slots for each of the ``grid`` CTAs."""
    return grid * tile * list_slots(k) * 8


def _kernel_wide():
    """(library, its launcher) of the wide-dim build, its argument block
    and plan checked against the wrapper's."""
    if "wide" not in _fns:
        lib = _build.library("distance_topk_wide")
        size = lib.l2_topk_wide_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != _WIDE_ARGS.size:
            raise RuntimeError(f"l2_topk: the wide library's argument block "
                               f"is {size()} bytes, the wrapper packs "
                               f"{_WIDE_ARGS.size}")
        fn = lib.l2_topk_wide_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        _fns["wide"] = (lib, fn)
        for nq in (1, 9, 33, 2470):
            for k in (1, 64, 65, 256, 257, 512, 513, MAX_K):
                if built_wide_plan(nq, k) != wide_plan(nq, k):
                    del _fns["wide"]
                    raise RuntimeError(
                        f"l2_topk: the wide library's plan at nq={nq}, "
                        f"k={k} is {built_wide_plan(nq, k)}, the wrapper's "
                        f"{wide_plan(nq, k)}")
    return _fns["wide"]


def wide_plan(nq: int, k: int) -> Tuple[int, int, int, int]:
    """(queries a tile, slots a list, ring stages, dynamic shared memory)
    of the wide-dim kernel for nq queries at ``k``, as ``wide_plan`` and
    ``wide_smem_bytes`` in ``csrc/distance_topk_wide.cu`` reckon them: the
    first `WIDE_PLANS` row whose k covers ``k``, its tile cut to the
    smallest of 8, 16, 32, 64 that holds the batch; the shared memory is
    1,024 bytes of alignment, the ring (a 128-row box of rows and the
    tile's hi and lo query boxes, 128 bytes a row each, a stage), the
    lists of (score, id) slots, their counts and thresholds, the
    barriers."""
    for max_k, tile, slots, stages in WIDE_PLANS:
        if k <= max_k:
            t = 8
            while t < nq and t < tile:
                t *= 2
            smem = (1024 + stages * (WIDE_ROWS * 128 + 2 * t * 128)
                    + t * slots * 8 + t * 12 + 8 + stages * 16)
            return t, slots, stages, smem
    raise ValueError(f"k={k} above the wide plan's {WIDE_PLANS[-1][0]}")


def built_wide_plan(nq: int, k: int) -> Tuple[int, int, int, int]:
    """`wide_plan` as the built library reports it (``l2_topk_wide_plan``);
    builds the library, so it needs the CUDA toolchain."""
    lib = _kernel_wide()[0]
    fn = lib.l2_topk_wide_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _build.check(lib, fn(nq, k, out), f"l2_topk_wide_plan({nq}, {k})")
    return tuple(out)


@functools.lru_cache(maxsize=256)
def persistent_splits(n_tiles: int, q_tiles: int, n_sm: int,
                      max_split: int,
                      item_tiles: int = 0) -> Tuple[int, int, int]:
    """(n_split, most tiles a split, grid) of a persistent kernel
    (``wide``, and ``wgmma`` above k = 256): the doc axis cut into n_split
    ranges that differ by at most one tile, so that the q_tiles x n_split
    (row range, query tile) items, walked by a persistent grid of at most
    n_sm blocks, finish in the fewest rounds of tiles (items a block x
    (tiles an item + ``item_tiles``, what an item costs beyond its rows));
    of the cuts within 2% of that, at most ``max_split``, the fewest splits
    that still give every SM an item where the cuts can."""
    top = max(1, min(n_tiles, max_split, 4 * n_sm))
    cost = {ns: -(-(ns * q_tiles) // n_sm) * (-(-n_tiles // ns) + item_tiles)
            for ns in range(1, top + 1)}
    near = [ns for ns in cost if cost[ns] <= 1.02 * min(cost.values())]
    full = [ns for ns in near if ns * q_tiles >= n_sm]
    ns = min(full or near)
    return ns, -(-n_tiles // ns), min(n_sm, ns * q_tiles)


def warpgroups(k: int) -> int:
    """Consumer warpgroups of the tensor-core kernel at ``k``."""
    return WGMMA_WARPGROUPS[0] if k <= 128 else WGMMA_WARPGROUPS[1]


def list_slots(k: int) -> int:
    """Slots of a per-query pass-1 list at ``k``, as ``list_slots`` in the
    source: `LIST_SLOTS` up to k = 256, else twice the next power of two
    above k (room for many tiles of candidates above a tightened list)."""
    return LIST_SLOTS if k <= 256 else 2 * (1 << (k - 1).bit_length())


def wgmma_smem_bytes(nt: int, dim: int, stages: int, wgs: int,
                     bf16: bool = False) -> int:
    """Shared memory of a tensor-core block up to k = 256, as
    ``wgmma_smem_bytes`` in the source: the row ring (a stage is 64 * wgs
    rows of 128 bytes: 32 float32 or 64 bf16 dims), the query tiles (hi and
    lo for float32, one for bf16), nt lists of `LIST_SLOTS` (score, id)
    slots, their counts and thresholds, the barriers."""
    nbox = -(-dim // (64 if bf16 else 32))
    return (1024 + stages * 64 * wgs * 128 + (1 if bf16 else 2) * nbox * nt
            * 128 + nt * LIST_SLOTS * 8 + nt * 12 + 8 + stages * 16)


def wgmma_tile(nq: int, dim: int, wgs: int,
               bf16: bool = False) -> Tuple[int, int]:
    """(queries a tile, ring stages) of the tensor-core kernel up to k =
    256 for a batch of nq at ``dim``: the smallest tile that holds the
    batch (at most 32), halved until at least two stages fit, then as many
    stages as shared memory holds (at most 8); (0, 0) when not even two
    stages fit at 8 queries."""
    for nt in WGMMA_TILES:
        if nt >= nq or nt == WGMMA_TILES[-1]:
            break
    while True:
        stages = WGMMA_MAX_STAGES
        while stages >= 2 and wgmma_smem_bytes(nt, dim, stages, wgs,
                                               bf16) > SMEM_LIMIT:
            stages -= 1
        if stages >= 2:
            return nt, stages
        if nt == WGMMA_TILES[0]:
            return 0, 0
        nt //= 2


def route(q: Tensor, db: Tensor, dim: int, k: int = MAX_K) -> str:
    """The pass-1 kernel a call goes to, from its shapes, strides and dtype
    alone (``k`` does not change it): TMA reads 16-byte aligned rows at a
    stride of a multiple of 16 bytes, and a bf16 product takes 16 dims a
    step; float32 rows above `WGMMA_MAX_DIM` go to ``wide``, bf16 ones to
    ``fma``."""
    bf16 = db.dtype == torch.bfloat16
    aligned = (db.data_ptr() % 16 == 0
               and db.stride(0) % (8 if bf16 else 4) == 0
               and dim % (16 if bf16 else 4) == 0)
    if aligned and db.shape[0] > 0:
        # both of its kernels' plans fit every dim up to 256
        if dim <= WGMMA_MAX_DIM:
            return "wgmma"
        if not bf16:
            return "wide"
    return "fma"


def counter_key(kind: str, dtype: torch.dtype) -> str:
    """The `launches_by_kernel` entry of a call on pass-1 kernel ``kind``
    with rows of ``dtype``: bf16 calls are counted apart."""
    return kind + "_bf16" if dtype == torch.bfloat16 else kind


def splits(n_tiles: int, q_tiles: int, n_sm: int) -> Tuple[int, int]:
    """(n_split, tiles a split): the doc axis cut so that the q_tiles x
    n_split blocks make about one wave on n_sm SMs."""
    n_split = min(n_tiles, max(1, n_sm // q_tiles))
    per = -(-n_tiles // n_split)
    return -(-n_tiles // per), per


def merge_groups(nq: int, n_split: int, n_sm: int) -> int:
    """Pass-2 groups per query: lists folded in groups of `MERGE_GROUP`
    first when one block per query would leave SMs idle."""
    if nq >= 2 * n_sm or n_split <= MERGE_GROUP:
        return 1
    return -(-n_split // MERGE_GROUP)


def tf32_round(x: Tensor) -> Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero): ``cvt.rna.tf32.f32``, a bit mask on the float32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def scores_3xtf32(q: Tensor, db: Tensor, dim: int,
                  sq_at_dim: Optional[Tensor] = None) -> Tensor:
    """(Q, N) scores ``||x||² − 2 q·x`` as the tensor-core kernel forms
    them: each value split into hi = tf32(v) and lo = tf32(v − hi), the dot
    product hi·hi + hi·lo + lo·hi (exact products, float32 sums here; the
    kernel sums in its own order)."""
    qf = q[:, :dim].float()
    xf = db[:, :dim].float()
    qh, xh = tf32_round(qf), tf32_round(xf)
    ql, xl = tf32_round(qf - qh), tf32_round(xf - xh)
    dot = (qh.double() @ xh.double().T + qh.double() @ xl.double().T
           + ql.double() @ xh.double().T).float()
    sq = (xf * xf).sum(1) if sq_at_dim is None else sq_at_dim.float()
    return sq[None, :] - 2.0 * dot


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
    if q.dtype != db.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q and db must be both float32 or both bfloat16, "
                         f"got {q.dtype}, {db.dtype}")
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
      q:         (Q, D) queries, float32 or bfloat16 (the dtype of ``db``);
                 only ``[:, :dim]`` is read.
      db:        (Ncap, D) rows, float32 or bfloat16; only ``[:, :dim]`` is
                 read, at the buffer's row stride.  bf16 products are exact
                 in float32 and every sum is float32.
      dim:       truncation dimensionality.
      k:         neighbours kept, 1 <= k <= MAX_K (k may exceed Ncap).
      sq_at_dim: optional (Ncap,) float32 prefix squared norms at ``dim``
                 (of the rows as stored); computed from the rows when None.
      valid:     optional (Ncap,) bool; False rows score +inf.

    Returns:
      ((Q, k) float32 ``||x||² − 2 q·x`` ascending, (Q, k) int32 row ids);
      equal scores keep the lower row id, and a slot with no finite score
      is (+inf, -1).
    """
    if _build.off_card(q, db):
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
    bf16 = db.dtype == torch.bfloat16
    kind, tile_q, stages, wgs, n_split, per, n_groups = plan(q, db, dim, k)
    if kind == "wide":
        return _launch_wide(q, db, dim, k, sq_at_dim, valid, out_s, out_i,
                            tile_q, stages, n_split, n_groups)
    lib, fn, _ = _kernel(bf16)
    grid, lists = 0, None
    if kind == "wgmma" and k > 256:
        # the large-k kernel's persistent grid and its lists
        grid = min(_sm_count(dev), n_split * -(-nq // tile_q))
        lists = torch.empty(bigk_lists_bytes(grid, tile_q, k) // 4,
                            dtype=torch.float32, device=dev)
    vec = 0
    if kind == "fma":
        # 16-byte loads: 4 float32 or 8 bf16 dims
        w = 8 if bf16 else 4
        vec = int(dim % w == 0 and q.stride(0) % w == 0
                  and db.stride(0) % w == 0 and q.data_ptr() % 16 == 0
                  and db.data_ptr() % 16 == 0)
    part_s = torch.empty((nq, n_split, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, n_split, k), dtype=torch.int32, device=dev)
    mid_s = mid_i = None
    if n_groups > 1:
        mid_s = torch.empty((nq, n_groups, k), dtype=torch.float32, device=dev)
        mid_i = torch.empty((nq, n_groups, k), dtype=torch.int32, device=dev)
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = ctypes.create_string_buffer(_ARGS.size)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _ARGS.pack_into(buf, 0, q.data_ptr(), db.data_ptr(), ptr(sq_at_dim),
                    ptr(valid), part_s.data_ptr(), part_i.data_ptr(),
                    ptr(mid_s), ptr(mid_i), out_s.data_ptr(), out_i.data_ptr(),
                    ptr(lists), torch.cuda.current_stream(dev).cuda_stream,
                    q.stride(0), db.stride(0), nq, n, dim, k, _KIND[kind],
                    tile_q, vec, n_split, per, n_groups, stages, wgs,
                    int(bf16), grid)
    key = counter_key(kind, db.dtype)
    _build.check(lib, fn(ctypes.addressof(buf)), f"l2_topk ({key})")
    launches += 1
    launches_by_kernel[key] += 1
    return out_s, out_i


def pack_wide_args(buf, *, q, db, sq, valid, qsplit, part_s, part_i, mid_s,
                   mid_i, out_s, out_i, stream, ld_q, ld_db, nq, n, dim, k,
                   tile_q, slots, stages, n_split, grid, n_groups) -> None:
    """Packs the fields of ``WideArgs`` (``csrc/distance_topk_wide.cu``),
    named and ordered as there (pointers as ints, 0 for null), into
    ``buf``."""
    _WIDE_ARGS.pack_into(buf, 0, q, db, sq, valid, qsplit, part_s, part_i,
                         mid_s, mid_i, out_s, out_i, stream, ld_q, ld_db, nq,
                         n, dim, k, tile_q, slots, stages, n_split, grid,
                         n_groups)


def _launch_wide(q, db, dim, k, sq_at_dim, valid, out_s, out_i, tile_q,
                 stages, n_split, n_groups):
    """The wide-dim kernel's call: the query pre-pass's scratch and the
    pass-1 lists allocated here, one packed argument block, one C call."""
    global launches
    lib, fn = _kernel_wide()
    nq, dev = q.shape[0], q.device
    slots = wide_plan(nq, k)[1]
    q_tiles = -(-nq // tile_q)
    qsplit = torch.empty(q_tiles * -(-dim // 32) * 2 * tile_q * 32,
                         dtype=torch.float32, device=dev)
    part_s = torch.empty((nq, n_split, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, n_split, k), dtype=torch.int32, device=dev)
    mid_s = mid_i = None
    if n_groups > 1:
        mid_s = torch.empty((nq, n_groups, k), dtype=torch.float32, device=dev)
        mid_i = torch.empty((nq, n_groups, k), dtype=torch.int32, device=dev)
    buf = getattr(_local, "wide_buf", None)
    if buf is None:
        buf = _local.wide_buf = ctypes.create_string_buffer(_WIDE_ARGS.size)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    pack_wide_args(
        buf, q=q.data_ptr(), db=db.data_ptr(), sq=ptr(sq_at_dim),
        valid=ptr(valid), qsplit=qsplit.data_ptr(), part_s=part_s.data_ptr(),
        part_i=part_i.data_ptr(), mid_s=ptr(mid_s), mid_i=ptr(mid_i),
        out_s=out_s.data_ptr(), out_i=out_i.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream, ld_q=q.stride(0),
        ld_db=db.stride(0), nq=nq, n=db.shape[0], dim=dim, k=k,
        tile_q=tile_q, slots=slots, stages=stages, n_split=n_split,
        grid=min(_sm_count(dev), n_split * q_tiles), n_groups=n_groups)
    _build.check(lib, fn(ctypes.addressof(buf)), "l2_topk (wide)")
    launches += 1
    launches_by_kernel["wide"] += 1
    return out_s, out_i


def plan(q: Tensor, db: Tensor, dim: int, k: int
         ) -> Tuple[str, int, int, int, int, int, int]:
    """How a call on the card runs: (pass-1 kernel, its query tile — queries
    a warp for ``fma`` —, ring stages, warpgroups, n_split, tiles a split,
    pass-2 groups); pass 2 launches once, or twice with groups.  A
    ``wide`` call's grid, and a ``wgmma`` call's above k = 256, is
    min(SMs, n_split x query tiles)."""
    nq, n = q.shape[0], db.shape[0]
    kind = route(q, db, dim, k)
    stages = 0
    wgs = warpgroups(k)
    slots = list_slots(k)
    if kind == "wide" or (kind == "wgmma" and k > 256):
        n_sm = _sm_count(q.device)
        cap = max(1, PART_BYTES // (nq * k * 8))
        if kind == "wide":
            tile_q, _, stages, _ = wide_plan(nq, k)
            n_split, per, _ = persistent_splits(
                max(-(-n // WIDE_ROWS), 1), -(-nq // tile_q), n_sm, cap)
        else:
            tile_q, stages, _ = wgmma_bigk_plan(nq, dim)
            n_split, per, _ = persistent_splits(
                max(-(-n // WGMMA_BIGK_ROWS), 1), -(-nq // tile_q), n_sm,
                cap, round(BIGK_ITEM_TILES_PER_K * k))
        return kind, tile_q, stages, 2, n_split, per, \
            merge_groups(nq, n_split, n_sm)
    if kind == "wgmma":
        tile_q, stages = wgmma_tile(nq, dim, wgs, db.dtype == torch.bfloat16)
        q_tiles = -(-nq // tile_q)
        n_tiles = max(-(-n // (64 * wgs)), 1)
    else:
        # queries per warp: as many as the batch needs and shared memory
        # holds (each query's candidate list lives in the block's shared
        # memory)
        smem_fn = _kernel(db.dtype == torch.bfloat16)[2]
        tile_q = 1 if nq <= 8 else 2 if nq <= 16 else 4
        while tile_q > 1 and smem_fn(tile_q, dim, slots) > SMEM_LIMIT:
            tile_q //= 2
        q_tiles = -(-nq // (8 * tile_q))
        n_tiles = max(-(-n // TILE_ROWS), 1)
    n_sm = _sm_count(q.device)
    n_split, per = splits(n_tiles, q_tiles, n_sm)
    return kind, tile_q, stages, wgs, n_split, per, \
        merge_groups(nq, n_split, n_sm)


_n_sm = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]
