"""EmbeddingBag over stacked per-field tables: wrapper for the CUDA kernel.

Replaces the TPU kernel ``embedding_bag`` of the JAX package
(``src/repro/kernels/embedding_bag.py:79``, body ``_kernel`` ``:36``,
``pallas_call`` ``:108``): gather table rows per bag and reduce them by
``sum`` or ``mean`` in float32, -1 ids being padding.  The JAX package runs
it per (V, D) table; the kernel (``csrc/embedding_bag.cu``) takes every
field of a stacked (F, V, D) table with (B, F, L) ids in one launch and
writes (B, F, D) float32 — what ``models.recsys.embed_fields`` needs.

Two routes (`route`), one launch a call either way: ``vec16``, a
persistent grid walking the output rows in passes of a few fields (so the
rows a batch re-reads stay in L2 while the output goes out in runs), the
ids and each bag's indices staged in shared memory a stage ahead, rows
read as 16-byte words, eight loads in flight a thread (`tile_plan` sizes
it all), for tables whose rows, strides and base are whole 16-byte words
and whose rows are at most 4 KiB; ``scalar``, an element a lane, for the
rest.  The arguments go to the kernel in one packed block (`ARGS`).

Bound on an H100 SXM: bytes (`bound_bytes`: the distinct rows the ids
touch read once, the ids, the float32 output written once).  At the
two-tower item build (4 fields x 1M bags, one 1 KiB row each) 8.2 GB,
2.45 ms at 3.35 TB/s.

On a CPU tensor the wrapper runs the plain version
(`embedding_bag_plain`, ``ref.embedding_bag_ref``); on a CUDA tensor it
launches the kernel or raises.  ``mode='max'`` has no kernel (as in the JAX
package, whose ``embedding_bag_op`` sends it to the reference).

The backward (`embedding_bag_backward`, ``embedding_bag_backward_kernel``
in the same source) has no Pallas counterpart: the JAX package trains
through XLA's gather.  It writes the dense (F, V, D) float32 gradient of
the tables, as ``jax.grad`` of that gather gives it: a warp a bag, float32
atomic adds into the zeroed table.  `EmbeddingBagFn` puts the forward
kernel and this backward behind autograd; ``ops.embedding_bag`` takes it
only when gradients are asked for.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import embedding_bag_ref

Tensor = torch.Tensor

#: Threads a CTA, CTAs an SM (the kernel's launch bounds), and the ids and
#: bags a stage buffer of the ``vec16`` route holds (``csrc/embedding_bag.cu``).
THREADS, CTAS_PER_SM, IDS_CAP, SLOTS_CAP = 256, 4, 2048, 1024
#: Widest row the ``vec16`` route takes, in bytes (a 16-byte word a thread).
MAX_VEC_ROW = 16 * THREADS
#: Bytes the ``vec16`` walk moves for each run of output rows it writes: it
#: takes the fields in passes of as few fields as make a run's rows, with the
#: table rows they read, this long (`tile_plan`).
WRITE_RUN = 2048
ROUTES = ("vec16", "scalar")

#: Calls that launched the kernel on the card, in all and by route.
launches = 0
launches_by_kernel: Dict[str, int] = {r: 0 for r in ROUTES}
#: Backward calls that launched the backward kernel on the card.
bwd_launches = 0

# EmbeddingBagArgs of csrc/embedding_bag.cu: tab, ids, out, stream;
# ld_field, ld_row; n_bags, n_fields, bag_len, vocab, d, mean, bf16, route,
# fields_per_pass, group, bags_per_group, ids_per_step, ids_chunk, ctas
ARGS = struct.Struct("@4Q2q14i")
_local = threading.local()        # a packing buffer for each thread
_fn = None
_bwd = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("embedding_bag")
        size = lib.embedding_bag_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != ARGS.size:
            raise RuntimeError(f"embedding_bag: the library's argument block "
                               f"is {size()} bytes, the wrapper packs "
                               f"{ARGS.size}")
        fn = lib.embedding_bag_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        _fn = (lib, fn)
    return _fn


def pack_args(buf, tab, ids, out, stream, ld_field, ld_row, n_bags, n_fields,
              bag_len, vocab, d, mean, bf16, route, fields_per_pass, group,
              bags_per_group, ids_per_step, ids_chunk, ctas) -> None:
    """Pack one ``EmbeddingBagArgs`` block into ``buf``: the parameters are
    its fields, in the order ``csrc/embedding_bag.cu`` declares them."""
    ARGS.pack_into(buf, 0, tab, ids, out, stream, ld_field, ld_row, n_bags,
                   n_fields, bag_len, vocab, d, mean, bf16, route,
                   fields_per_pass, group, bags_per_group, ids_per_step,
                   ids_chunk, ctas)


def _args_buffer():
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = ctypes.create_string_buffer(ARGS.size)
        _local.addr = ctypes.addressof(buf)
    return buf, _local.addr


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def embedding_bag_plain(tables: Tensor, ids: Tensor, *,
                        mode: str = "sum") -> Tensor:
    """The kernel's function in plain PyTorch (any device; also 'max')."""
    return embedding_bag_ref(tables, ids, mode=mode)


def route(tables: Tensor, ids: Tensor) -> str:
    """The kernel a call takes: ``vec16`` when the rows, both strides and
    the table's base are whole 16-byte words, a row is at most
    `MAX_VEC_ROW` bytes and the row stride under 4 GiB, else ``scalar``.
    ``ids`` does not decide it (its shape is checked by the wrapper)."""
    es = tables.element_size()
    return _route(tables.shape[-1] * es, tables.data_ptr(),
                  tables.stride(0) * es, tables.stride(-2) * es)


def _route(row: int, ptr: int, ld_field: int, ld_row: int) -> str:
    """`route` from the row's bytes, the base address and the strides in
    bytes."""
    aligned = (row % 16 == 0 and 0 < row <= MAX_VEC_ROW and ptr % 16 == 0
               and ld_field % 16 == 0 and ld_row % 16 == 0
               and ld_row < 2 ** 32)
    return "vec16" if aligned else "scalar"


def bag_steps(bag_len: int):
    """(bags a thread group serves together U, ids a bag loaded a step K) of
    the ``vec16`` route: U x K row loads before the first add (eight for
    one-id bags and bags of five or more, fewer between), at most two bags'
    sums in registers once a bag holds more than one id (more spill)."""
    if bag_len == 1:
        return 8, 1
    if bag_len == 2:
        return 2, 2
    if bag_len in (3, 4):
        return 1, 4
    return 1, 8


def tile_plan(kind: str, d: int, elem_size: int, bag_len: int, n_bags: int,
              n_fields: int, sm_count: int) -> Dict[str, int]:
    """The launch of a call of route ``kind`` over ``n_bags`` (bag, field)
    rows (``n_fields`` fields) of ``bag_len`` ids, D ``d`` of
    ``elem_size``-byte elements, on a card of ``sm_count`` SMs.

    ``vec16``: ``group`` threads a bag (the row's 16-byte words rounded up
    to a power of two), ``bags_per_group`` x ``ids_per_step`` loads a step,
    ``bags_per_tile`` = THREADS / group x bags_per_group, ``ids_chunk`` ids
    of a bag staged at once (a tile's ids fit IDS_CAP), ``ctas`` = the
    tiles or CTAS_PER_SM an SM, whichever is fewer (a persistent grid);
    ``fields_per_pass``, the fewest fields whose output rows, with the
    ``bag_len`` table rows each reads, make WRITE_RUN bytes: the grid walks
    every batch row's bags of those fields before the next fields', so the
    rows it re-reads are those fields' (they stay in L2) while the output
    still goes out in runs (one field a pass once a bag reads more than the
    run).
    ``scalar``: ``group`` lanes a bag (D rounded up to a power of two, at
    most 32), one thread a lane, bags in memory order."""
    if kind == "vec16":
        words = d * elem_size // 16
        group = 1 << max(words - 1, 0).bit_length()
        u, k = bag_steps(bag_len)
        u = min(u, SLOTS_CAP * group // THREADS)
        per_tile = THREADS // group * u
        n_tiles = -(-n_bags // per_tile)
        run = 4 * d + d * elem_size * bag_len
        return {"route": 0, "fields_per_pass": min(
                    n_fields, -(-WRITE_RUN // run)),
                "group": group, "bags_per_group": u,
                "ids_per_step": k, "bags_per_tile": per_tile,
                "ids_chunk": max(1, min(bag_len, IDS_CAP // per_tile)),
                "tiles": n_tiles,
                "ctas": min(n_tiles, sm_count * CTAS_PER_SM)}
    if kind != "scalar":
        raise ValueError(f"unknown route {kind!r}")
    group = min(1 << max(d - 1, 0).bit_length(), 32)
    return {"route": 1, "fields_per_pass": n_fields, "group": group,
            "bags_per_group": 1,
            "ids_per_step": 1, "bags_per_tile": THREADS // group,
            "ids_chunk": bag_len, "tiles": -(-n_bags * group // THREADS),
            "ctas": -(-n_bags * group // THREADS)}


_plan = functools.lru_cache(maxsize=256)(tile_plan)


def bound_bytes(tables: Tensor, ids: Tensor) -> int:
    """Bytes the function must move: every distinct (field, row) the valid
    ids touch read once, the ids read once, the float32 output written
    once."""
    stacked = tables.dim() == 3
    v = tables.shape[-2]
    safe = ids.clamp(0, v - 1).long()
    if stacked:
        safe = safe + v * torch.arange(tables.shape[0],
                                       device=ids.device)[None, :, None]
    n_rows = int(torch.unique(safe[ids >= 0]).numel())
    n_bags = ids.numel() // max(ids.shape[-1], 1)
    d = tables.shape[-1]
    return n_rows * d * tables.element_size() + ids.numel() * 4 + n_bags * d * 4


def _check(tables: Tensor, ids: Tensor, mode: str) -> None:
    if tables.device.type != "cuda" or ids.device != tables.device:
        raise ValueError(f"tables and ids must share one CUDA device, got "
                         f"{tables.device}, {ids.device}")
    if mode not in ("sum", "mean"):
        raise ValueError(f"the kernel reduces 'sum' or 'mean', got {mode!r}")
    if tables.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tables must be float32 or bfloat16, got "
                         f"{tables.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if tables.dim() != 3 or ids.dim() != 3 or ids.shape[1] != tables.shape[0]:
        raise ValueError(f"need tables (F, V, D) and ids (B, F, L); got "
                         f"{tuple(tables.shape)}, {tuple(ids.shape)}")
    if tables.shape[1] == 0:
        raise ValueError("tables have no rows")
    if tables.stride(2) != 1 and tables.shape[2] > 1:
        raise ValueError("tables need a unit stride on the embedding dim")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if ids.shape[0] * ids.shape[1] > 2 ** 31 - IDS_CAP \
            or tables.shape[1] >= 2 ** 31:
        raise ValueError(f"{ids.shape[0] * ids.shape[1]} bags or "
                         f"{tables.shape[1]} rows exceed the kernel's 32-bit "
                         f"indices")


def embedding_bag(tables: Tensor, ids: Tensor, *, mode: str = "sum") -> Tensor:
    """Gather + per-bag reduce over stacked per-field tables.

    Args:
      tables: (F, V, D) float32 or bfloat16 per-field tables — or one (V, D)
              table with (B, L) ids.
      ids:    (B, F, L) int32 ids per bag, field f's bags reading table f;
              negative = padding; an id >= V reads row V - 1 (the JAX
              package's clamped gather).
      mode:   'sum' | 'mean' (the count of valid ids, at least 1).

    Returns:
      (B, F, D) float32 contiguous ((B, D) for a (V, D) table); a bag with
      no valid id gives 0.  Sums start at +0.0 and take the rows in id
      order, as the plain version does: the two agree bit for bit.
    """
    if _build.off_card(tables, ids):
        return embedding_bag_plain(tables, ids, mode=mode)
    if tables.dim() == 2 and ids.dim() == 2:
        return embedding_bag(tables[None], ids[:, None], mode=mode)[:, 0]
    global launches
    _check(tables, ids, mode)
    b, f, bag_len = ids.shape
    _, v, d = tables.shape
    out = torch.empty((b, f, d), dtype=torch.float32, device=tables.device)
    if b * f * d == 0:
        return out
    lib, fn = _kernel()
    dev = tables.device.index
    es = tables.element_size()
    ptr, ld_field, ld_row = tables.data_ptr(), tables.stride(0), tables.stride(1)
    kind = _route(d * es, ptr, ld_field * es, ld_row * es)
    p = _plan(kind, d, es, bag_len, b * f, f, _sm_count(dev))
    buf, addr = _args_buffer()
    pack_args(
        buf, ptr, ids.data_ptr(), out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev), ld_field, ld_row, b * f, f,
        bag_len, v, d, int(mode == "mean"), int(es == 2), p["route"],
        p["fields_per_pass"], p["group"], p["bags_per_group"],
        p["ids_per_step"], p["ids_chunk"], p["ctas"])
    _build.check(lib, fn(addr), "embedding_bag")
    launches += 1
    launches_by_kernel[kind] += 1
    return out


# ---------------------------------------------------------------- backward --

def _bwd_kernel():
    global _bwd
    if _bwd is None:
        lib = _build.library("embedding_bag")
        fn = lib.embedding_bag_backward_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd = (lib, fn)
    return _bwd


def embedding_bag_backward_plain(d_out: Tensor, ids: Tensor, n_rows: int,
                                 mode: str = "sum") -> Tensor:
    """The backward kernel's function in plain PyTorch (any device): each
    id in [0, n_rows) adds its bag's ``d_out`` row (divided by the bag's
    count of ids >= 0 under ``mean``) to its row of the (F, n_rows, D)
    float32 result; negative ids and ids >= n_rows add nothing."""
    b, f, bag_len = ids.shape
    d = d_out.shape[-1]
    g = d_out.to(torch.float32).reshape(b, f, d)
    if mode == "mean":
        cnt = (ids >= 0).sum(dim=-1, keepdim=True).clamp(min=1)
        g = g / cnt.to(torch.float32)
    elif mode != "sum":
        raise ValueError(f"the backward covers 'sum' and 'mean', got {mode!r}")
    out = torch.zeros((f * n_rows + 1, d), dtype=torch.float32,
                      device=d_out.device)
    idx = ids.long()
    live = (idx >= 0) & (idx < n_rows)
    field = torch.arange(f, device=ids.device)[None, :, None]
    flat = torch.where(live, field * n_rows + idx,
                       torch.full_like(idx, f * n_rows))
    rows = g[:, :, None, :].expand(b, f, bag_len, d)
    out.index_add_(0, flat.reshape(-1), rows.reshape(-1, d))
    return out[:-1].reshape(f, n_rows, d)


def embedding_bag_backward(d_out: Tensor, ids: Tensor, n_rows: int,
                           mode: str = "sum") -> Tensor:
    """Gradient of the (F, n_rows, D) tables of `embedding_bag` given the
    output's gradient ``d_out`` (B, F, D) and the call's (B, F, L) int32
    ids: dense float32.  CPU tensors go to `embedding_bag_backward_plain`;
    on a CUDA tensor the kernel launches or the call raises."""
    if _build.off_card(d_out, ids):
        return embedding_bag_backward_plain(d_out, ids, n_rows, mode)
    global bwd_launches
    if d_out.device.type != "cuda" or ids.device != d_out.device:
        raise ValueError(f"d_out and ids must share one CUDA device, got "
                         f"{d_out.device}, {ids.device}")
    if mode not in ("sum", "mean"):
        raise ValueError(f"the backward covers 'sum' and 'mean', got {mode!r}")
    if ids.dtype != torch.int32 or ids.dim() != 3:
        raise ValueError(f"ids must be (B, F, L) int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    b, f, bag_len = ids.shape
    d = d_out.shape[-1]
    if tuple(d_out.shape) != (b, f, d):
        raise ValueError(f"d_out {tuple(d_out.shape)} does not match ids "
                         f"{tuple(ids.shape)}")
    g = d_out.to(torch.float32).contiguous()
    ids = ids.contiguous()
    out = torch.zeros((f, n_rows, d), dtype=torch.float32,
                      device=d_out.device)
    if b * f * d * bag_len == 0 or n_rows == 0:
        return out
    lib, fn = _bwd_kernel()
    err = fn(g.data_ptr(), ids.data_ptr(), out.data_ptr(), b * f, f, bag_len,
             n_rows, d, int(mode == "mean"),
             torch._C._cuda_getCurrentRawStream(d_out.device.index))
    _build.check(lib, err, "embedding_bag_backward")
    bwd_launches += 1
    return out


class EmbeddingBagFn(torch.autograd.Function):
    """`embedding_bag` over (F, V, D) tables and (B, F, L) int32 ids (the
    forward kernel, unchanged) with `embedding_bag_backward` as the
    tables' gradient, cast to their dtype."""

    @staticmethod
    def forward(ctx, tables, ids, mode):
        out = embedding_bag(tables, ids, mode=mode)
        ctx.save_for_backward(ids)
        ctx.info = (tables.shape[1], mode, tables.dtype)
        return out

    @staticmethod
    def backward(ctx, d_out):
        ids, = ctx.saved_tensors
        n_rows, mode, dtype = ctx.info
        g = embedding_bag_backward(d_out, ids, n_rows, mode)
        return g.to(dtype), None, None
