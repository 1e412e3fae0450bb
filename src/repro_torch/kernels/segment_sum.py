"""Segment sum over receiver-sorted rows: wrapper for the CUDA kernel.

Replaces the TPU kernel ``sorted_segment_sum`` of the JAX package
(``src/repro/kernels/segment_sum.py:100``, body ``_kernel`` ``:39``,
``pallas_call`` ``:126``) and its sort + CSR wrapper ``ops.segment_sum_op``
(``src/repro/kernels/ops.py:75``): the scatter of GNN message passing.
The kernel (``csrc/segment_sum.cu``) splits the merged list of segment
ends and rows into equal tasks of `ITEMS` entries, one warp each (the
merge-path partition), writes each segment that lies inside a task and
leaves the parts of a segment cut by task edges unrounded, which a fix-up
launch adds in task order and rounds once: no atomics, so the result is
deterministic.  Rows of at most
`NARROW_MAX_D` columns go to a kernel with lanes across the rows
(``narrow``), wider rows to one with lanes across the columns (``wide``);
`route` names the one a call takes.  `merge_path_plain` spells out the
partition and the carry / fix-up merge in plain PyTorch for the tests.

Two entries:

  sorted_segment_sum(data, seg_ids, indptr, num_segments=)  — rows already
      sorted by segment, with the CSR pointer (the EGNN path sorts its
      edges once per forward, `sort_by_segment`);
  segment_sum(data, seg_ids, num_segments=)  — unsorted rows, negative ids
      (and ids >= num_segments) dropped: sorts, builds the pointer and calls
      the kernel, for parity with the JAX package's ``segment_sum_op``.

Bound on an H100 SXM: bytes (`bound_bytes`: the rows read once, indptr,
the float32 output written once).  EGNN's message sum on ogbn-products
(61.9M x 64 float32 onto 2.45M nodes) is 16.4 GB, 4.9 ms at 3.35 TB/s.

On a CPU tensor each entry runs its plain version (``index_add_``, as
``ref.segment_sum_ref``, accumulated in float64); on a CUDA tensor it
launches the kernel or raises.
The plain version of the sorted entry reads ``seg_ids`` and never
``indptr``, so it checks the pointer the kernel trusts.

The backward of the sorted entry (`sorted_segment_sum_backward`,
``segment_sum_backward_kernel`` in the same source) has no Pallas
counterpart: the JAX package trains through ``jax.ops.segment_sum``.  Each
live row gets its segment's ``d_out`` row, found from ``indptr`` (a warp a
task of 32 rows, 16-byte words; see the source).  `SortedSegmentSumFn`
puts the forward kernel and this backward behind autograd;
``ops.sorted_segment_sum`` takes it only when gradients are asked for.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: Entries (segment ends plus rows) of the merged list per warp task, by
#: kernel: a wide task reads up to 512 rows of D floats, a narrow one
#: 1,024 rows of at most 4.
ITEMS = {"wide": 512, "narrow": 1024}
#: Entries per task where the rows are fewer than the segments: such a task
#: is mostly zero stores of empty segments, so it is kept short to spread
#: them over more warps.
SPARSE_ITEMS = 64
#: Widest rows of the narrow kernel (lanes across the rows).
NARROW_MAX_D = 4

#: Calls that launched the kernels on the card (both entries), in all and
#: by main kernel.
launches = 0
launches_by_kernel = {"wide": 0, "narrow": 0}
#: Backward calls that launched the backward kernel on the card.
bwd_launches = 0

_fn = None
_bwd = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("segment_sum")
        fn = lib.segment_sum_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def route(d: int) -> str:
    """The main kernel a call with rows of ``d`` columns goes to."""
    return "narrow" if d <= NARROW_MAX_D else "wide"


def task_items(d: int, num_segments: int, n_rows: int) -> int:
    """Entries of the merged list per warp task of a launch."""
    return ITEMS[route(d)] if n_rows >= num_segments else SPARSE_ITEMS


def n_tasks(num_segments: int, n_rows: int, items: int) -> int:
    """Warp tasks of a launch: enough for every entry of the merged list
    (the rows past indptr[N] counted too, so the host needs no sync)."""
    return max(1, -(-(num_segments + n_rows) // items))


def merge_path_plain(data: Tensor, indptr: Tensor, *, num_segments: int,
                     items: int) -> Tensor:
    """The kernel's partition and carry merge in plain PyTorch (float64
    parts, rounded once): task t takes entries [t * items, (t + 1) * items)
    of the merged list of segment ends and rows; each segment ending in a
    task gets the task's own rows of it, and the carries of the earlier
    tasks holding its rows are added in task order, as the fix-up launch
    adds them.  indptr is clamped as the kernel clamps it."""
    e = data.shape[0]
    flat = data.reshape(e, -1).to(torch.float64)
    d = flat.shape[1]
    ip = indptr.long()
    nnz = int(ip[-1].clamp(0, e))
    p = ip.clamp(0, nnz)
    p[-1] = nnz
    total = num_segments + nnz
    nt = n_tasks(num_segments, e, items)
    # bounds[b]: segment ends among the first min(b * items, total) entries
    # (segment s's end is entry s + p[s + 1] of the merged list)
    keys = torch.arange(num_segments) + p[1:]
    diag = torch.clamp(torch.arange(nt + 1) * items, max=total)
    bounds = torch.searchsorted(keys, diag)
    out = torch.zeros((num_segments, d), dtype=torch.float64)
    carry = torch.zeros((nt, d), dtype=torch.float64)
    for t in range(nt):
        i0, i1 = int(bounds[t]), int(bounds[t + 1])
        j0, j1 = int(diag[t]) - i0, int(diag[t + 1]) - i1
        for s in range(i0, min(i1, num_segments - 1) + 1):
            rb = max(int(p[s]), j0)
            re = max(int(p[s + 1]) if s < i1 else j1, rb)
            part = flat[rb:re].sum(0)
            if s < i1:
                out[s] = part
            else:
                carry[t] = part
    for s in range(num_segments):
        ta = (s + int(p[s])) // items
        tf = (s + int(p[s + 1])) // items
        for t in range(ta, tf):
            out[s] += carry[t]
    return out.to(torch.float32).reshape((num_segments,)
                                         + tuple(data.shape[1:]))


def sort_by_segment(seg_ids: Tensor, num_segments: int
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """(order, sorted ids, indptr) of a stable sort by segment.

    Ids outside [0, num_segments) become ``num_segments`` and sort to the
    tail, past ``indptr[num_segments]``, where no segment reads them.
    ``order`` is int64 (a gather index), the sorted ids and the
    (num_segments + 1,) ``indptr`` int32.
    """
    seg = seg_ids.to(torch.int32)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg,
                      torch.full_like(seg, num_segments))
    seg_s, order = torch.sort(seg, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=seg.device)
    indptr = torch.searchsorted(seg_s, bounds).to(torch.int32)
    return order, seg_s, indptr


#: Rows per float64 ``index_add_`` of the plain versions (bounds the
#: float64 copy of the data: 1 GB at D = 64).
PLAIN_CHUNK_ROWS = 1 << 21


def _plain_sum(data: Tensor, seg_ids: Tensor, num_segments: int) -> Tensor:
    """``ref.segment_sum_ref`` accumulated in float64 (``index_add_`` over
    chunks of rows) and rounded once to float32: the sum to float32
    rounding whatever the order of the additions, so a difference from it
    is the kernel's own."""
    seg = seg_ids.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg,
                      torch.full_like(seg, num_segments))
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=torch.float64, device=data.device)
    for lo in range(0, data.shape[0], PLAIN_CHUNK_ROWS):
        hi = lo + PLAIN_CHUNK_ROWS
        out.index_add_(0, seg[lo:hi], data[lo:hi].to(torch.float64))
    return out[:num_segments].to(torch.float32)


def sorted_segment_sum_plain(data: Tensor, seg_ids: Tensor, indptr: Tensor,
                             *, num_segments: int) -> Tensor:
    """The kernel's function in plain PyTorch (any device): ``index_add_``
    by ``seg_ids`` in float64, rounded to float32; ``indptr`` is not
    read."""
    return _plain_sum(data, seg_ids, num_segments)


def segment_sum_plain(data: Tensor, seg_ids: Tensor, *,
                      num_segments: int) -> Tensor:
    """The unsorted entry in plain PyTorch (any device)."""
    return _plain_sum(data, seg_ids, num_segments)


def bound_bytes(data: Tensor, n_live: int, num_segments: int) -> int:
    """Bytes the function must move: the ``n_live`` rows read once, indptr
    read once, the float32 (num_segments, D) output written once."""
    d = data.shape[1] if data.dim() == 2 else 1
    return (n_live * d * data.element_size() + (num_segments + 1) * 4
            + num_segments * d * 4)


def _check(data: Tensor, indptr: Tensor, num_segments: int) -> None:
    if data.device.type != "cuda" or indptr.device != data.device:
        raise ValueError(f"data and indptr must share one CUDA device, got "
                         f"{data.device}, {indptr.device}")
    if data.dtype != torch.float32:
        raise ValueError(f"data must be float32, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be (E, D), got {tuple(data.shape)}")
    if data.shape[1] > 1 and data.stride(1) != 1:
        raise ValueError("data needs a unit stride on its last dimension")
    if data.shape[0] >= 2**31 - 128:
        raise ValueError(f"{data.shape[0]} rows exceed the kernel's int32 "
                         f"row pointers")
    if indptr.dtype != torch.int32 or tuple(indptr.shape) != (num_segments + 1,) \
            or not indptr.is_contiguous():
        raise ValueError(f"indptr must be a contiguous ({num_segments + 1},) "
                         f"int32 tensor, got {tuple(indptr.shape)} "
                         f"{indptr.dtype}")


def sorted_segment_sum(data: Tensor, seg_ids: Tensor, indptr: Tensor, *,
                       num_segments: int) -> Tensor:
    """Segment sum of rows pre-sorted by segment.

    Args:
      data:    (E, D) or (E,) float32 rows, sorted ascending by segment.
      seg_ids: (E,) sorted segment ids (>= num_segments: padding at the
               tail); the plain version's input, not read by the kernel.
      indptr:  (num_segments + 1,) int32 CSR pointers into the rows,
               non-decreasing (clamped to [0, E] by the kernel).
      num_segments: N.

    Returns:
      (N, D) float32 ((N,) for 1-D data); empty segments are 0.
    """
    if _build.off_card(data, indptr):
        return sorted_segment_sum_plain(data, seg_ids, indptr,
                                        num_segments=num_segments)
    if data.dim() == 1:
        return sorted_segment_sum(data[:, None], seg_ids, indptr,
                                  num_segments=num_segments)[:, 0]
    global launches
    _check(data, indptr, num_segments)
    e, d = data.shape
    dev = data.device
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    ld = data.stride(0) if e > 1 else d
    kind = route(d)
    aligned = data.data_ptr() % 16 == 0
    vec = aligned and (ld == d if kind == "narrow"
                       else d % 4 == 0 and ld % 4 == 0)
    items = task_items(d, num_segments, e)
    nt = n_tasks(num_segments, e, items)
    # per-call workspace: the task bounds, each task's carry and head (the
    # parts of the segments its edges cut: sums and errors)
    bounds = torch.empty((nt + 1,), dtype=torch.int32, device=dev)
    carry = torch.empty((nt, 4, d), dtype=torch.float32, device=dev)
    err = fn(data.data_ptr(), indptr.data_ptr(), out.data_ptr(),
             bounds.data_ptr(), carry.data_ptr(), num_segments, e, d, ld,
             int(vec), items, nt, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sorted_segment_sum")
    launches += 1
    launches_by_kernel[kind] += 1
    return out


def segment_sum(data: Tensor, seg_ids: Tensor, *, num_segments: int) -> Tensor:
    """Segment sum of unsorted rows; ids outside [0, num_segments) dropped.

    On the card: a stable sort by segment, the CSR pointer, then the
    kernel (one launch).  Returns (N, D) float32 ((N,) for 1-D data).
    """
    if _build.off_card(data, seg_ids):
        return segment_sum_plain(data, seg_ids, num_segments=num_segments)
    order, seg_s, indptr = sort_by_segment(seg_ids, num_segments)
    return sorted_segment_sum(data[order], seg_s, indptr,
                              num_segments=num_segments)


# ---------------------------------------------------------------- backward --

def _bwd_kernel():
    global _bwd
    if _bwd is None:
        lib = _build.library("segment_sum")
        fn = lib.segment_sum_backward_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd = (lib, fn)
    return _bwd


def sorted_segment_sum_backward_plain(d_out: Tensor, seg_ids: Tensor,
                                      indptr: Tensor) -> Tensor:
    """The backward kernel's function in plain PyTorch (any device): row e
    gets ``d_out[seg_ids[e]]`` where ``seg_ids[e]`` is a segment, else 0.
    Reads ``seg_ids`` and never ``indptr``, as the forward's plain version
    does.  Returns (E, D) float32 ((E,) for 1-D ``d_out``)."""
    n = d_out.shape[0]
    seg = seg_ids.long()
    live = (seg >= 0) & (seg < n)
    g = d_out.to(torch.float32)
    rows = g[seg.clamp(0, max(n - 1, 0))] if n else \
        g.new_zeros((seg.shape[0],) + tuple(g.shape[1:]))
    mask = live.reshape((-1,) + (1,) * (g.dim() - 1))
    return torch.where(mask, rows, torch.zeros_like(rows))


def sorted_segment_sum_backward(d_out: Tensor, seg_ids: Tensor,
                                indptr: Tensor) -> Tensor:
    """Gradient of the rows of `sorted_segment_sum` given the output's
    gradient ``d_out`` (N, D) or (N,): (E, D) float32, E = ``seg_ids``'
    length, each live row its segment's ``d_out`` row and 0 elsewhere.
    CPU tensors go to `sorted_segment_sum_backward_plain`; on a CUDA tensor
    the kernel launches (reading ``indptr``) or the call raises."""
    if _build.off_card(d_out, indptr):
        return sorted_segment_sum_backward_plain(d_out, seg_ids, indptr)
    if d_out.dim() == 1:
        return sorted_segment_sum_backward(d_out[:, None], seg_ids,
                                           indptr)[:, 0]
    global bwd_launches
    n, d = d_out.shape
    _check(d_out, indptr, n)
    e = seg_ids.shape[0]
    g = d_out.contiguous()
    out = torch.empty((e, d), dtype=torch.float32, device=d_out.device)
    if out.numel() == 0:
        return out
    lib, fn = _bwd_kernel()
    vec = d % 4 == 0 and g.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = fn(g.data_ptr(), indptr.data_ptr(), out.data_ptr(), n, e, d, d,
             int(vec), torch.cuda.current_stream(d_out.device).cuda_stream)
    _build.check(lib, err, "sorted_segment_sum_backward")
    bwd_launches += 1
    return out


class SortedSegmentSumFn(torch.autograd.Function):
    """`sorted_segment_sum` (the forward kernel, unchanged) with
    `sorted_segment_sum_backward` as the rows' gradient."""

    @staticmethod
    def forward(ctx, data, seg_ids, indptr, num_segments):
        out = sorted_segment_sum(data, seg_ids, indptr,
                                 num_segments=num_segments)
        ctx.save_for_backward(seg_ids, indptr)
        return out

    @staticmethod
    def backward(ctx, d_out):
        seg_ids, indptr = ctx.saved_tensors
        return (sorted_segment_sum_backward(d_out, seg_ids, indptr),
                None, None, None)
