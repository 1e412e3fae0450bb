"""IVF stage 0 over list-major member slabs: wrapper for the CUDA kernel.

Replaces the TPU kernel ``ivf_scan_topk`` of the JAX package
(``src/repro/kernels/ivf_scan.py:275`` → ``_ivf_scan_call`` ``:227``, body
``_kernel`` ``:182``, ``pallas_call`` ``:243``).  Member vectors are packed
*list-major* at build time (`pack_ivf_lists`): list ``c``'s members occupy
the contiguous slab ``rows[c·max_len : (c+1)·max_len]`` at the stage-0
dimensionality, as float32 or as per-dimension int8 codes (`core.quant`'s
grid).  For each query the kernel (``csrc/ivf_scan.cu`` around the body of
``csrc/list_scan.cuh``) scores the live members of its probed lists,
``sq − 2·q·x``, and keeps the top-k in one launch — the candidate table,
the gathered rows, the score matrix and a masked member table never reach
device memory.  Tombstones are read in the kernel: given the store's
``valid`` bits it scans a slot only if its id is ``>= 0`` and valid, so a
dispatch passes the raw member table; without ``valid`` the table must be
pre-masked (the JAX package's contract).  int8 queries are folded onto
the codes' grid inside the kernel, with `core.quant.fold_int8_query`'s
operations in its order.

Bound on an H100 SXM at the serving shape (Q=32, n_probe 12, max_len 512,
dim 128; 93% of the probed slots live): when each query reads its own
lists, about 92 MB of float32 rows (23 MB of int8) plus 8 B of id and norm
a slot — 28 µs and 7 µs at 3.35 TB/s; when each distinct probed list is
read once (61% of the probes at the serving state), 18 µs and 5 µs.  The
kernel reads each query's lists for that query alone (a list two queries
probe is read twice, the second time often from L2).

On a CPU tensor the wrapper runs the plain version (`ivf_scan_topk_plain`);
on a CUDA tensor it launches the kernel or raises.  `ivf_scan_mirror`
repeats the kernel's arithmetic (one FMA chain a row, in dim order) on any
device.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

Array = torch.Tensor

#: Largest k the kernel keeps per query (its key buffer lives in shared
#: memory); larger k raises ValueError.
MAX_K = 2048
#: Most CTAs a query's cluster takes (the portable cluster size).
MAX_CLUSTER = 8

#: Calls that launched the kernel on the card, in all and by slab type.
launches = 0
launches_by_kernel: Dict[str, int] = {"float32": 0, "int8": 0}

# ListScanArgs of csrc/list_scan.cuh: q, lut, scale, probe, rows, sq, lists,
# valid, out_s, out_i, stream; kind, nq, ld_q, n_probe, n_lists, max_len,
# ld_lists, width, c, k, cluster, n_valid, ld_m; the tail padding of a
# struct aligned to 8
ARGS = struct.Struct("@11Q13i4x")
KINDS = {"float32": 0, "int8": 1, "pq": 2}
_local = threading.local()        # a packing buffer for each thread
_fn = None


def args_buffer():
    """This thread's ListScanArgs buffer and its address."""
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = ctypes.create_string_buffer(ARGS.size)
        _local.addr = ctypes.addressof(buf)
    return buf, _local.addr


def bind(lib, name: str):
    """The entry ``name`` of a list-scan library, its argument block's size
    checked against `ARGS`."""
    size = lib.list_scan_args_size
    size.argtypes, size.restype = [], ctypes.c_int
    if size() != ARGS.size:
        raise RuntimeError(f"{name}: the library's argument block is "
                           f"{size()} bytes, the wrapper packs {ARGS.size}")
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("ivf_scan")
        _fn = (lib, bind(lib, "ivf_scan_topk_launch"))
    return _fn


def last_cluster(lib=None) -> int:
    """CTAs a query of the last launch of a list-scan library (this
    module's by default; `pq_scan`'s has its own)."""
    lib = _kernel()[0] if lib is None else lib
    fn = lib.list_scan_last_cluster
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def pack_ivf_lists(
    db: Array,
    lists: Array,
    *,
    dim: int,
    db_sq_at_dim: Optional[Array] = None,
    dtype: str = "float32",
    block_m: int = 128,
    scale: Optional[Array] = None,
    pq_codebooks: Optional[Array] = None,
) -> Dict:
    """Build the list-major member pack the IVF scan kernels read.

    Args:
      db:           (N, D) corpus rows (snapshot at build time).
      lists:        (n_lists, max_len) int32 member table, -1 padded.
      dim:          stage-0 dimensionality; member slabs store ``[:, :dim]``.
      db_sq_at_dim: optional (N,) precomputed prefix squared norms at
                    ``dim`` (the store's cached column) — keeps the pack's
                    norms identical to the rescore path's.
      dtype:        'float32' | 'int8' (per-dimension symmetric codes; the
                    packed norms become the *dequantized* ones) | 'pq'
                    (product-quantization codes against ``pq_codebooks``;
                    ADC needs no norm table — ``sq`` is None).
      block_m:      ``max_len`` is padded to a multiple of it (the JAX
                    package's kernel step; kept so packs carry over between
                    the packages with the same layout).
      scale:        optional (dim,) int8 grid to reuse (int8 only).
      pq_codebooks: (M, C, dim//M) PQ codebooks ('pq' only, required).

    Returns:
      dict: ``rows`` (n_lists·max_len_p, dim-or-M) member slabs, ``sq``
      (n_lists, max_len_p) f32 norms (+inf at pads; None for 'pq'),
      ``scale`` (dim,) f32 or None, ``codebooks``/``cent_sq`` ('pq' only),
      plus meta (``dim``, ``max_len``, ``block_m``, ``dtype``).
    """
    if dtype not in ("float32", "int8", "pq"):
        raise ValueError(f"pack dtype must be float32|int8|pq, got {dtype!r}")
    if dtype == "pq" and pq_codebooks is None:
        raise ValueError("dtype='pq' needs pq_codebooks (see repro_torch.core.pq)")
    # repro_torch.core imports the kernels' dispatch: import it at call time
    from repro_torch.core import quant
    n_lists, max_len = lists.shape
    bm = min(int(block_m), max(int(max_len), 1))
    pad = -max_len % bm
    if pad:
        lists = torch.nn.functional.pad(lists, (0, pad), value=-1)
        max_len = max_len + pad
    flat = lists.reshape(-1)
    safe = torch.clamp(flat, min=0).long()
    rows = db[safe, :dim].to(torch.float32)            # (n_lists*max_len, dim)
    member = flat >= 0
    inf = torch.tensor(float("inf"), device=rows.device)

    codebooks = cent_sq = None
    if dtype == "int8":
        if scale is None:
            # fit the grid on real member rows only (pad slots repeat row 0)
            scale = quant.fit_int8_scale(rows, member)
        rows, sq = quant.int8_encode(rows, scale)
        sq = torch.where(member, sq, inf).reshape(n_lists, max_len)
    elif dtype == "pq":
        from repro_torch.core.pq import pq_cent_sq, pq_encode
        scale, sq = None, None
        codebooks = pq_codebooks
        cent_sq = pq_cent_sq(codebooks)
        rows = pq_encode(rows, codebooks)              # (n_lists*max_len, M)
    else:
        scale = None
        if db_sq_at_dim is not None:
            sq = db_sq_at_dim[safe].to(torch.float32)
        else:
            sq = (rows * rows).sum(dim=-1)
        sq = torch.where(member, sq, inf).reshape(n_lists, max_len)
    return {
        "rows": rows,
        "sq": sq,
        "scale": scale,
        "codebooks": codebooks,
        "cent_sq": cent_sq,
        "dim": int(dim),
        "max_len": int(max_len),
        "block_m": int(bm),
        "dtype": dtype,
    }


def update_pack(pack: Dict, db: Array, ids, dests) -> Dict:
    """Write appended rows into the pack's member slabs (incremental IVF).

    ``ids`` are global doc ids, ``dests`` their flat slab positions
    (``list·max_len + slot``).  int8 packs code the new rows with the
    **stored** scale and 'pq' packs encode against the **stored**
    codebooks, so the grid stays consistent with the built slabs.  The
    slab tensors are updated in place (`core.quant.scatter_rows*`); the
    returned dict holds the same tensors.
    """
    from repro_torch.core import quant
    ids = torch.as_tensor(quant.pad_pow2(np.asarray(ids, np.int64)),
                          device=db.device)
    dests = quant.pad_pow2(np.asarray(dests, np.int64))
    rows = db[ids, : pack["dim"]].to(torch.float32)
    out = dict(pack)
    if pack["dtype"] == "pq":
        from repro_torch.core.pq import pq_encode
        quant.scatter_rows(pack["rows"], dests,
                           pq_encode(rows, pack["codebooks"]))
        return out
    if pack["dtype"] == "int8":
        rows, sq = quant.int8_encode(rows, pack["scale"])
    else:
        sq = (rows * rows).sum(dim=-1)
    quant.scatter_rows2(pack["rows"], pack["sq"].view(-1), dests, rows, sq)
    return out


def _pad_members(member_ids: Array, max_len: int) -> Array:
    pad = max_len - member_ids.shape[1]
    if pad:
        member_ids = torch.nn.functional.pad(member_ids, (0, pad), value=-1)
    return member_ids


def mask_members(lists: Array, valid: Optional[Array]) -> Array:
    """The member table with every slot whose id is not valid set to -1
    (the JAX package masks so before its scan); ``valid=None`` keeps it."""
    if valid is None:
        return lists
    return torch.where((lists >= 0) & valid[lists.clamp(min=0).long()],
                       lists, torch.full_like(lists, -1))


def _query(q: Array, pack: Dict) -> Array:
    """The query as the kernel scores it: ``[:, :dim]`` in float32, folded
    onto the codes' grid for int8 slabs."""
    qd = q[:, : pack["dim"]].to(torch.float32)
    if pack["dtype"] == "int8":
        from repro_torch.core import quant
        qd = quant.fold_int8_query(qd, pack["scale"])
    return qd


def _topk_of(s: Array, cand: Array, k: int) -> Tuple[Array, Array]:
    """Top-k smallest per row by (score, column), padded with (+inf, -1)
    when k exceeds the width; non-finite slots carry id -1."""
    nq, c = s.shape
    if k > c:
        s = torch.cat([s, torch.full((nq, k - c), float("inf"),
                                     dtype=s.dtype, device=s.device)], 1)
        cand = torch.cat([cand, torch.full((nq, k - c), -1,
                                           dtype=cand.dtype,
                                           device=cand.device)], 1)
    top_s, pos = torch.sort(s, dim=1, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    idx = torch.gather(cand, 1, pos).to(torch.int32)
    return top_s, torch.where(torch.isfinite(top_s), idx,
                              torch.full_like(idx, -1))


def _no_pq(pack: Dict) -> None:
    if pack["dtype"] == "pq":
        raise ValueError(
            "pq packs are scanned by repro_torch.kernels.pq_scan."
            "pq_ivf_scan_topk (ADC lookup-table scoring)")


def _probed(probe: Array, member_ids: Array, pack: Dict):
    """(slab rows (Q, C) in scan order, their ids (Q, C)) of the probed
    lists, C = n_probe·max_len."""
    nq, max_len = probe.shape[0], pack["max_len"]
    pl = probe.long()
    slab = (pl[:, :, None] * max_len
            + torch.arange(max_len, device=pl.device)).reshape(nq, -1)
    return slab, _pad_members(member_ids, max_len)[pl].reshape(nq, -1)


def ivf_scan_topk_plain(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
    valid: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """The kernel's function in plain PyTorch (any device): mask the member
    table by ``valid`` (when given), gather the probed slabs, score them,
    stable-sort the (Q, n_probe·max_len) scores in scan order (probe rank,
    then slot)."""
    _no_pq(pack)
    slab, cand = _probed(probe, mask_members(member_ids, valid), pack)
    qd = _query(q, pack)
    rows = pack["rows"][slab].to(torch.float32)            # (Q, C, d0)
    ip = torch.einsum("qd,qcd->qc", qd, rows)
    s = pack["sq"].reshape(-1)[slab] - 2.0 * ip
    s = s.masked_fill(cand < 0, float("inf"))
    del rows
    return _topk_of(s, cand, k)


def fma_chain_dots(qd: Array, rows: Array) -> Array:
    """Dot products as the kernel sums them: one chain a row in dim order,
    starting from the first product, each step ``fmaf(x_d, q_d, acc)``.
    An FMA is emulated in float64 (the product is exact there) and rounded
    once to float32, which equals the card's FMA but where the float64 sum
    itself rounds onto a float32 halfway point (a double rounding: rare).

    qd (Q, d) float32; rows (Q, C, d) float32 → (Q, C) float32.
    """
    q64 = qd.to(torch.float64)[:, None, :]
    r64 = rows.to(torch.float64)
    acc = (r64[..., 0] * q64[..., 0]).to(torch.float32)
    for d in range(1, rows.shape[2]):
        acc = (acc.to(torch.float64) + r64[..., d] * q64[..., d]) \
            .to(torch.float32)
    return acc


def ivf_scan_mirror(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
    valid: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """The kernel's arithmetic in plain PyTorch (any device): the query as
    its prologue folds it, each probed row's dot product by
    `fma_chain_dots`, ``sq − 2·dot`` in float32, the (score, scan position)
    top-k.  The kernel's scores equal these but for a rare double rounding
    of the emulated FMA; the plain version's einsum sums in another
    order."""
    _no_pq(pack)
    slab, cand = _probed(probe, mask_members(member_ids, valid), pack)
    rows = pack["rows"][slab].to(torch.float32)
    s = pack["sq"].reshape(-1)[slab] - 2.0 * fma_chain_dots(_query(q, pack),
                                                           rows)
    s = s.masked_fill(cand < 0, float("inf"))
    return _topk_of(s, cand, k)


# Index states already checked, by the ids of their tensors: weak
# references to the tensors and the constants a launch packs.  A dispatch
# passes the same pack, member table and validity bits call after call.
_states: Dict[tuple, tuple] = {}


def _state(kind: str, pack: Dict, lists: Array, valid: Optional[Array],
           dev: torch.device, what: str) -> tuple:
    """(n_lists, max_len, ld_lists, width, n_valid, rows, sq, scale, lists,
    valid pointers) of an index state, checked once per set of tensors."""
    rows, sq, scale = pack["rows"], pack["sq"], pack["scale"]
    key = (kind, id(rows), id(sq), id(scale), id(lists), id(valid))
    hit = _states.get(key)
    if hit is not None:
        refs, consts = hit
        if refs[0]() is rows and refs[1]() is lists and (
                refs[2] is None or refs[2]() is valid):
            return consts
    if lists.device != dev or rows.device != dev or (
            valid is not None and valid.device != dev):
        raise ValueError(f"{what}: the queries, probe, lists, pack and valid "
                         f"must share one CUDA device")
    if lists.dim() != 2 or lists.dtype != torch.int32 \
            or not lists.is_contiguous():
        raise ValueError(f"{what}: lists must be a contiguous (n_lists, "
                         f"width) int32 tensor, got {tuple(lists.shape)} "
                         f"{lists.dtype}")
    n_lists, max_len = lists.shape[0], pack["max_len"]
    width = rows.shape[1] if kind == "pq" else pack["dim"]
    want = {"float32": torch.float32, "int8": torch.int8,
            "pq": torch.uint8}[kind]
    if rows.dtype != want or rows.shape != (n_lists * max_len, width) \
            or not rows.is_contiguous() or lists.shape[1] > max_len:
        raise ValueError(f"{what}: pack rows must be contiguous "
                         f"({n_lists * max_len}, {width}) {want} for "
                         f"{n_lists} lists of {max_len} slots, got "
                         f"{tuple(rows.shape)} {rows.dtype}; lists "
                         f"{tuple(lists.shape)}")
    if valid is not None and (valid.dtype != torch.bool or valid.dim() != 1
                              or not valid.is_contiguous()):
        raise ValueError(f"{what}: valid must be a contiguous 1-D bool "
                         f"tensor, got {tuple(valid.shape)} {valid.dtype}")
    if kind != "pq" and (sq.device != dev or sq.dtype != torch.float32
                         or sq.numel() != n_lists * max_len
                         or not sq.is_contiguous()):
        raise ValueError(f"{what}: pack sq must be a contiguous "
                         f"({n_lists}, {max_len}) float32 tensor")
    if kind == "int8" and (scale.device != dev or scale.shape != (width,)
                           or scale.dtype != torch.float32):
        raise ValueError(f"{what}: the int8 grid must be ({width},) "
                         f"float32 on {dev}")
    consts = (n_lists, max_len, lists.shape[1], width,
              0 if valid is None else valid.numel(), rows.data_ptr(),
              0 if kind == "pq" else sq.data_ptr(),
              scale.data_ptr() if kind == "int8" else 0, lists.data_ptr(),
              0 if valid is None else valid.data_ptr())
    if len(_states) >= 64:
        _states.clear()
    _states[key] = ((weakref.ref(rows), weakref.ref(lists),
                     None if valid is None else weakref.ref(valid)), consts)
    return consts


def list_scan(lib, fn, kind: str, *, q: Optional[Array], lut: Optional[Array],
              probe: Array, lists: Array, pack: Dict, valid: Optional[Array],
              k: int, cluster: Optional[int], what: str
              ) -> Tuple[Array, Array]:
    """Check one list-major scan call, pack its argument block, launch once.

    ``q`` (kinds float32 / int8) or ``lut`` (pq) is the query side; the
    rest as `ivf_scan_topk`.  Returns ((Q, k) scores, (Q, k) ids)."""
    side = q if lut is None else lut
    dev = side.device
    if dev.type != "cuda" or probe.device != dev:
        raise ValueError(f"{what}: the queries, probe, lists, pack and valid "
                         f"must share one CUDA device")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k={k} outside [1, {MAX_K}]: the kernel "
                         f"keeps at most {MAX_K} candidates per query")
    if cluster is not None and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"{what}: cluster={cluster} outside "
                         f"[1, {MAX_CLUSTER}]")
    if lists.dtype != torch.int32 or not lists.is_contiguous():
        lists = lists.to(torch.int32).contiguous()
    (n_lists, max_len, ld_lists, width, n_valid, p_rows, p_sq, p_scale,
     p_lists, p_valid) = _state(kind, pack, lists, valid, dev, what)
    if probe.dim() != 2 or probe.shape[0] != side.shape[0]:
        raise ValueError(f"{what}: need probe (Q, n_probe) for "
                         f"{side.shape[0]} queries, got {tuple(probe.shape)}")
    if probe.dtype != torch.int32 or not probe.is_contiguous():
        probe = probe.to(torch.int32).contiguous()
    if lut is None:
        if q.dim() != 2 or q.shape[1] < width:
            raise ValueError(f"{what}: need q (Q, >= {width}), got "
                             f"{tuple(q.shape)}")
        if q.dtype != torch.float32 or q.stride(1) != 1:
            q = q[:, :width].to(torch.float32).contiguous()
        c = ld_m = 0
    else:
        if lut.dim() != 3 or lut.shape[1] != width:
            raise ValueError(f"{what}: need lut (Q, {width}, C), got "
                             f"{tuple(lut.shape)}")
        c = lut.shape[2]
        if c > 256 or width * c > 32768:
            raise ValueError(f"{what}: a LUT of {width}x{c} entries exceeds "
                             f"the kernel's 256 codes and 32,768 entries")
        if lut.dtype != torch.float32 or lut.stride(2) != 1:
            lut = lut.to(torch.float32).contiguous()
        ld_m = lut.stride(1)
    nq, n_probe = probe.shape
    out = torch.empty((2, nq, k), dtype=torch.int32, device=dev)
    out_s, out_i = out[0].view(torch.float32), out[1]
    if nq == 0:
        return out_s, out_i
    buf, addr = args_buffer()
    ARGS.pack_into(
        buf, 0, 0 if lut is not None else q.data_ptr(),
        0 if lut is None else lut.data_ptr(), p_scale, probe.data_ptr(),
        p_rows, p_sq, p_lists, p_valid, out_s.data_ptr(), out_i.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index), KINDS[kind], nq,
        (q if lut is None else lut).stride(0), n_probe, n_lists,
        max_len, ld_lists, width, c, k, cluster or 0, n_valid, ld_m)
    _build.check(lib, fn(addr), what)
    return out_s, out_i


def ivf_scan_topk(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
    valid: Optional[Array] = None, cluster: Optional[int] = None,
) -> Tuple[Array, Array]:
    """Score every probed list's live members, keep the best k per query.

    Args:
      q:          (Q, D) queries (only ``[:, :pack['dim']]`` is scored).
      probe:      (Q, n_probe) int32 probed list indices, all in
                  ``[0, n_lists)`` and distinct within a row.
      member_ids: (n_lists, width <= max_len) int32 global doc ids, -1 at
                  list padding; with ``valid=None`` every tombstoned slot
                  must already be -1 too (the packed member vectors are a
                  build-time snapshot and are not consulted for liveness).
      pack:       `pack_ivf_lists` output, dtype 'float32' or 'int8'.
      k:          neighbours kept (k may exceed the rows scanned).
      valid:      optional (N,) bool row-liveness bits over the ids: a slot
                  is scanned only if its id is valid (the kernel reads
                  them; the plain version masks the table first).
      cluster:    CTAs a query (1..8; the launcher's choice when None); the
                  result does not depend on it.

    Returns:
      ((Q, k) float32 rank-equivalent L2 scores ascending, +inf at empty
      slots; (Q, k) int32 global doc ids, -1 at empty slots).  Equal scores
      keep the earlier scan position (probe rank, then slot).
    """
    _no_pq(pack)
    if _build.off_card(q):
        return ivf_scan_topk_plain(q, probe, member_ids, pack, k=k,
                                   valid=valid)
    global launches
    lib, fn = _kernel()
    out = list_scan(lib, fn, pack["dtype"], q=q, lut=None, probe=probe,
                    lists=member_ids, pack=pack, valid=valid, k=k,
                    cluster=cluster, what="ivf_scan_topk")
    if out[0].shape[0]:
        launches += 1
        launches_by_kernel[pack["dtype"]] += 1
    return out


def stage0_bytes_model(
    *,
    n_lists: int,
    max_len: int,
    n_probe: int,
    d0: int,
    k: int,
    member_bytes: int = 4,
    row_bytes: Optional[float] = None,
    lut_bytes: float = 0.0,
    norms: bool = True,
) -> Dict[str, float]:
    """Modeled per-query stage-0 device-memory bytes: fused scan vs the
    gather → candidate table → score matrix lowering.

    Both paths share the probe matmul (centroid read, amortized across the
    batch) so it is excluded; the model counts the candidate-dependent
    terms with C = n_probe · max_len:

      unfused: write + re-read the (C,) id table, read C member rows (4 B/dim
               f32), write + re-read the gathered (C, d0) tensor, and
               write + re-read the (C,) f32 score row for the top-k.
      fused  : stream C member rows once (``member_bytes``/dim, or
               ``row_bytes`` per row when the slab width is decoupled from
               d0 — PQ codes are M bytes/row regardless of d0), plus the
               (C,) id table, the norm side table (``norms=False`` for ADC
               scoring, which needs none), the per-query lookup table
               (``lut_bytes``, PQ only), and the (k,) result.
    """
    c = float(n_probe * max_len)
    xla = (
        2 * 4 * c            # candidate-id table: write + read back
        + 4 * c * d0         # gather reads member rows (f32)
        + 2 * 4 * c * d0     # materialized (C, d0) gather: write + re-read
        + 2 * 4 * c          # (C,) score row: write + read for top_k
    )
    per_row = member_bytes * d0 if row_bytes is None else row_bytes
    fused = (
        per_row * c             # one streaming read of member slabs
        + 4 * c                 # masked id table
        + (4 * c if norms else 0.0)   # packed norms (ADC needs none)
        + lut_bytes             # per-query LUT read
        + 8 * k                 # (k,) scores + ids out
    )
    return {"xla_bytes": xla, "fused_bytes": fused,
            "ratio": fused / xla if xla else 0.0}
