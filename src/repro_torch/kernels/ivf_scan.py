"""IVF stage 0 over list-major member slabs: wrapper for the CUDA kernel.

Replaces the TPU kernel ``ivf_scan_topk`` of the JAX package
(``src/repro/kernels/ivf_scan.py:275`` → ``_ivf_scan_call`` ``:227``, body
``_kernel`` ``:182``, ``pallas_call`` ``:243``).  Member vectors are packed
*list-major* at build time (`pack_ivf_lists`): list ``c``'s members occupy
the contiguous slab ``rows[c·max_len : (c+1)·max_len]`` at the stage-0
dimensionality, as float32 or as per-dimension int8 codes (`core.quant`'s
grid).  For each query the kernel (``csrc/ivf_scan.cu``) scores the members
of its probed lists, ``sq − 2·q·x`` with padding and tombstones (id -1)
masked, and keeps the top-k — the candidate table, the gathered rows and
the score matrix never reach device memory.

Bound on an H100 SXM at the serving shape (Q=32, n_probe 12, max_len 512,
dim 128): the probed slabs are 32·12·512 rows of 512 B (f32, 101 MB) or
128 B (int8, 25 MB) plus 8 B of norm and id per row — about 30 µs and
8 µs at 3.35 TB/s.  The kernel reads each query's probed lists on its own
(queries share no reads), so its bytes are those, not fewer.

On a CPU tensor the wrapper runs the plain version (`ivf_scan_topk_plain`);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

Array = torch.Tensor

#: Largest k the kernel keeps per query (its per-block candidate buffer
#: lives in shared memory); larger k raises ValueError.
MAX_K = 2048

#: Calls that launched the kernel pair (list scan + merge) on the card.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("ivf_scan")
        fn = lib.ivf_scan_topk_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


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


def _query(q: Array, pack: Dict) -> Array:
    """The query as the kernel scores it: ``[:, :dim]`` in float32, folded
    onto the codes' grid for int8 slabs (outside the kernel, as in the JAX
    package)."""
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


def ivf_scan_topk_plain(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
) -> Tuple[Array, Array]:
    """The kernel's function in plain PyTorch (any device): gather the
    probed slabs, score them, stable-sort the (Q, n_probe·max_len) scores
    in scan order (probe rank, then slot)."""
    if pack["dtype"] == "pq":
        raise ValueError(
            "pq packs are scanned by repro_torch.kernels.pq_scan."
            "pq_ivf_scan_topk (ADC lookup-table scoring)")
    nq = q.shape[0]
    max_len, d0 = pack["max_len"], pack["dim"]
    member_ids = _pad_members(member_ids, max_len)
    qd = _query(q, pack)
    pl = probe.long()
    slab = (pl[:, :, None] * max_len
            + torch.arange(max_len, device=pl.device)).reshape(nq, -1)
    rows = pack["rows"][slab].to(torch.float32)            # (Q, C, d0)
    ip = torch.einsum("qd,qcd->qc", qd, rows)
    s = pack["sq"].reshape(-1)[slab] - 2.0 * ip
    cand = member_ids[pl].reshape(nq, -1)
    s = s.masked_fill(cand < 0, float("inf"))
    del rows
    return _topk_of(s, cand, k)


def _check(q, probe, member_ids, pack, k):
    rows = pack["rows"]
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (probe, member_ids, rows, pack["sq"])):
        raise ValueError("q, probe, member_ids and the pack must share one "
                         "CUDA device")
    if q.dim() != 2 or probe.dim() != 2 or probe.shape[0] != q.shape[0]:
        raise ValueError(f"need q (Q, D) and probe (Q, n_probe), got "
                         f"{tuple(q.shape)}, {tuple(probe.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]: the IVF scan kernel "
                         f"keeps at most {MAX_K} candidates per query")
    n_lists = member_ids.shape[0]
    want = (torch.float32 if pack["dtype"] == "float32" else torch.int8)
    if rows.dtype != want or tuple(rows.shape) != (n_lists * pack["max_len"],
                                                   pack["dim"]):
        raise ValueError(f"pack rows must be ({n_lists * pack['max_len']}, "
                         f"{pack['dim']}) {want}, got {tuple(rows.shape)} "
                         f"{rows.dtype}")


def ivf_scan_topk(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
) -> Tuple[Array, Array]:
    """Score every probed list's members, keep the best k per query.

    Args:
      q:          (Q, D) queries (only ``[:, :pack['dim']]`` is scored).
      probe:      (Q, n_probe) int32 probed list indices, all in
                  ``[0, n_lists)`` and distinct within a row.
      member_ids: (n_lists, max_len) int32 global doc ids with every
                  unreturnable slot already masked to -1 (list padding AND
                  tombstoned rows — the packed member vectors are a
                  build-time snapshot and are not consulted for liveness).
      pack:       `pack_ivf_lists` output, dtype 'float32' or 'int8'.
      k:          neighbours kept (k may exceed the rows scanned).

    Returns:
      ((Q, k) float32 rank-equivalent L2 scores ascending, +inf at empty
      slots; (Q, k) int32 global doc ids, -1 at empty slots).  Equal scores
      keep the earlier scan position (probe rank, then slot).
    """
    if pack["dtype"] == "pq":
        raise ValueError(
            "pq packs are scanned by repro_torch.kernels.pq_scan."
            "pq_ivf_scan_topk (ADC lookup-table scoring)")
    if q.device.type == "cpu":
        return ivf_scan_topk_plain(q, probe, member_ids, pack, k=k)
    global launches
    member_ids = _pad_members(member_ids, pack["max_len"])
    _check(q, probe, member_ids, pack, k)
    nq, n_probe = probe.shape
    dev = q.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    qd = _query(q, pack).contiguous()
    probe = probe.to(torch.int32).contiguous()
    member_ids = member_ids.to(torch.int32).contiguous()
    max_len = pack["max_len"]
    kp = min(k, max_len)
    part = torch.empty((nq, n_probe, kp), dtype=torch.int64, device=dev)
    lib, fn = _kernel()
    err = fn(qd.data_ptr(), probe.data_ptr(),
             pack["rows"].data_ptr(), pack["sq"].data_ptr(),
             member_ids.data_ptr(), part.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(),
             nq, n_probe, max_len, pack["dim"], k, kp,
             int(pack["dtype"] == "int8"),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ivf_scan_topk")
    launches += 1
    return out_s, out_i


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
