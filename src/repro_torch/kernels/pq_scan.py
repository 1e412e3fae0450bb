"""PQ ADC stage-0 scans: wrappers for the CUDA kernels.

Replace the TPU kernels ``pq_scan_topk`` and ``pq_ivf_scan_topk`` of the
JAX package (``src/repro/kernels/pq_scan.py:130`` → ``_pq_scan_call``
``:97``, ``pallas_call`` ``:102``; ``:224`` → ``_pq_ivf_call`` ``:175``,
``pallas_call`` ``:193``; shared body ``_pq_body`` ``:51``).  A row's score
is ``Σ_m lut[m, code[m]]``: the per-query (M, C) ADC table sits in shared
memory while the uint8 code rows stream through, ids of -1 (padding,
tombstones, rows past the coded prefix) are masked, and only the (Q, k)
result reaches device memory.  One source (``csrc/pq_scan.cu``) holds both
entry points around one scoring body, as the two Pallas calls share
``_pq_body``:

* `pq_scan_topk` — **flat**: the whole (N, M) code block, split into row
  ranges across blocks, then a merge per query.  Backs
  ``QuantizedProgressiveBackend(codec='pq')``.
* `pq_ivf_scan_topk` — **list-major**: one block per (query, probed list)
  over `pack_ivf_lists(dtype='pq')` slabs, then a merge per query.  Backs
  ``IVFProgressiveBackend(stage0_dtype='pq')``.

Bound on an H100 SXM at the serving shapes: the flat scan reads 16 B of
codes and 4 B of id per row — 21 MB for 1M rows, about 6 µs at 3.35 TB/s
when every query shares one read.  The kernel gives each query its own
blocks, so it reads the codes once per query (from L2 after the first: the
16 MB block fits in the 50 MB cache) and does Q·N·M table lookups in
shared memory; that, not device memory, bounds it.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import _pad_members, _topk_of

Array = torch.Tensor

#: Largest k the kernels keep per query; larger k raises ValueError.
MAX_K = 2048
#: Largest LUT (M·C entries) a block holds in shared memory.
MAX_LUT = 32768

#: Calls that launched the flat scan pair (range scan + merge) on the card.
flat_launches = 0
#: Calls that launched the list-major scan pair (list scan + merge).
ivf_launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("pq_scan")
        flat = lib.pq_scan_topk_launch
        flat.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
        flat.restype = ctypes.c_int
        ivf = lib.pq_ivf_scan_topk_launch
        ivf.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])
        ivf.restype = ctypes.c_int
        _fn = (lib, flat, ivf)
    return _fn


def pq_scan_topk_plain(
    lut: Array, codes: Array, ids: Array, *, k: int,
) -> Tuple[Array, Array]:
    """The flat kernel's function in plain PyTorch (any device)."""
    from repro_torch.core.pq import pq_adc_scores
    s = pq_adc_scores(lut.to(torch.float32), codes)
    s = s.masked_fill(ids[None, :] < 0, float("inf"))
    return _topk_of(s, ids[None, :].expand(s.shape[0], -1), k)


def pq_ivf_scan_topk_plain(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
    lut: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """The list-major kernel's function in plain PyTorch (any device)."""
    lut = _lut(q, pack, lut)
    nq = lut.shape[0]
    max_len = pack["max_len"]
    member_ids = _pad_members(member_ids, max_len)
    pl = probe.long()
    slab = (pl[:, :, None] * max_len
            + torch.arange(max_len, device=pl.device)).reshape(nq, -1)
    idx = pack["rows"].long()[slab]                       # (Q, C, M)
    s = torch.gather(lut[:, 0, :], 1, idx[:, :, 0])
    for j in range(1, idx.shape[2]):
        s = s + torch.gather(lut[:, j, :], 1, idx[:, :, j])
    cand = member_ids[pl].reshape(nq, -1)
    s = s.masked_fill(cand < 0, float("inf"))
    return _topk_of(s, cand, k)


def _lut(q, pack, lut):
    if pack["dtype"] != "pq":
        raise ValueError(
            f"pq_ivf_scan_topk needs a dtype='pq' pack, got "
            f"{pack['dtype']!r} (use ivf_scan_topk)")
    if lut is None:
        from repro_torch.core.pq import pq_lut
        lut = pq_lut(q[:, : pack["dim"]], pack["codebooks"], pack["cent_sq"])
    return lut.to(torch.float32)


def _check(lut, codes, k, *others):
    dev = lut.device
    if dev.type != "cuda" or any(t.device != dev for t in (codes, *others)):
        raise ValueError("the LUT, codes and ids must share one CUDA device")
    if lut.dim() != 3 or codes.dim() != 2 or codes.dtype != torch.uint8 \
            or codes.shape[1] != lut.shape[1]:
        raise ValueError(f"need lut (Q, M, C) and uint8 codes (N, M), got "
                         f"{tuple(lut.shape)}, {tuple(codes.shape)} "
                         f"{codes.dtype}")
    if lut.shape[1] * lut.shape[2] > MAX_LUT:
        raise ValueError(f"LUT of {lut.shape[1]}x{lut.shape[2]} entries "
                         f"exceeds the kernel's {MAX_LUT}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]: the PQ scan kernels "
                         f"keep at most {MAX_K} candidates per query")


def _n_split(nq: int, n: int, dev) -> int:
    """Row ranges per query for the flat scan: about four blocks per SM
    in all, and at least a thousand rows per range."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, -(-4 * sms // max(nq, 1)))
    return max(1, min(want, -(-n // 1024)))


def pq_scan_topk(
    lut: Array, codes: Array, ids: Array, *, k: int,
) -> Tuple[Array, Array]:
    """Flat ADC scan: score every coded row, keep the best k per query.

    Args:
      lut:   (Q, M, C) per-query ADC tables (`repro_torch.core.pq.pq_lut`).
      codes: (N, M) uint8 PQ codes.
      ids:   (N,) int32 ids with every unreturnable row already masked to
             -1 (tombstones, rows past the coded prefix); live rows carry
             their own index.
      k:     neighbours kept (k may exceed N).

    Returns:
      ((Q, k) float32 ADC scores ascending, +inf at empty slots; (Q, k)
      int32 ids, -1 at empty slots).  Equal scores keep the lower row.
    """
    if lut.device.type == "cpu":
        return pq_scan_topk_plain(lut, codes, ids, k=k)
    global flat_launches
    _check(lut, codes, k, ids)
    nq, m, c = lut.shape
    n = codes.shape[0]
    dev = lut.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    lut = lut.to(torch.float32).contiguous()
    codes = codes.contiguous()
    ids = ids.to(torch.int32).contiguous()
    n_split = _n_split(nq, n, dev)
    rows_per = max(1, -(-n // n_split))
    n_split = max(1, -(-n // rows_per))
    kp = min(k, rows_per)
    part = torch.empty((nq, n_split, kp), dtype=torch.int64, device=dev)
    lib, flat, _ = _kernel()
    err = flat(lut.data_ptr(), codes.data_ptr(), ids.data_ptr(),
               part.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
               nq, n, m, c, n_split, rows_per, k, kp,
               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pq_scan_topk")
    flat_launches += 1
    return out_s, out_i


def pq_ivf_scan_topk(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
    lut: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """IVF-PQ stage 0: the ADC scan over each query's probed list slabs.

    Args:
      q:          (Q, D) queries (only ``[:, :pack['dim']]`` feeds the LUT;
                  ignored when ``lut`` is given).
      probe:      (Q, n_probe) int32 probed list indices (distinct per row).
      member_ids: (n_lists, max_len) int32 global ids, every unreturnable
                  slot pre-masked to -1 (padding AND tombstones).
      pack:       `pack_ivf_lists(..., dtype='pq')` output.
      k:          neighbours kept (k may exceed the rows scanned).
      lut:        optional precomputed (Q, M, C) ADC tables.

    Returns:
      ((Q, k) float32 ADC scores ascending, +inf empties; (Q, k) int32
      global doc ids, -1 empties).  Equal scores keep the earlier scan
      position (probe rank, then slot).
    """
    if q.device.type == "cpu":
        return pq_ivf_scan_topk_plain(q, probe, member_ids, pack, k=k,
                                      lut=lut)
    global ivf_launches
    lut = _lut(q, pack, lut).contiguous()
    max_len = pack["max_len"]
    member_ids = _pad_members(member_ids, max_len).to(torch.int32).contiguous()
    codes = pack["rows"]
    _check(lut, codes, k, probe, member_ids)
    nq, m, c = lut.shape
    n_probe = probe.shape[1]
    if probe.shape[0] != nq or codes.shape[0] != member_ids.numel():
        raise ValueError(f"probe {tuple(probe.shape)}, codes "
                         f"{tuple(codes.shape)} and member_ids "
                         f"{tuple(member_ids.shape)} do not match")
    dev = lut.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    probe = probe.to(torch.int32).contiguous()
    kp = min(k, max_len)
    part = torch.empty((nq, n_probe, kp), dtype=torch.int64, device=dev)
    lib, _, ivf = _kernel()
    err = ivf(lut.data_ptr(), codes.contiguous().data_ptr(),
              member_ids.data_ptr(), probe.data_ptr(), part.data_ptr(),
              out_s.data_ptr(), out_i.data_ptr(),
              nq, n_probe, max_len, m, c, k, kp,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pq_ivf_scan_topk")
    ivf_launches += 1
    return out_s, out_i


def flat_stage0_bytes_model(
    *,
    n: int,
    k: int,
    row_bytes: float,
    lut_bytes: float = 0.0,
) -> Dict[str, float]:
    """Modeled per-query stage-0 device-memory bytes for a *flat* coded
    scan (the full-scan twin of `ivf_scan.stage0_bytes_model`):

      unfused: read the code block once (``row_bytes``/row), write +
               re-read the (N,) f32 score row for the top-k, plus the LUT.
      fused  : stream the code block once, the (N,) masked id table, the
               LUT read, and the (k,) result.
    """
    n = float(n)
    xla = row_bytes * n + 2 * 4 * n + lut_bytes
    fused = row_bytes * n + 4 * n + lut_bytes + 8 * k
    return {"xla_bytes": xla, "fused_bytes": fused,
            "ratio": fused / xla if xla else 0.0}
