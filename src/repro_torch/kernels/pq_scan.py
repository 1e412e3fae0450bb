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

* `pq_scan_topk` — **flat**: a block holds the tables of a tile of T
  queries (`tile_size`) in the layout ``[m][code][t]``, streams a range of
  the (N, M) code block once for all T of them, and keeps each query's
  survivors in a list in shared memory; then a merge per query.  Backs
  ``QuantizedProgressiveBackend(codec='pq')``.
* `pq_ivf_scan_topk` — **list-major**: one launch a call over
  `pack_ivf_lists(dtype='pq')` slabs (the kernel body of
  ``csrc/list_scan.cuh``, shared with the float32 / int8 IVF scan): a
  cluster of CTAs a query, each holding the query's table once, the
  tombstones read from the store's ``valid`` bits, only live rows scored,
  each row's lookups summed in m order (the plain version's additions in
  its order, so the scores are its bits).  Backs
  ``IVFProgressiveBackend(stage0_dtype='pq')``.

Bound on an H100 SXM at the serving shape (Q = 32, 1M rows, M = 16): the
codes and ids read once are 21 MB, about 6 µs at 3.35 TB/s; the Q·N·M
table lookups (537M four-byte shared-memory reads) take at least 0.064 ms
at 132 SMs × 128 B/clk × 1.98 GHz, and random codes conflict on the banks.
The lookups bound the flat scan; a query tile cuts the code reads from Q
to Q / T and lets one 16-byte load carry four queries' entries.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ivf_scan as _ivf
from repro_torch.kernels.ivf_scan import _topk_of

Array = torch.Tensor

#: Largest k the kernels keep per query; larger k raises ValueError.
MAX_K = 2048
#: Largest LUT (M·C entries) a block holds in shared memory.
MAX_LUT = 32768

#: Rows of a tile of the flat scan (its row ranges are multiples of it).
ROWS = 256
#: Query tile sizes of the flat scan, largest first.
TILES = (8, 4, 2, 1)
#: Dynamic shared memory a block may take on the H100 (227 KB).
SMEM_LIMIT = 232448
#: Shared memory of one SM (a block also takes 1 KB of it for itself).
SMEM_PER_SM = 233472

#: Calls that launched the flat scan pair (range scan + merge) on the card,
#: in all and by the tile size of the range scan's kernel; the list-major
#: scan's calls (one launch each) in all and as ``list``.
flat_launches = 0
ivf_launches = 0
launches_by_kernel: Dict[str, int] = {**{f"tile_{t}": 0 for t in TILES},
                                      "list": 0}

_fn = None
_sms: Dict[int, int] = {}


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("pq_scan")
        flat = lib.pq_scan_topk_launch
        flat.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                         + [ctypes.c_void_p])
        flat.restype = ctypes.c_int
        _fn = (lib, flat, _ivf.bind(lib, "pq_ivf_scan_topk_launch"))
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
    lut: Optional[Array] = None, valid: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """The list-major kernel's function in plain PyTorch (any device): the
    member table masked by ``valid`` (when given), then the ADC scan."""
    lut = _lut(q, pack, lut)
    nq = lut.shape[0]
    slab, cand = _ivf._probed(probe, _ivf.mask_members(member_ids, valid),
                              pack)
    idx = pack["rows"].long()[slab]                       # (Q, C, M)
    s = torch.gather(lut[:, 0, :], 1, idx[:, :, 0])
    for j in range(1, idx.shape[2]):
        s = s + torch.gather(lut[:, j, :], 1, idx[:, :, j])
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


def list_cap(k: int) -> int:
    """Slots of a query's survivor list in the flat scan: k, a tile of
    appends before a tighten is due and a tile of room (``list_cap`` of the
    source)."""
    return (k + 3 * ROWS + 31) & ~31


def tile_smem_bytes(tile: int, m: int, c: int, kp: int) -> int:
    """Dynamic shared memory of the flat scan's pass 1 (``tile_smem_bytes``
    of the source): tables, lists, two staging buffers, counters,
    thresholds and radix histograms."""
    def r16(x):
        return (x + 15) & ~15
    return (r16(4 * m * c * tile) + 8 * tile * list_cap(kp)
            + 2 * (r16(ROWS * m) + 4 * ROWS) + 32 + 8 * 8 + 4 * 256 * tile)


def tile_size(nq: int, m: int, c: int, kp: int) -> int:
    """Queries a block of the flat scan serves: the largest of `TILES` whose
    block fits in shared memory and that no more than one power of two
    above the batch (a batch of 5 takes 8, of 1 takes 1)."""
    for t in TILES:
        if tile_smem_bytes(t, m, c, kp) <= SMEM_LIMIT \
                and (t == 1 or t < 2 * nq):
            return t
    raise ValueError(f"a LUT of {m}x{c} entries at k={kp} leaves no room "
                     f"for the flat scan's lists")


def split_rows(nq: int, n: int, tile: int, m: int, c: int, kp: int,
               sms: int) -> Tuple[int, int]:
    """(row ranges, rows a range) of the flat scan: enough ranges that
    (query tiles) x ranges fill every SM with as many blocks as its shared
    memory holds, a range a multiple of `ROWS` and at least 1,024 rows."""
    per_sm = max(1, min(2048 // (ROWS * max(1, tile // 4)),
                        SMEM_PER_SM // (tile_smem_bytes(tile, m, c, kp)
                                        + 1024)))
    q_tiles = -(-nq // tile)
    want = max(1, -(-per_sm * sms // q_tiles))
    rows_per = max(4 * ROWS, -(-n // want))
    rows_per = -(-rows_per // ROWS) * ROWS
    return max(1, -(-n // rows_per)), rows_per


@functools.lru_cache(maxsize=256)
def _plan(nq: int, n: int, m: int, c: int, k: int, sms: int,
          tile: Optional[int]) -> Tuple[int, int, int, int]:
    """(tile, row ranges, rows a range, kp) of a flat-scan call."""
    if tile is None:
        tile = tile_size(nq, m, c, k)
    elif tile not in TILES:
        raise ValueError(f"tile={tile} not one of {TILES}")
    n_split, rows_per = split_rows(nq, n, tile, m, c, k, sms)
    kp = min(k, rows_per)
    if tile_smem_bytes(tile, m, c, kp) > SMEM_LIMIT:
        raise ValueError(f"tile={tile} needs {tile_smem_bytes(tile, m, c, kp)}"
                         f" bytes of shared memory, more than {SMEM_LIMIT}")
    return tile, n_split, rows_per, kp


def pq_scan_tile_plain(lut: Array, codes: Array, ids: Array, *, k: int,
                       tile: int = 8) -> Tuple[Array, Array]:
    """The flat kernel's arithmetic in plain PyTorch: the tables of each
    tile of ``tile`` queries laid out ``[m][code][t]``, every row looked up
    once for the whole tile (``table[m, code[m], :]``), summed over m in
    order; the tile's padding queries score nothing.  Scores are the
    plain version's bits; the selection is the plain version's."""
    nq, m, c = lut.shape
    lut = lut.to(torch.float32)
    idx = codes.long()
    s = []
    for q0 in range(0, nq, tile):
        tab = lut.new_zeros((m, c, tile))
        real = min(tile, nq - q0)
        tab[:, :, :real] = lut[q0:q0 + real].permute(1, 2, 0)
        acc = tab[0][idx[:, 0]]                           # (N, tile)
        for j in range(1, m):
            acc = acc + tab[j][idx[:, j]]
        s.append(acc[:, :real].T)
    s = torch.cat(s).masked_fill(ids[None, :] < 0, float("inf"))
    return _topk_of(s, ids[None, :].expand(nq, -1), k)


def pq_scan_topk(
    lut: Array, codes: Array, ids: Array, *, k: int,
    tile: Optional[int] = None,
) -> Tuple[Array, Array]:
    """Flat ADC scan: score every coded row, keep the best k per query.

    Args:
      lut:   (Q, M, C) per-query ADC tables (`repro_torch.core.pq.pq_lut`).
      codes: (N, M) uint8 PQ codes.
      ids:   (N,) int32 ids with every unreturnable row already masked to
             -1 (tombstones, rows past the coded prefix); live rows carry
             their own index.
      k:     neighbours kept (k may exceed N).
      tile:  queries a block serves (`tile_size` when None); the result
             does not depend on it.

    Returns:
      ((Q, k) float32 ADC scores ascending, +inf at empty slots; (Q, k)
      int32 ids, -1 at empty slots).  Equal scores keep the lower row.
    """
    if _build.off_card(lut):
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
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sms.get(idx)
    if sms is None:
        sms = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    tile, n_split, rows_per, kp = _plan(nq, n, m, c, k, sms, tile)
    part = torch.empty((nq, n_split, kp), dtype=torch.int64, device=dev)
    lib, flat, _ = _kernel()
    err = flat(lut.data_ptr(), codes.data_ptr(), ids.data_ptr(),
               part.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
               nq, n, m, c, n_split, rows_per, k, kp, tile,
               torch._C._cuda_getCurrentRawStream(idx))
    _build.check(lib, err, "pq_scan_topk")
    flat_launches += 1
    launches_by_kernel[f"tile_{tile}"] += 1
    return out_s, out_i


def pq_ivf_scan_topk(
    q: Array, probe: Array, member_ids: Array, pack: Dict, *, k: int,
    lut: Optional[Array] = None, valid: Optional[Array] = None,
    cluster: Optional[int] = None,
) -> Tuple[Array, Array]:
    """IVF-PQ stage 0: the ADC scan over each query's probed list slabs.

    Args:
      q:          (Q, D) queries (only ``[:, :pack['dim']]`` feeds the LUT;
                  ignored when ``lut`` is given).
      probe:      (Q, n_probe) int32 probed list indices (distinct per row).
      member_ids: (n_lists, width <= max_len) int32 global ids, -1 at list
                  padding; with ``valid=None`` every tombstoned slot must
                  already be -1 too.
      pack:       `pack_ivf_lists(..., dtype='pq')` output.
      k:          neighbours kept (k may exceed the rows scanned).
      lut:        optional precomputed (Q, M, C) ADC tables.
      valid:      optional (N,) bool row-liveness bits over the ids, read
                  by the kernel (the plain version masks the table first).
      cluster:    CTAs a query (1..8; the launcher's choice when None); the
                  result does not depend on it.

    Returns:
      ((Q, k) float32 ADC scores ascending, +inf empties; (Q, k) int32
      global doc ids, -1 empties).  Equal scores keep the earlier scan
      position (probe rank, then slot).
    """
    if _build.off_card(q):
        return pq_ivf_scan_topk_plain(q, probe, member_ids, pack, k=k,
                                      lut=lut, valid=valid)
    global ivf_launches
    lut = _lut(q, pack, lut)
    lib, _, fn = _kernel()
    out = _ivf.list_scan(lib, fn, "pq", q=None, lut=lut, probe=probe,
                         lists=member_ids, pack=pack, valid=valid, k=k,
                         cluster=cluster, what="pq_ivf_scan_topk")
    if out[0].shape[0]:
        ivf_launches += 1
        launches_by_kernel["list"] += 1
    return out


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
