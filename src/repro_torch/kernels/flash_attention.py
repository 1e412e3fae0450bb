"""Fused online-softmax attention: wrapper for the CUDA kernels.

Replaces the TPU kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flash_attention.py:108``, body ``_kernel`` ``:38``,
``pallas_call`` ``:154``): attention over (B, Hq, Sq, Dh) queries and
(B, Hkv, Skv, Dh) keys and values, causal and sliding-window masks aligned
to the end of kv, so one function serves prefill (Sq == Skv) and decode
(Sq << Skv).  The kernels (``csrc/flash_attention.cu``) map q head h to kv
head ``h // (Hq / Hkv)`` instead of repeating kv heads, and take K and V
by strides, so the decode cache prefix ``k_cache[:, :, :pos + 1]`` and
prefill's transposed ``v`` are read in place.

Three kernels, chosen by dtype and shape alone (`route`):

- ``prefill_wgmma``: bf16, head dim 64, 128 or 256, more than one 64-row
  tile — TMA loads and ``wgmma`` tensor-core products, warp-specialised;
  its tiles by head dim are `prefill_plan`'s (64-key K / V tiles and one
  Q stage at 256, where 128-key tiles overflow shared memory and
  registers).
- ``decode_splitkv``: every call whose Sq * (Hq / Hkv) rows fit one 64-row
  tile (each decode step), bf16 or float32 — the key range split over
  blocks, partials merged in the same launch by the last block of each
  (batch, kv head).
- ``fma``: everything else (float32 prefill, head dims 16 / 32, a call
  with no keys) — float32 FMA from shared memory.

By dtype and head dim, a call of more than one 64-row tile takes:

=============  ==================  ========
head dim       bf16                float32
=============  ==================  ========
16, 32         ``fma``             ``fma``
64, 128, 256   ``prefill_wgmma``   ``fma``
=============  ==================  ========

Bound on an H100 SXM at Mistral-Nemo-12B's serving shapes (bf16, batch 8,
32 / 8 heads, d_head 128): prefill over 512 tokens moves 84 MB — 25 us of
bytes, above its 17 us of tensor-core work; decode reads an 18 MB cache
prefix, 5.3 us (see the source for each kernel's design).

On a CPU tensor the wrapper runs the plain version
(`flash_attention_plain`, ``ref.flash_attention_ref``); on a CUDA tensor it
launches a kernel or raises.  `decode_partials_plain` and
`combine_partials` spell out the split-kv kernel's arithmetic in plain
PyTorch for the tests.

Asked with ``return_lse=True``, every kernel also writes each row's
log-sum-exp (float32 (B, Hq, Sq), natural units with the scale folded in,
-inf on a row with no kept key); only `FlashAttentionFn` asks, so the
serving paths keep their arithmetic and their launches.

The backward (`flash_attention_backward`) has no Pallas counterpart: the
JAX package trains through XLA's ``chunked_attention``.  It reads the
forward's log-sum-exp and never recomputes it.  Two routes, chosen by dtype
and head dim alone (`backward_route`), each two launches (dQ with ``D =
rowsum(P o dP)``, then dK and dV with the GQA sum inside the block):

- ``bwd_wgmma`` (``csrc/flash_attention_bwd_wgmma.cu``): bf16 at head dim
  64, 128 or 256 — TMA and bf16 ``wgmma`` products with float32
  accumulation, D summed in float32 before dS is formed and rounded; its
  tiles by head dim are `backward_plan`'s (at 256 the dK / dV launch's two
  warpgroups split each step by role, one summing dV and the other dK,
  as one warpgroup cannot hold both).
- ``bwd_fma`` (``csrc/flash_attention_bwd.cu``): head dims 16 and 32, and
  float32 at every head dim — float32 FMA from shared memory.

By dtype and head dim the backward takes:

=============  ==============  ========
head dim       bf16            float32
=============  ==============  ========
16, 32         ``bwd_fma``     ``bwd_fma``
64, 128, 256   ``bwd_wgmma``   ``bwd_fma``
=============  ==============  ========

`FlashAttentionFn` puts the forward kernel and this backward behind
autograd; ``ops.flash_attention`` takes it only when gradients are asked
for.  `flash_attention_backward_plain` spells out the function.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

Tensor = torch.Tensor

#: Head dims the kernels are built for.
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Head dims of the tensor-core prefill kernel (bf16).
WGMMA_HEAD_DIMS = (64, 128, 256)
#: Head dims of the tensor-core backward (bf16; `backward_route`).
BWD_WGMMA_HEAD_DIMS = (64, 128, 256)
#: The tensor-core backward's plan by head dim, as ``BWD_PLAN`` in
#: ``csrc/flash_attention_bwd_wgmma.cu``: (dK / dV by role, Q / dO slots of
#: the dK / dV launch, largest cluster of its CTAs, block order).
BACKWARD_PLANS = {64: (0, 4, 2, 0), 128: (0, 4, 2, 0), 256: (1, 2, 1, 1)}
#: Rows (q rows or keys) of the tensor-core backward's tiles.
BACKWARD_ROWS = 64
#: The tensor-core prefill's tiles by head dim, as ``PF_PLAN`` in
#: ``csrc/flash_attention.cu``: (keys of a K / V tile, Q stages, K stages,
#: V stages).
PREFILL_PLANS = {64: (128, 2, 2, 2), 128: (128, 2, 2, 2), 256: (64, 1, 2, 2)}
#: Rows of the tensor-core prefill's q tile, and the dynamic shared memory
#: a block may have on the H100.
PREFILL_ROWS = 128
SMEM_MAX = 232_448
#: Largest q heads per kv head (a block holds 64 (position, head) rows).
MAX_GROUP = 64
#: Rows of one tile of the decode and FMA kernels.
ROW_TILE = 64
#: Keys of a decode split at the least, and the blocks a decode launch aims
#: at (four per SM on the H100's 132).
SPLIT_KEYS = 64
TARGET_BLOCKS = 4 * 132
#: Value of the running max where nothing has been kept.
MASKED = -1e30

#: Calls that launched a kernel on the card, in all and by kernel.
launches = 0
launches_by_kernel: Dict[str, int] = {"prefill_wgmma": 0,
                                      "decode_splitkv": 0, "fma": 0}

#: Backward calls that launched the backward kernels on the card (two
#: launches a call: dQ and D, then dK and dV), in all and by route.
bwd_launches = 0
bwd_launches_by_kernel: Dict[str, int] = {"bwd_wgmma": 0, "bwd_fma": 0}

_KIND = {"fma": 0, "decode_splitkv": 1, "prefill_wgmma": 2}
# FlashArgs of csrc/flash_attention.cu: q, k, v, o, part, counters, lse,
# stream; the nine strides; b, hq, hkv, sq, skv, dh, causal, has_window,
# window, n_split, split_keys, is_bf16, vec; scale
_ARGS = struct.Struct("@8Q9q13if")
# BwdArgs of csrc/flash_attention_bwd.cuh: q, k, v, dout, dq, dk, dv, lse,
# delta, stream; the strides of q, k, v and dout (batch, head, position);
# b, hq, hkv, sq, skv, dh, causal, has_window, window, is_bf16; scale
_BWD_ARGS = struct.Struct("@10Q12q10id")
# the backward routes' libraries and C entries
_BWD_LIBS = {"bwd_fma": ("flash_attention_bwd", "flash_attention_backward"),
             "bwd_wgmma": ("flash_attention_bwd_wgmma",
                           "flash_attention_backward_wgmma")}
_lib = None
_fn = None
_bwd: Dict[str, tuple] = {}
_local = threading.local()        # a packing buffer for each thread
# per device: (int32 counters, all 0 between launches; float32 scratch)
_workspace: Dict[int, Tuple[Tensor, Tensor]] = {}


def _kernel():
    global _lib, _fn
    if _fn is None:
        lib = _build.library("flash_attention")
        size = lib.flash_attention_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != _ARGS.size:
            raise RuntimeError(f"flash_attention: the library's argument "
                               f"block is {size()} bytes, the wrapper packs "
                               f"{_ARGS.size}")
        fn = lib.flash_attention_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
        _lib, _fn = lib, fn
    return _fn


def _args_buffer():
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = ctypes.create_string_buffer(_ARGS.size)
        _local.addr = ctypes.addressof(buf)
    return buf, _local.addr


def route(dtype: torch.dtype, dh: int, sq: int, rep: int, skv: int) -> str:
    """The kernel a call goes to, from its dtype and shape alone."""
    if sq * rep <= ROW_TILE:
        return "decode_splitkv"
    if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS and skv > 0:
        return "prefill_wgmma"
    return "fma"


@functools.lru_cache(maxsize=1024)
def decode_splits(b: int, hkv: int, skv: int) -> Tuple[int, int]:
    """(splits, keys a split) of a decode launch over ``skv`` keys: runs of
    a multiple of `SPLIT_KEYS` keys, as few as give about `TARGET_BLOCKS`
    blocks over the b * hkv (batch, kv head) pairs; at least one split."""
    runs = max(1, math.ceil(skv / SPLIT_KEYS))
    per_pair = max(1, math.ceil(TARGET_BLOCKS / max(1, b * hkv)))
    split_keys = SPLIT_KEYS * math.ceil(runs / per_pair)
    return max(1, math.ceil(skv / split_keys)), split_keys


def prefill_plan(dh: int) -> Tuple[int, int, int, int, int, int]:
    """(rows, keys, q_stages, k_stages, v_stages, smem_bytes) of the
    tensor-core prefill at head dim ``dh``: 128 (position, head) rows a q
    tile, K / V tiles of ``keys`` keys, the rings' depths, and the dynamic
    shared memory a block asks for — 1,024 bytes of alignment, the rings
    (bf16 rows of ``dh``), the output's staging tile where it still fits
    `SMEM_MAX` (else the consumers store from registers), and two 8-byte
    barriers a ring slot and for the staging tile, as ``PfLayout`` in
    ``csrc/flash_attention.cu`` reckons it."""
    keys, q_st, k_st, v_st = PREFILL_PLANS[dh]
    q_tile = PREFILL_ROWS * 2 * dh
    rings = (1024 + q_st * q_tile + (k_st + v_st) * keys * 2 * dh
             + 8 * 2 * (q_st + k_st + v_st + 1))
    smem = rings + q_tile if rings + q_tile <= SMEM_MAX else rings
    return PREFILL_ROWS, keys, q_st, k_st, v_st, smem


def built_prefill_plan(dh: int) -> Tuple[int, int, int, int, int, int]:
    """`prefill_plan`'s six numbers as the built library reports them
    (``flash_prefill_plan``: the ``PfLayout`` it was compiled with); builds
    the library, so it needs the CUDA toolchain."""
    _kernel()
    fn = _lib.flash_prefill_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _build.check(_lib, fn(dh, out), f"flash_prefill_plan({dh})")
    return tuple(out)


def backward_plan(dh: int) -> Tuple[int, int, int, int, int, int, int]:
    """(rows, roles, ring, cluster, order, smem_dq, smem_kv) of the
    tensor-core backward at head dim ``dh``: 64-row tiles; whether the dK /
    dV launch's two warpgroups split each step by role (1: one sums dV, the
    other dK) or take their own steps, each holding both (0); the Q / dO
    slots of that launch's block; its largest cluster; the blocks' order
    (0: by tile over all heads and batches; 1: in rounds of (batch, kv
    head) groups, so that blocks running together share their reads in
    L2); and the dynamic shared memory of each launch — 1,024 bytes of
    alignment, the bf16 tiles (dQ: Q, dO, two K and two V slots; dK / dV:
    K, V and the ring of Q and dO), the float32 Pᵀ exchange by role, each
    warpgroup's 64 lse and 64 D rows, and the 8-byte barriers, as
    ``BwdLayout`` in ``csrc/flash_attention_bwd_wgmma.cu`` reckons it."""
    roles, ring, cluster, order = BACKWARD_PLANS[dh]
    rows = BACKWARD_ROWS
    tile = rows * 2 * dh
    smem_dq = 1024 + 6 * tile + 3 * 8
    smem_kv = (1024 + (2 + 2 * ring) * tile + (rows * rows * 4 if roles else 0)
               + 2 * 2 * rows * 4 + 8 * (1 + (2 if roles else 1) * ring))
    return rows, roles, ring, cluster, order, smem_dq, smem_kv


def built_backward_plan(dh: int) -> Tuple[int, int, int, int, int, int, int]:
    """`backward_plan`'s seven numbers as the built library reports them
    (``flash_bwd_plan``: the ``BwdLayout`` it was compiled with); builds
    the library, so it needs the CUDA toolchain."""
    lib, _ = _bwd_kernel("bwd_wgmma")
    fn = lib.flash_bwd_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    _build.check(lib, fn(dh, out), f"flash_bwd_plan({dh})")
    return tuple(out)


def backward_route(dtype: torch.dtype, dh: int) -> str:
    """The backward kernels a call goes to, from its dtype and head dim."""
    if dtype == torch.bfloat16 and dh in BWD_WGMMA_HEAD_DIMS:
        return "bwd_wgmma"
    return "bwd_fma"


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = False, window: Optional[int] = None,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """The kernels' function in plain PyTorch (any device); with
    ``return_lse``, (out, lse): each row's float32 log-sum-exp of its kept
    scores, as the kernels write it, -inf on a row with no kept key."""
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale, return_lse=return_lse)


def decode_partials_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = False, window: Optional[int] = None,
                          scale: Optional[float] = None,
                          split_keys: int = SPLIT_KEYS
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """The split-kv kernel's partials in plain PyTorch: for each split of
    ``split_keys`` keys, (m, l, acc) of shapes (n_split, B, Hq, Sq) and
    (n_split, B, Hq, Sq, Dh), float32.  m is the split's largest masked
    score (-1e30 where it keeps no key), l the sum of exp(s - m) over its
    kept keys, acc the product of those weights, rounded to v's dtype, with
    V.  A split with no kept key gives m = -1e30, l = 0, acc = 0."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    s = torch.where(keep, s, torch.full_like(s, MASKED))
    n_split = max(1, math.ceil(skv / split_keys))
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo, hi = i * split_keys, min(skv, (i + 1) * split_keys)
        si, ki = s[..., lo:hi], keep[:, lo:hi]
        m = torch.full(si.shape[:-1], MASKED, device=q.device)
        if hi > lo:
            m = torch.maximum(m, si.amax(dim=-1))
        p = torch.where(ki, torch.exp(si - m[..., None]), torch.zeros_like(si))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.matmul(p.to(v.dtype).float(), vf[:, :, lo:hi]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials(m: Tensor, l: Tensor, acc: Tensor,
                     dtype: torch.dtype) -> Tensor:
    """Merge split partials in split order, as the split-kv kernel's last
    block does: weights exp(m_s - max_s m_s), out = Σ w acc / max(Σ w l,
    1e-30) in ``dtype``; all-empty rows give 0."""
    mx = m.amax(dim=0)
    w = torch.exp(m - mx)
    l_all = torch.zeros_like(mx)
    out = torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        l_all = l_all + l[i] * w[i]
        out = out + acc[i] * w[i][..., None]
    return (out / torch.clamp(l_all, min=1e-30)[..., None]).to(dtype)


def _check(q, k, v, devices):
    dev, kd, vd = devices
    if dev.type != "cuda" or kd != dev or vd != dev:
        raise ValueError(f"q, k and v must share one CUDA device, got "
                         f"{dev}, {kd}, {vd}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"need q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hq, hkv, dh = q.shape[1], k.shape[1], q.shape[3]
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} q heads on {hkv} kv heads: need a multiple "
                         f"of at most {MAX_GROUP}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a unit stride on the head dim")


def _workspace_for(dev: torch.device, n_pairs: int, n_floats: int):
    """The device's (counters, scratch), grown to at least these sizes.
    The counters are zeroed once; each launch leaves them 0."""
    idx = dev.index
    ws = _workspace.get(idx)
    if ws is None or ws[0].numel() < n_pairs or ws[1].numel() < n_floats:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.zeros(max(n_pairs, old[0]), dtype=torch.int32,
                          device=dev),
              torch.empty(max(n_floats, old[1]), dtype=torch.float32,
                          device=dev))
        _workspace[idx] = ws
    return ws


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Fused attention.  q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh).

    Args:
      causal: keep keys at or before each query's position, queries aligned
              to the end of kv (row i at position ``i + Skv - Sq``).
      window: keep only the last ``window`` positions (None: no window).
      scale:  score scale, ``Dh ** -0.5`` unless given.
      return_lse: also return each row's log-sum-exp (the backward's input).

    Returns (B, Hq, Sq, Dh) contiguous, in q's dtype; a row with nothing to
    attend is 0.  With ``return_lse``, (out, lse): lse float32 (B, Hq, Sq),
    -inf on a row with no kept key.  The split-kv decode kernel keeps
    per-device scratch, so calls on one device are issued on one stream at
    a time.
    """
    devices = (q.device, k.device, v.device)
    if _build.off_card(*devices):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, return_lse=return_lse)
    global launches
    _check(q, k, v, devices)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dev = devices[0]
    out = torch.empty((b, hq, sq, dh), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        if lse is not None:
            return out, lse.fill_(float("-inf"))
        return out
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    rep = hq // hkv
    bf16 = q.dtype == torch.bfloat16
    kind = route(q.dtype, dh, sq, rep, skv)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    per = 8 if bf16 else 4                  # elements in 16 bytes
    # 16-byte loads (and TMA): every pointer and row start 16-byte aligned
    aligned = not (ptrs[0] | ptrs[1] | ptrs[2]) % 16 \
        and not any(st % per for st in strides)
    part = counters = 0
    n_split = split_keys = 0
    if kind == "decode_splitkv":
        n_split, split_keys = decode_splits(b, hkv, skv)
        ws = _workspace_for(dev, b * hkv, b * hkv * n_split * sq * rep
                            * (dh + 2))
        counters, part = ws[0].data_ptr(), ws[1].data_ptr()
    elif kind == "prefill_wgmma" and not aligned:
        raise ValueError("the bf16 prefill kernel needs q, k and v with "
                         "16-byte aligned pointers and strides")
    elif kind == "prefill_wgmma" and scale <= 0:
        raise ValueError(f"the bf16 prefill kernel needs a positive scale, "
                         f"got {scale}")
    fn = _kernel()
    buf, addr = _args_buffer()
    _ARGS.pack_into(buf, 0, *ptrs, out.data_ptr(), part, counters,
                    0 if lse is None else lse.data_ptr(),
                    torch._C._cuda_getCurrentRawStream(dev.index), *strides,
                    b, hq, hkv, sq, skv, dh, int(causal), window is not None,
                    0 if window is None else int(window), n_split, split_keys,
                    bf16, aligned, scale)
    _build.check(_lib, fn(addr, _KIND[kind]), f"flash_attention ({kind})")
    launches += 1
    launches_by_kernel[kind] += 1
    return out if lse is None else (out, lse)


# ---------------------------------------------------------------- backward --

def _bwd_kernel(kind: str):
    """(library, C entry) of backward route ``kind``, loaded at first use."""
    if kind not in _bwd:
        stem, entry = _BWD_LIBS[kind]
        lib = _build.library(stem)
        size = getattr(lib, entry + "_args_size")
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != _BWD_ARGS.size:
            raise RuntimeError(f"{stem}: the library's argument block is "
                               f"{size()} bytes, the wrapper packs "
                               f"{_BWD_ARGS.size}")
        fn = getattr(lib, entry + "_launch")
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        _bwd[kind] = (lib, fn)
    return _bwd[kind]


def flash_attention_backward_plain(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Optional[Tensor] = None,
    *, causal: bool = False, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward's function in plain PyTorch (any device).

    float32 throughout: s = scale q.k over the kept keys, lse its
    log-sum-exp (``lse`` as the forward wrote it, or computed here when
    None), P = exp(s - lse) (0 on masked keys and on rows with no kept
    key), dV = P^T dO, dP = dO V^T, D = rowsum(P o dP), dS = P o (dP - D),
    dQ = scale dS K, dK = scale dS^T Q; the q heads of a group summed into
    their kv head.  The derivative of the unrounded softmax.  Returns (dq,
    dk, dv) in the inputs' dtypes."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~keep, float("-inf"))
    lse = (torch.logsumexp(s, dim=-1) if lse is None
           else lse.float())[..., None]
    p = torch.where(keep & torch.isfinite(lse), torch.exp(s - lse),
                    torch.zeros_like(s))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale

    def group_sum(x):
        return x.reshape(b, hkv, rep, skv, dh).sum(dim=2)

    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def _tma_ready(x: Tensor) -> Tuple[Tensor, Tuple[int, int, int]]:
    """``x`` (or a contiguous copy where a pointer or stride is not 16-byte
    aligned, as TMA needs) and its (batch, head, position) element strides,
    a size-1 axis given the tensor's span (its stride is never used, and
    the span keeps the strides in order)."""
    def strides(t):
        span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        span = -(-span // 8) * 8
        return tuple(st if n > 1 else span
                     for n, st in zip(t.shape[:3], t.stride()[:3]))
    st = strides(x)
    if x.data_ptr() % 16 or any(v % 8 for v in st) or x.stride(3) != 1:
        x = x.clone(memory_format=torch.contiguous_format)
        st = strides(x)
    return x, st


def flash_attention_backward(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Optional[Tensor], *,
    causal: bool = False, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Gradients (dq, dk, dv) of `flash_attention` at (q, k, v), given the
    output's gradient ``do`` ((B, Hq, Sq, Dh) of q's dtype, unit stride on
    the head dim or copied to it) and the forward's ``lse`` (float32 (B,
    Hq, Sq), from ``flash_attention(..., return_lse=True)``).

    Covers what the forward covers: float32 and bf16, head dims
    `HEAD_DIMS`, groups up to `MAX_GROUP`, causal and windowed masks
    aligned to the end of kv, K and V by strides, any positive scale.
    Returns dq (B, Hq, Sq, Dh) and dk, dv (B, Hkv, Skv, Dh), contiguous, in
    the inputs' dtype.  CPU tensors go to `flash_attention_backward_plain`
    (``lse`` may be None there); on a CUDA tensor the kernels of
    `backward_route` launch or the call raises, and ``lse`` is required:
    no kernel recomputes it."""
    devices = (q.device, k.device, v.device)
    if _build.off_card(*devices, do):
        return flash_attention_backward_plain(q, k, v, do, lse, causal=causal,
                                              window=window, scale=scale)
    global bwd_launches
    _check(q, k, v, devices)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, got {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}")
    do = do if do.stride(3) == 1 else do.contiguous()
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dev = q.device
    if lse is None or lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != dev:
        got = None if lse is None else (tuple(lse.shape), lse.dtype,
                                        lse.device)
        raise ValueError(
            f"lse must be the forward's float32 {(b, hq, sq)} on {dev} "
            f"(flash_attention(..., return_lse=True)), got {got}")
    lse = lse.contiguous()
    dq = torch.empty((b, hq, sq, dh), dtype=q.dtype, device=dev)
    dk = torch.empty((b, hkv, skv, dh), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    kind = backward_route(q.dtype, dh)
    if kind == "bwd_wgmma":
        (q, st_q), (k, st_k), (v, st_v), (do, st_do) = (
            _tma_ready(x) for x in (q, k, v, do))
    else:
        st_q, st_k, st_v, st_do = (x.stride()[:3] for x in (q, k, v, do))
    delta = torch.empty(b * hq * sq, dtype=torch.float32, device=dev)
    lib, fn = _bwd_kernel(kind)
    buf = ctypes.create_string_buffer(_BWD_ARGS.size)
    _BWD_ARGS.pack_into(
        buf, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index),
        *st_q, *st_k, *st_v, *st_do, b, hq, hkv, sq, skv, dh, int(causal),
        window is not None, 0 if window is None else int(window),
        q.dtype == torch.bfloat16, float(scale))
    _build.check(lib, fn(ctypes.addressof(buf)),
                 f"flash_attention_backward ({kind})")
    bwd_launches += 1
    bwd_launches_by_kernel[kind] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` (the forward kernel, asked for its log-sum-exp)
    with `flash_attention_backward` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_backward(q, k, v, do, lse, causal=causal,
                                              window=window, scale=scale)
        return dq, dk, dv, None, None, None
