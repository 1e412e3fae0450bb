"""Fused online-softmax attention: wrapper for the CUDA kernel.

Replaces the TPU kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flash_attention.py:108``, body ``_kernel`` ``:38``,
``pallas_call`` ``:154``): attention over (B, Hq, Sq, Dh) queries and
(B, Hkv, Skv, Dh) keys and values, causal and sliding-window masks aligned
to the end of kv, so one kernel serves prefill (Sq == Skv) and decode
(Sq << Skv).  The kernel (``csrc/flash_attention.cu``) maps q head h to kv
head ``h // (Hq / Hkv)`` instead of repeating kv heads, and takes K and V
by strides, so the decode cache prefix ``k_cache[:, :, :pos + 1]`` is read
in place.

Bound on an H100 SXM at Mistral-Nemo-12B's serving shapes (bf16, batch 8,
32 / 8 heads, d_head 128): prefill over 512 tokens moves 84 MB — 25 us of
bytes, above its 17 us of tensor-core work; decode reads an 18 MB cache
prefix, 5.3 us.  The first kernel computes in float32 FMA from shared
memory (see the source for its design and limits).

On a CPU tensor the wrapper runs the plain version
(`flash_attention_plain`, ``ref.flash_attention_ref``); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

Tensor = torch.Tensor

#: Head dims the kernel is built for.
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Largest q heads per kv head (a block holds 64 (position, head) rows).
MAX_GROUP = 64

#: Calls that launched the kernel on the card.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3 + [ctypes.c_float]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = False, window: Optional[int] = None,
                          scale: Optional[float] = None) -> Tensor:
    """The kernel's function in plain PyTorch (any device)."""
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)


def _check(q, k, v):
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must share one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
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
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on the head dim")


def _aligned(t: Tensor) -> bool:
    """16-byte loads are safe: base and every row start 16-byte aligned."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0 for s in t.stride()[:3])


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> Tensor:
    """Fused attention.  q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh).

    Args:
      causal: keep keys at or before each query's position, queries aligned
              to the end of kv (row i at position ``i + Skv - Sq``).
      window: keep only the last ``window`` positions (None: no window).
      scale:  score scale, ``Dh ** -0.5`` unless given.

    Returns (B, Hq, Sq, Dh) contiguous, in q's dtype; a row with nothing to
    attend is 0.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    global launches
    _check(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, sq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lib, fn = _kernel()
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (q, k, v)]
    vec = all(_aligned(t) for t in (q, k, v))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, hq, hkv, sq, skv, dh, *strides, float(scale), int(causal),
             int(window is not None), 0 if window is None else int(window),
             int(q.dtype == torch.bfloat16), int(vec),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    launches += 1
    return out
