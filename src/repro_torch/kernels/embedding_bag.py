"""EmbeddingBag over stacked per-field tables: wrapper for the CUDA kernel.

Replaces the TPU kernel ``embedding_bag`` of the JAX package
(``src/repro/kernels/embedding_bag.py:79``, body ``_kernel`` ``:36``,
``pallas_call`` ``:108``): gather table rows per bag and reduce them by
``sum`` or ``mean`` in float32, -1 ids being padding.  The JAX package runs
it per (V, D) table; the kernel (``csrc/embedding_bag.cu``) takes every
field of a stacked (F, V, D) table with (B, F, L) ids in one launch and
writes (B, F, D) float32 — what ``models.recsys.embed_fields`` needs.

Bound on an H100 SXM: bytes (`bound_bytes`: the distinct rows the ids
touch read once, the ids, the float32 output written once).  At the
two-tower item build (4 fields x 1M bags, one 1 KiB row each) 8.2 GB,
2.45 ms at 3.35 TB/s.

On a CPU tensor the wrapper runs the plain version
(`embedding_bag_plain`, ``ref.embedding_bag_ref``); on a CUDA tensor it
launches the kernel or raises.  ``mode='max'`` has no kernel (as in the JAX
package, whose ``embedding_bag_op`` sends it to the reference).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import embedding_bag_ref

Tensor = torch.Tensor

#: Calls that launched the kernel on the card.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("embedding_bag")
        fn = lib.embedding_bag_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def embedding_bag_plain(tables: Tensor, ids: Tensor, *,
                        mode: str = "sum") -> Tensor:
    """The kernel's function in plain PyTorch (any device; also 'max')."""
    return embedding_bag_ref(tables, ids, mode=mode)


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
      no valid id gives 0.
    """
    if tables.device.type == "cpu" and ids.device.type == "cpu":
        return embedding_bag_plain(tables, ids, mode=mode)
    if tables.dim() == 2 and ids.dim() == 2:
        return embedding_bag(tables[None], ids[:, None], mode=mode)[:, 0]
    global launches
    _check(tables, ids, mode)
    b, f, bag_len = ids.shape
    _, v, d = tables.shape
    out = torch.empty((b, f, d), dtype=torch.float32, device=tables.device)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    per = 16 // tables.element_size()
    vec = (d % per == 0 and tables.stride(0) % per == 0
           and tables.stride(1) % per == 0 and tables.data_ptr() % 16 == 0)
    err = fn(tables.data_ptr(), ids.data_ptr(), out.data_ptr(), b * f, f,
             bag_len, v, d, tables.stride(0), tables.stride(1),
             int(mode == "mean"), int(tables.dtype == torch.bfloat16),
             int(vec), torch.cuda.current_stream(tables.device).cuda_stream)
    _build.check(lib, err, "embedding_bag")
    launches += 1
    return out
