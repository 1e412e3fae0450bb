"""GQA attention: the port of ``src/repro/layers/attention.py``.

``mha_forward`` (training-free prefill) and ``mha_decode`` run their
attention through ``ops.flash_attention``: the hand-written CUDA kernel on
the card, its plain version on the CPU.  That kernel is what the JAX
package's ``chunked_attention`` stood in for, so ``chunked_attention`` has
no counterpart here; ``impl="chunked"`` names the kernel route as it named
the stand-in.  ``dense_attention`` and ``decode_attention`` are the JAX
package's plain references, ported as they are (``impl="dense"``).

Decode writes the step's key and value into the preallocated cache in
place and attends over the cache prefix ``[:pos + 1]`` — a strided view,
never copied; with the kernel's end alignment that is exactly
``decode_attention``'s mask ``k_pos <= pos``.  Sliding windows (Gemma3's
local layers) pass ``window`` to the kernel, whose mask ``k_pos > q_pos -
window`` is ``_mask``'s.  A ring cache (``ring=True``, a local layer's
window-sized cache) takes the step at slot ``pos % S`` and is attended
over its filled prefix ``[:pos + 1]`` until it wraps, then whole: the JAX
package's ``(k_pos <= pos) | (pos >= S)``.  Keys are rotated when they are
written, so the order of the slots does not matter to the softmax.  The
JAX package's sharding hooks (``constrain``) have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.layers.common import dense_init
from repro_torch.layers.rope import apply_rope

Tensor = torch.Tensor

_NEG_INF = -1e30


# ---------------------------------------------------------------- params --

class Attention(nn.Module):
    """q/k/v/o projections, weights (d_in, d_out) as in the JAX package."""

    def __init__(self, wq: Tensor, wk: Tensor, wv: Tensor, wo: Tensor):
        super().__init__()
        self.wq = nn.Parameter(wq, requires_grad=False)
        self.wk = nn.Parameter(wk, requires_grad=False)
        self.wv = nn.Parameter(wv, requires_grad=False)
        self.wo = nn.Parameter(wo, requires_grad=False)


def attn_init(generator: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, d_head: int, dtype, *, device=None) -> Attention:
    return Attention(
        dense_init(generator, d_model, n_heads * d_head, dtype, device=device),
        dense_init(generator, d_model, n_kv_heads * d_head, dtype,
                   device=device),
        dense_init(generator, d_model, n_kv_heads * d_head, dtype,
                   device=device),
        dense_init(generator, n_heads * d_head, d_model, dtype, device=device,
                   scale=(n_heads * d_head) ** -0.5))


def attn_specs():
    """Logical axes of the attention weights (the JAX package's)."""
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}


# ------------------------------------------------------------ mask math --

def _mask(q_pos: Tensor, k_pos: Tensor, window: int, causal: bool) -> Tensor:
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                   dtype=torch.bool, device=k_pos.device)
    if causal:
        m &= k_pos <= q_pos
    if window > 0:                                  # 0 disables
        m &= k_pos > q_pos - window
    return m


# --------------------------------------------------------------- dense ---

def dense_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                    window: int, q_offset: int = 0) -> Tensor:
    """Reference attention; q (B,H,Sq,Dh), k/v (B,Hkv,Skv,Dh)."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * dh ** -0.5
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq) + q_offset
    k_pos = torch.arange(skv, device=q.device)[None, :]
    m = _mask(q_pos, k_pos, window, causal)
    s = torch.where(m, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


# --------------------------------------------------------------- decode --

def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, *, pos: int,
                     window: int, ring: bool = False) -> Tensor:
    """Single-token decode: q (B,H,1,Dh) vs cache (B,Hkv,S,Dh).

    Cache entries at positions > ``pos`` are masked.  ``ring=True`` treats
    the cache as a circular buffer of the last S tokens (only the
    unfilled-prefix mask applies).
    """
    b, h, _, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    qg = q.reshape(b, hkv, rep, dh).to(torch.float32)
    logits = torch.einsum("bgrd,bgsd->bgrs", qg,
                          k_cache.to(torch.float32)) * dh ** -0.5
    k_pos = torch.arange(s, device=q.device)
    if ring:
        msk = (k_pos <= pos) | (pos >= s)
    else:
        msk = k_pos <= pos
        if window > 0:
            msk &= k_pos > pos - window
    logits = torch.where(msk, logits, torch.full_like(logits, _NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, h, 1, dh).to(q.dtype)


# ------------------------------------------------------------- wiring ----

def mha_forward(
    p: Attention, x: Tensor, *, n_heads: int, n_kv_heads: int, d_head: int,
    causal: bool = True, window: int = 0, rope_theta: float = 10000.0,
    positions: Optional[Tensor] = None, impl: str = "chunked",
    return_kv: bool = False,
):
    """Full-sequence attention block (prefill).

    x: (B, S, D).  Returns (B, S, D) and, with ``return_kv``, the rotated
    (k, v) as (B, Hkv, S, Dh) for the cache.  ``impl="chunked"`` runs the
    flash kernel (plain version on the CPU), ``"dense"`` the reference.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = (x @ p.wq).reshape(b, s, n_heads, d_head)
    k = (x @ p.wk).reshape(b, s, n_kv_heads, d_head)
    v = (x @ p.wv).reshape(b, s, n_kv_heads, d_head)
    q = apply_rope(q.transpose(1, 2), positions, rope_theta)
    k = apply_rope(k.transpose(1, 2), positions, rope_theta)
    v = v.transpose(1, 2)
    if impl == "dense":
        o = dense_attention(q, k, v, causal=causal, window=window)
    elif impl == "chunked":
        o = ops.flash_attention(q, k, v, causal=causal,
                                window=window if window > 0 else None)
    else:
        raise ValueError(f"impl={impl!r}: expected 'chunked' or 'dense'")
    o = o.transpose(1, 2).reshape(b, s, n_heads * d_head)
    out = o @ p.wo
    if return_kv:
        return out, (k, v)
    return out


def mha_decode(
    p: Attention, x: Tensor, k_cache: Tensor, v_cache: Tensor, *, pos: int,
    n_heads: int, n_kv_heads: int, d_head: int, window: int = 0,
    rope_theta: float = 10000.0, ring: bool = False, impl: str = "chunked",
    positions: Optional[Tensor] = None,
):
    """One-token decode step.  x: (B, 1, D); caches (B, Hkv, S, Dh).

    The new key and value are written into the caches in place at ``pos``
    (``ring=True``: at ``pos % S``, the cache holding only the last S
    tokens of a sliding-window layer).  ``positions`` is ``pos`` as a (1,)
    tensor on x's device for RoPE (built here unless given: a decode step
    builds it once for all its layers).  Returns (out (B, 1, D), k_cache,
    v_cache).
    """
    b = x.shape[0]
    q = (x @ p.wq).reshape(b, 1, n_heads, d_head).transpose(1, 2)
    k = (x @ p.wk).reshape(b, 1, n_kv_heads, d_head).transpose(1, 2)
    v = (x @ p.wv).reshape(b, 1, n_kv_heads, d_head).transpose(1, 2)
    if positions is None:
        positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    slot = pos % k_cache.shape[2] if ring else pos
    k_cache[:, :, slot] = k[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, slot] = v[:, :, 0].to(v_cache.dtype)
    if impl == "dense":
        o = decode_attention(q, k_cache, v_cache, pos=pos,
                             window=0 if ring else window, ring=ring)
    elif impl == "chunked":
        # the filled prefix; once a ring has wrapped the slice is all of it,
        # and the ring is the window
        n = pos + 1
        o = ops.flash_attention(
            q, k_cache[:, :, :n], v_cache[:, :, :n], causal=True,
            window=window if window > 0 and not ring else None)
    else:
        raise ValueError(f"impl={impl!r}: expected 'chunked' or 'dense'")
    o = o.transpose(1, 2).reshape(b, 1, n_heads * d_head)
    return o @ p.wo, k_cache, v_cache
