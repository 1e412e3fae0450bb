"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the port of
``src/repro/layers/mla.py``.

Keys and values come from a shared low-rank latent ``c_kv`` (rank
``kv_lora_rank``) plus a small decoupled-RoPE key shared across heads.
Decode caches only (c_kv, k_rope) and runs the absorbed form: the per-head
up-projections W_uk / W_uv fold into the query and output so attention
runs in the latent space,

    score_h ∝ (W_uk_hᵀ q_nope_h) · c_kv  +  q_rope_h · k_rope
    out_h    = W_uv_h (softmax · c_kv)

as plain products, which is where the JAX package computes it too (outside
any Pallas kernel).  Prefill materialises per-head k and v and runs them
through ``ops.flash_attention``, the kernel the JAX package's
``chunked_attention`` stood in for.  The kernel takes one head dim for q,
k and v, one of ``HEAD_DIMS``; MLA's q and k have ``d_nope + d_rope`` (192
at full width) and v ``d_v`` (128), so all three are zero-padded to the
least head dim that holds both (256) and the output cut back to ``d_v``.
A zero column adds nothing to a dot product, and the scale is given
explicitly: ``(d_nope + d_rope) ** -0.5``, as DeepSeek scales.  On the
card the padded bf16 call takes the tensor-core prefill
(``prefill_wgmma`` at head dim 256; float32 takes ``fma``) and, under
autograd, the tensor-core backward (``bwd_wgmma`` at head dim 256;
float32 takes ``bwd_fma``), whose gradients of the zero columns are 0
(dO's padded columns are 0, as the output is cut).  Both read and
multiply the zero columns too: 1.07 GB moved a full-width layer's
forward where the unpadded tensors hold 0.67.

Both norms use ``rmsnorm``'s default eps (1e-6), not the config's
``norm_eps``, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.layers.attention import dense_attention
from repro_torch.layers.common import dense_init, rmsnorm
from repro_torch.layers.rope import apply_rope

Tensor = torch.Tensor

_NEG_INF = -1e30


class MLA(nn.Module):
    """MLA projections, weights (d_in, d_out) as in the JAX package: either
    ``wq_a`` / ``q_norm`` / ``wq_b`` (a low-rank q) or ``wq``; then
    ``wkv_a``, ``kv_norm``, ``wkv_b`` and ``wo``.  Norm gains are float32."""

    def __init__(self, *, wkv_a: Tensor, kv_norm: Tensor, wkv_b: Tensor,
                 wo: Tensor, wq: Optional[Tensor] = None,
                 wq_a: Optional[Tensor] = None,
                 q_norm: Optional[Tensor] = None,
                 wq_b: Optional[Tensor] = None):
        super().__init__()

        def param(w):
            return None if w is None else nn.Parameter(w, requires_grad=False)

        self.wq, self.wq_a, self.q_norm, self.wq_b = (
            param(wq), param(wq_a), param(q_norm), param(wq_b))
        self.wkv_a, self.kv_norm = param(wkv_a), param(kv_norm)
        self.wkv_b, self.wo = param(wkv_b), param(wo)


def mla_init(generator: torch.Generator, d_model: int, n_heads: int,
             cfg: MLAConfig, dtype, *, device=None) -> MLA:
    h, dqk = n_heads, cfg.d_nope + cfg.d_rope

    def dense(d_in, d_out, **kw):
        return dense_init(generator, d_in, d_out, dtype, device=device, **kw)

    q = ({"wq_a": dense(d_model, cfg.q_lora_rank),
          "q_norm": torch.zeros((cfg.q_lora_rank,), dtype=torch.float32,
                                device=device),
          "wq_b": dense(cfg.q_lora_rank, h * dqk)}
         if cfg.q_lora_rank else {"wq": dense(d_model, h * dqk)})
    return MLA(wkv_a=dense(d_model, cfg.kv_lora_rank + cfg.d_rope),
               kv_norm=torch.zeros((cfg.kv_lora_rank,), dtype=torch.float32,
                                   device=device),
               wkv_b=dense(cfg.kv_lora_rank, h * (cfg.d_nope + cfg.d_v)),
               wo=dense(h * cfg.d_v, d_model, scale=(h * cfg.d_v) ** -0.5),
               **q)


def mla_specs(cfg: MLAConfig):
    """Logical axes of the MLA weights (the JAX package's)."""
    p = ({"wq_a": ("embed", None), "q_norm": (None,), "wq_b": (None, "heads")}
         if cfg.q_lora_rank else {"wq": ("embed", "heads")})
    p.update({"wkv_a": ("embed", None), "kv_norm": (None,),
              "wkv_b": (None, "heads"), "wo": ("heads", "embed")})
    return p


def _project_q(p: MLA, x: Tensor, n_heads: int, cfg: MLAConfig):
    b, s, _ = x.shape
    if cfg.q_lora_rank:
        q = rmsnorm(x @ p.wq_a, p.q_norm) @ p.wq_b
    else:
        q = x @ p.wq
    q = q.reshape(b, s, n_heads, cfg.d_nope + cfg.d_rope).transpose(1, 2)
    return q[..., :cfg.d_nope], q[..., cfg.d_nope:]        # nope, rope parts


def _latent(p: MLA, x: Tensor, positions: Tensor, cfg: MLAConfig,
            rope_theta: float) -> Tuple[Tensor, Tensor]:
    """(c_kv (B, S, rank), k_rope (B, S, d_rope)): what decode caches."""
    kv_a = x @ p.wkv_a                                      # (B,S,rank+d_rope)
    c_kv = rmsnorm(kv_a[..., :cfg.kv_lora_rank], p.kv_norm)
    k_rope = apply_rope(kv_a[:, None, :, cfg.kv_lora_rank:], positions,
                        rope_theta)[:, 0]
    return c_kv, k_rope


def padded_head_dim(cfg: MLAConfig) -> int:
    """The flash kernel's head dim that prefill pads q, k and v to."""
    need = max(cfg.d_nope + cfg.d_rope, cfg.d_v)
    fits = [dh for dh in HEAD_DIMS if dh >= need]
    if not fits:
        raise ValueError(f"MLA head dims {cfg.d_nope} + {cfg.d_rope} / "
                         f"{cfg.d_v} exceed the flash kernel's {HEAD_DIMS}")
    return fits[0]


def mla_forward(p: MLA, x: Tensor, *, n_heads: int, cfg: MLAConfig,
                rope_theta: float = 10000.0,
                positions: Optional[Tensor] = None, impl: str = "chunked",
                return_cache: bool = False):
    """Prefill MLA.  x: (B, S, D) -> (B, S, D) and, with ``return_cache``,
    the (c_kv, k_rope) decode caches, (B, S, rank) and (B, S, d_rope)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _project_q(p, x, n_heads, cfg)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv, k_rope = _latent(p, x, positions, cfg, rope_theta)

    kv = (c_kv @ p.wkv_b).reshape(b, s, n_heads, cfg.d_nope + cfg.d_v)
    kv = kv.transpose(1, 2)
    k_nope, v = kv[..., :cfg.d_nope], kv[..., cfg.d_nope:]
    k_rope_b = k_rope[:, None].expand(b, n_heads, s, cfg.d_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    if impl == "dense":
        o = dense_attention(q, k, v, causal=True, window=0)
    elif impl == "chunked":
        dqk, dh = q.shape[-1], padded_head_dim(cfg)
        o = ops.flash_attention(
            F.pad(q, (0, dh - dqk)), F.pad(k, (0, dh - dqk)),
            F.pad(v, (0, dh - cfg.d_v)), causal=True,
            scale=dqk ** -0.5)[..., :cfg.d_v]
    else:
        raise ValueError(f"impl={impl!r}: expected 'chunked' or 'dense'")
    o = o.transpose(1, 2).reshape(b, s, n_heads * cfg.d_v)
    out = o @ p.wo
    if return_cache:
        return out, (c_kv, k_rope)
    return out


def mla_decode(p: MLA, x: Tensor, ckv_cache: Tensor, krope_cache: Tensor, *,
               pos: int, n_heads: int, cfg: MLAConfig,
               rope_theta: float = 10000.0,
               positions: Optional[Tensor] = None):
    """Absorbed-matmul decode.  x: (B, 1, D).

    ckv_cache (B, S, kv_lora_rank) and krope_cache (B, S, d_rope) take the
    step's entries in place at ``pos``; attention runs over the prefix
    ``[:pos + 1]`` (the JAX package masks ``k_pos <= pos``: the same
    weights).  ``positions`` is ``pos`` as a (1,) tensor for RoPE.
    Returns (out (B, 1, D), ckv_cache, krope_cache).
    """
    b = x.shape[0]
    rank = cfg.kv_lora_rank
    if positions is None:
        positions = torch.full((1,), pos, dtype=torch.long, device=x.device)

    q_nope, q_rope = _project_q(p, x, n_heads, cfg)          # (B,H,1,*)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv, k_rope = _latent(p, x, positions, cfg, rope_theta)
    ckv_cache[:, pos] = c_kv[:, 0].to(ckv_cache.dtype)
    krope_cache[:, pos] = k_rope[:, 0].to(krope_cache.dtype)
    ckv, krope = ckv_cache[:, :pos + 1], krope_cache[:, :pos + 1]

    # absorb W_uk into q:  q_lat[b,h,r] = sum_n q_nope[b,h,n] * W_uk[r,h,n]
    wkv_b = p.wkv_b.reshape(rank, n_heads, cfg.d_nope + cfg.d_v)
    w_uk, w_uv = wkv_b[..., :cfg.d_nope], wkv_b[..., cfg.d_nope:]
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, :, 0], w_uk)

    # float32 scores of the compute-dtype operands, as the JAX package's
    # preferred_element_type=float32 asks
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, :, 0].float(),
                          krope.float())
    logits = (s_lat + s_rope) * (cfg.d_nope + cfg.d_rope) ** -0.5
    attn = torch.softmax(logits, dim=-1)

    o_lat = torch.einsum("bhs,bsr->bhr", attn.to(ckv.dtype).float(),
                         ckv.float())                        # (B,H,rank)
    o = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), w_uv)
    o = o.reshape(b, 1, n_heads * cfg.d_v)
    return o @ p.wo, ckv_cache, krope_cache
