"""Config-driven transformer LM for serving: the port of
``src/repro/models/lm.py`` — dense GQA, MoE (Qwen3 / DeepSeek), MLA and
Gemma-style local:global attention.

Entry points
  init_lm(cfg, seed=, device=)                  -> LM (random weights)
  load_jax_params(np_params, cfg, device)       -> LM (the JAX package's
                                                   ``init_lm`` pytree)
  lm_forward(lm, tokens)                        -> logits (B, S, V) f32
  prefill(lm, tokens, decode_len=)             -> (last logits, cache)
  init_cache(cfg, batch, seq)                   -> empty decode cache
  prefill_to_decode_cache(cfg, cache, s, total) -> the decode layout
  decode_step(lm, cache, tok, pos)              -> (logits (B, V) f32, cache)

The JAX package scans stacked layer weights; here the layers are
``ModuleList``s walked by a Python loop: ``dense_layers`` (DeepSeek's
``first_k_dense`` prefix, empty elsewhere), then ``layers``.  Caches keep
the JAX layouts and key names — ``{"k", "v"}`` of (L, B, Hkv, S, Dh);
``{"ckv", "krope"}`` of (L, B, S, ·) for MLA; for local:global configs
``{"k_local", "v_local"}`` ring caches of window width and ``{"k_global",
"v_global"}`` — and ``decode_step`` writes each step's entries into them in
place.  Attention runs through the flash kernel on the card
(``impl="chunked"``, the default) or the plain reference (``impl="dense"``);
MLA's absorbed decode and the MoE dispatch are plain products, as in the
JAX package.  ``lm_forward`` returns logits only: ``moe_apply``'s aux loss
belongs to the training loss, which is not ported (no ``lm_loss``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.layers import attention as A
from repro_torch.layers import mla as M
from repro_torch.layers import moe as E
from repro_torch.layers.common import (FFN, dense_init, dtype_of, embed_init,
                                       ffn_apply, ffn_init, rmsnorm)

Tensor = torch.Tensor
Cache = Dict[str, Tensor]


# ============================================================ modules ====

class Block(nn.Module):
    """One layer: norms, ``attn`` (``Attention`` or ``MLA``) and ``ffn`` or
    ``moe`` (the other is None)."""

    def __init__(self, ln1: Tensor, ln2: Tensor, attn: nn.Module,
                 ffn: Optional[FFN] = None, moe: Optional[E.MoE] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block holds exactly one of ffn and moe")
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.attn = attn
        self.ffn = ffn
        self.moe = moe


class LM(nn.Module):
    """Weights of an LM; ``cfg`` rides along."""

    def __init__(self, cfg: LMConfig, embed: Tensor, layers: List[Block],
                 final_ln: Tensor, lm_head: Optional[Tensor] = None,
                 dense_layers: Optional[List[Block]] = None):
        super().__init__()
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but "
                             f"lm_head is {'missing' if lm_head is None else 'given'}")
        dense_layers = list(dense_layers or [])
        if len(dense_layers) != _n_dense_prefix(cfg) \
                or len(dense_layers) + len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(dense_layers)} dense + "
                             f"{len(layers)} layers, config has "
                             f"{_n_dense_prefix(cfg)} + "
                             f"{cfg.n_layers - _n_dense_prefix(cfg)}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.dense_layers = nn.ModuleList(dense_layers)
        self.layers = nn.ModuleList(layers)
        self.final_ln = nn.Parameter(final_ln, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))

    @property
    def head(self) -> Tensor:
        """(D, V) output projection."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def blocks(self) -> List[Block]:
        """Every layer in order: the dense prefix, then ``layers``."""
        return list(self.dense_layers) + list(self.layers)


def _n_dense_prefix(cfg: LMConfig) -> int:
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


# ============================================================ init =======

def _block_init(gen: torch.Generator, cfg: LMConfig, dt, device, *,
                moe_layer: bool) -> Block:
    def zeros():
        return torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)

    if cfg.mla is not None:
        attn = M.mla_init(gen, cfg.d_model, cfg.n_heads, cfg.mla, dt,
                          device=device)
    else:
        attn = A.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, dt, device=device)
    if moe_layer:
        return Block(zeros(), zeros(), attn,
                     moe=E.moe_init(gen, cfg.d_model, cfg.moe, cfg.ffn_type,
                                    dt, device=device))
    return Block(zeros(), zeros(), attn,
                 ffn=ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_type, dt,
                              device=device))


@torch.no_grad()
def init_lm(cfg: LMConfig, *, seed: int = 0, device="cuda") -> LM:
    """Random weights from a seeded generator on ``device`` (the JAX
    package's truncated-normal fan-in init; other numbers than its
    ``jax.random`` draws)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    n_dense = _n_dense_prefix(cfg)
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dt, device=device)
    layers = [_block_init(gen, cfg, dt, device, moe_layer=cfg.moe is not None)
              for _ in range(cfg.n_layers - n_dense)]
    dense = [_block_init(gen, cfg, dt, device, moe_layer=False)
             for _ in range(n_dense)]
    head = (None if cfg.tie_embeddings
            else dense_init(gen, cfg.d_model, cfg.vocab, dt, device=device))
    return LM(cfg, embed, layers,
              torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
              head, dense)


def load_jax_params(np_params: Dict, cfg: LMConfig, device="cuda") -> LM:
    """The JAX package's ``init_lm`` pytree, as numpy arrays, as an ``LM``.

    The stacked (L, ...) leaves of ``np_params["layers"]`` (and of
    ``"dense_layers"``) are unstacked into one ``Block`` each.  Weights keep
    their (d_in, d_out) layout — the port computes ``x @ w`` as the JAX
    package does — and their dtype (``cfg.param_dtype``; the norm gains and
    the MoE router stay float32).  bfloat16 arrays go through float32,
    which holds them exactly.
    """
    dt = dtype_of(cfg.param_dtype)

    def t(a, dtype=dt):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=device, dtype=dtype)

    def f32(a):
        return t(a, torch.float32)

    def ffn(f, l):
        return FFN(t(f["w_in"][l]), t(f["w_out"][l]),
                   t(f["w_gate"][l]) if "w_gate" in f else None)

    def block(lay, l):
        at = lay["attn"]
        if cfg.mla is not None:
            attn = M.MLA(**{name: (f32 if name.endswith("norm") else t)(
                at[name][l]) for name in at})
        else:
            attn = A.Attention(t(at["wq"][l]), t(at["wk"][l]),
                               t(at["wv"][l]), t(at["wo"][l]))
        if "moe" not in lay:
            return Block(f32(lay["ln1"][l]), f32(lay["ln2"][l]), attn,
                         ffn=ffn(lay["ffn"], l))
        mo = lay["moe"]
        moe = E.MoE(f32(mo["router"][l]), t(mo["w_in"][l]),
                    t(mo["w_out"][l]),
                    t(mo["w_gate"][l]) if "w_gate" in mo else None,
                    ffn(mo["shared"], l) if "shared" in mo else None)
        return Block(f32(lay["ln1"][l]), f32(lay["ln2"][l]), attn, moe=moe)

    def stack(name, n):
        return [block(np_params[name], l) for l in range(n)]

    n_dense = _n_dense_prefix(cfg)
    head = None if cfg.tie_embeddings else t(np_params["lm_head"])
    return LM(cfg, t(np_params["embed"]),
              stack("layers", cfg.n_layers - n_dense),
              f32(np_params["final_ln"]), head,
              stack("dense_layers", n_dense) if n_dense else None)


# ========================================================= forward =======

def _windows_thetas(cfg: LMConfig) -> Tuple[List[int], List[float]]:
    """Each layer's sliding window (0: none) and RoPE theta."""
    wins = [cfg.layer_window(l) for l in range(cfg.n_layers)]
    thetas = [cfg.rope_theta_local
              if (cfg.rope_theta_local and w > 0) else cfg.rope_theta
              for w in wins]
    return wins, thetas


def _head_logits(x: Tensor, head: Tensor) -> Tensor:
    """x (..., D) @ head (D, V) with float32 logits.

    The JAX package asks for a float32 result of the compute-dtype product
    (``preferred_element_type``).  On the card a bf16 product gets it from
    ``torch.mm(..., out_dtype=torch.float32)`` (float32 accumulation, no
    rounding of the result to bf16); on the CPU, which has no such product,
    the operands are widened to float32 first."""
    if x.dtype == torch.float32:
        return x @ head.to(torch.float32)
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = torch.mm(x2, head.to(x.dtype), out_dtype=torch.float32)
    else:
        out = x2.to(torch.float32) @ head.to(torch.float32)
    return out.reshape(*x.shape[:-1], head.shape[-1])


def _ffn_or_moe(blk: Block, h2: Tensor, cfg: LMConfig) -> Tensor:
    if blk.moe is not None:
        return E.moe_apply(blk.moe, h2, cfg.moe, cfg.ffn_type)[0]
    return ffn_apply(blk.ffn, h2, cfg.ffn_type)


def _block(blk: Block, x: Tensor, *, cfg: LMConfig, window: int,
           theta: float, impl: str):
    """One prefill layer: (x, its cache entries) — (k, v) of (B, Hkv, S,
    Dh), or MLA's (c_kv, k_rope)."""
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    if cfg.mla is not None:
        a, kv = M.mla_forward(blk.attn, h, n_heads=cfg.n_heads, cfg=cfg.mla,
                              rope_theta=cfg.rope_theta, impl=impl,
                              return_cache=True)
    else:
        a, kv = A.mha_forward(
            blk.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head, causal=True, window=window, rope_theta=theta,
            impl=impl, return_kv=True)
    x = x + a
    h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
    return x + _ffn_or_moe(blk, h2, cfg), kv


def _layers(lm: LM):
    """(layer index, block, window, theta) of every layer in order."""
    cfg = lm.cfg
    wins, thetas = _windows_thetas(cfg)
    return list(zip(range(cfg.n_layers), lm.blocks(), wins, thetas))


@torch.inference_mode()
def lm_forward(lm: LM, tokens: Tensor, *, impl: str = "chunked") -> Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    cfg = lm.cfg
    x = lm.embed[tokens].to(dtype_of(cfg.compute_dtype))
    for _, blk, w, th in _layers(lm):
        x, _ = _block(blk, x, cfg=cfg, window=w, theta=th, impl=impl)
    x = rmsnorm(x, lm.final_ln, cfg.norm_eps)
    return _head_logits(x, lm.head)


# ========================================================== serving ======

def _cache_dtype(cfg: LMConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def _local_global(cfg: LMConfig) -> Tuple[List[int], List[int]]:
    """(local layer indices, global layer indices)."""
    wins = [cfg.layer_window(l) for l in range(cfg.n_layers)]
    return ([l for l, w in enumerate(wins) if w > 0],
            [l for l, w in enumerate(wins) if w == 0])


@torch.inference_mode()
def init_cache(cfg: LMConfig, batch: int, seq: int, dtype=None,
               device="cuda") -> Cache:
    """Empty decode cache in the JAX package's layout: ``{"ckv", "krope"}``
    of (L, B, seq, ·) for MLA; ring caches ``{"k_local", "v_local"}`` of
    (n_local, B, Hkv, min(window, seq), Dh) and ``{"k_global",
    "v_global"}`` of (n_global, B, Hkv, seq, Dh) for local:global configs;
    else ``{"k", "v"}`` of (L, B, Hkv, seq, Dh)."""
    dt = dtype or _cache_dtype(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    L, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": zeros(L, batch, seq, m.kv_lora_rank),
                "krope": zeros(L, batch, seq, m.d_rope)}
    if cfg.local_global_period > 0:
        loc, glo = _local_global(cfg)
        w = min(cfg.window, seq) if cfg.window else seq
        return {"k_local": zeros(len(loc), batch, hkv, w, dh),
                "v_local": zeros(len(loc), batch, hkv, w, dh),
                "k_global": zeros(len(glo), batch, hkv, seq, dh),
                "v_global": zeros(len(glo), batch, hkv, seq, dh)}
    return {"k": zeros(L, batch, hkv, seq, dh),
            "v": zeros(L, batch, hkv, seq, dh)}


def _to_ring(ring: Tensor, kv: Tensor) -> None:
    """Fold a (B, H, S, D) prefill into a (B, H, W, D) ring in place: the
    last W tokens of the prompt, token t at slot t % W (the JAX package's
    ``to_ring``)."""
    s, w = kv.shape[2], ring.shape[2]
    tok = torch.arange(max(s - w, 0), s, device=kv.device)
    ring[:, :, tok % w] = kv[:, :, tok].to(ring.dtype)


def _write_prefill(cfg: LMConfig, cache: Cache, l: int, kv, s: int) -> None:
    """Layer ``l``'s prefill entries into a decode-layout cache."""
    a, b = kv
    if cfg.mla is not None:
        cache["ckv"][l, :, :s] = a
        cache["krope"][l, :, :s] = b
    elif cfg.local_global_period > 0:
        loc, glo = _local_global(cfg)
        if l in loc:
            i = loc.index(l)
            _to_ring(cache["k_local"][i], a)
            _to_ring(cache["v_local"][i], b)
        else:
            i = glo.index(l)
            cache["k_global"][i, :, :, :s] = a
            cache["v_global"][i, :, :, :s] = b
    else:
        cache["k"][l, :, :, :s] = a
        cache["v"][l, :, :, :s] = b


@torch.inference_mode()
def prefill_to_decode_cache(cfg: LMConfig, cache: Cache, prompt_len: int,
                            decode_len: int) -> Cache:
    """A prefill cache (``prefill`` without ``decode_len``) in the decode
    layout, a new cache that ``decode_step`` then writes in place: the
    sequence axis padded to ``decode_len`` and, for local:global configs,
    the sliding-window layers folded into ring buffers."""
    seq_axis = {"k": 3, "v": 3, "ckv": 2, "krope": 2}
    for name, c in cache.items():
        if name not in seq_axis or c.shape[seq_axis[name]] != prompt_len:
            raise ValueError(f"cache {name!r} of shape {tuple(c.shape)} is "
                             f"not a prefill cache of {prompt_len} positions")
    first = next(iter(cache.values()))
    out = init_cache(cfg, first.shape[1], decode_len, dtype=first.dtype,
                     device=first.device)
    if cfg.mla is not None:
        for l in range(cfg.n_layers):
            _write_prefill(cfg, out, l, (cache["ckv"][l], cache["krope"][l]),
                           prompt_len)
    else:
        for l in range(cfg.n_layers):
            _write_prefill(cfg, out, l, (cache["k"][l], cache["v"][l]),
                           prompt_len)
    return out


@torch.inference_mode()
def prefill(lm: LM, tokens: Tensor, *, impl: str = "chunked",
            decode_len: Optional[int] = None) -> Tuple[Tensor, Cache]:
    """Inference prefill: (last-token logits (B, V) f32, cache).

    Without ``decode_len`` the cache is the JAX package's prefill layout,
    the prompt's own length: ``{"ckv", "krope"}`` for MLA, else ``{"k",
    "v"}`` of every layer (local ones too).  With a decode budget it is the
    decode layout of ``decode_len`` positions, written directly (the
    prompt at the front, local layers folded into their rings): what
    ``prefill_to_decode_cache`` would make, and what ``decode_step`` then
    writes in place.
    """
    cfg = lm.cfg
    b, s = tokens.shape
    if decode_len is not None and decode_len < s:
        raise ValueError(f"decode_len {decode_len} < prompt length {s}")
    dev, dt = tokens.device, _cache_dtype(cfg)
    if decode_len is not None:
        cache = init_cache(cfg, b, decode_len, device=dev)
    elif cfg.mla is not None:
        cache = init_cache(cfg, b, s, device=dev)
    else:
        shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.d_head)
        cache = {"k": torch.empty(shape, dtype=dt, device=dev),
                 "v": torch.empty(shape, dtype=dt, device=dev)}
    x = lm.embed[tokens].to(dtype_of(cfg.compute_dtype))
    for l, blk, w, th in _layers(lm):
        x, kv = _block(blk, x, cfg=cfg, window=w, theta=th, impl=impl)
        if decode_len is None:
            names = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
            for name, c in zip(names, kv):
                cache[name][l] = c.to(dt)
        else:
            _write_prefill(cfg, cache, l, kv, s)
    x = rmsnorm(x, lm.final_ln, cfg.norm_eps)
    return _head_logits(x[:, -1], lm.head), cache


@torch.inference_mode()
def decode_step(lm: LM, cache: Cache, tokens: Tensor, pos: int, *,
                impl: str = "chunked") -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) int; ``pos`` the new token's position.

    Writes the step's cache entries in place and returns (logits (B, V)
    f32, cache).  Dispatches as the JAX package does: local:global configs
    layer by layer with ring caches (``_decode_unrolled``), MLA through its
    absorbed decode (``_decode_mla``), the rest through ``_decode_gqa``.
    """
    cfg = lm.cfg
    x = lm.embed[tokens].to(dtype_of(cfg.compute_dtype))      # (B, 1, D)
    posv = torch.full((1,), pos, dtype=torch.long, device=x.device)
    if cfg.local_global_period > 0:
        x = _decode_unrolled(lm, cache, x, pos, posv, impl)
    elif cfg.mla is not None:
        x = _decode_mla(lm, cache, x, pos, posv)
    else:
        x = _decode_gqa(lm, cache, x, pos, posv, impl)
    x = rmsnorm(x, lm.final_ln, cfg.norm_eps)
    return _head_logits(x[:, 0], lm.head), cache


def _decode_block_tail(blk: Block, x: Tensor, a: Tensor, cfg: LMConfig):
    x = x + a
    h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
    return x + _ffn_or_moe(blk, h2, cfg)


def _attn_decode(blk, cfg, h, k_c, v_c, pos, posv, w, th, impl, ring=False):
    a, _, _ = A.mha_decode(
        blk.attn, h, k_c, v_c, pos=pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, window=w,
        rope_theta=th, ring=ring, impl=impl, positions=posv)
    return a


def _decode_gqa(lm: LM, cache: Cache, x: Tensor, pos: int, posv: Tensor,
                impl: str):
    cfg = lm.cfg
    for l, blk, w, th in _layers(lm):
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        a = _attn_decode(blk, cfg, h, cache["k"][l], cache["v"][l], pos,
                         posv, w, th, impl)
        x = _decode_block_tail(blk, x, a, cfg)
    return x


def _decode_mla(lm: LM, cache: Cache, x: Tensor, pos: int, posv: Tensor):
    cfg = lm.cfg
    for l, blk, _, _ in _layers(lm):
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        a, _, _ = M.mla_decode(
            blk.attn, h, cache["ckv"][l], cache["krope"][l], pos=pos,
            n_heads=cfg.n_heads, cfg=cfg.mla, rope_theta=cfg.rope_theta,
            positions=posv)
        x = _decode_block_tail(blk, x, a, cfg)
    return x


def _decode_unrolled(lm: LM, cache: Cache, x: Tensor, pos: int,
                     posv: Tensor, impl: str):
    """local:global decode: ring caches for the local layers."""
    cfg = lm.cfg
    il = ig = 0
    for _, blk, w, th in _layers(lm):
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        if w > 0:
            a = _attn_decode(blk, cfg, h, cache["k_local"][il],
                             cache["v_local"][il], pos, posv, w, th, impl,
                             ring=True)
            il += 1
        else:
            a = _attn_decode(blk, cfg, h, cache["k_global"][ig],
                             cache["v_global"][ig], pos, posv, 0, th, impl)
            ig += 1
        x = _decode_block_tail(blk, x, a, cfg)
    return x
