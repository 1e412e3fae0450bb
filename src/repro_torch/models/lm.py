"""Config-driven transformer LM for serving: the port of
``src/repro/models/lm.py`` for dense GQA configurations.

Entry points
  init_lm(cfg, seed=, device=)                  -> LM (random weights)
  load_jax_params(np_params, cfg, device)       -> LM (the JAX package's
                                                   ``init_lm`` pytree)
  lm_forward(lm, tokens)                        -> logits (B, S, V) f32
  prefill(lm, tokens, decode_len=)             -> (last logits, cache)
  init_cache(cfg, batch, seq)                   -> empty cache
  prefill_to_decode_cache(cfg, cache, s, total) -> cache padded to total
  decode_step(lm, cache, tok, pos)              -> (logits (B, V) f32, cache)

The JAX package scans stacked layer weights; here the layers are a
``ModuleList`` walked by a Python loop.  Caches keep the JAX layout —
``{"k", "v"}`` of (L, B, Hkv, S, Dh) — and ``decode_step`` writes each
step's entries into them in place.  Attention runs through the flash
kernel on the card (``impl="chunked"``, the default) or the plain reference
(``impl="dense"``).

Not ported yet, each raising ``NotImplementedError``: MoE and MLA layers
(the MoE / MLA decode slice), local:global attention with ring caches (the
Gemma3 slice), and the training loss (``lm_loss``, with a backward kernel).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.layers import attention as A
from repro_torch.layers.common import (FFN, dense_init, dtype_of, embed_init,
                                       ffn_apply, ffn_init, rmsnorm)

Tensor = torch.Tensor
Cache = Dict[str, Tensor]


def _check_supported(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (the MoE decode "
            f"slice, ROADMAP §1 item 7)")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (the MLA decode "
            f"slice, ROADMAP §1 item 7)")
    if cfg.local_global_period > 0 or cfg.window > 0:
        raise NotImplementedError(f"{cfg.name}: {A._LOCAL_GLOBAL}")


# ============================================================ modules ====

class Block(nn.Module):
    def __init__(self, ln1: Tensor, ln2: Tensor, attn: A.Attention, ffn: FFN):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.attn = attn
        self.ffn = ffn


class LM(nn.Module):
    """Weights of a dense GQA LM; ``cfg`` rides along."""

    def __init__(self, cfg: LMConfig, embed: Tensor, layers: List[Block],
                 final_ln: Tensor, lm_head: Optional[Tensor] = None):
        super().__init__()
        _check_supported(cfg)
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but "
                             f"lm_head is {'missing' if lm_head is None else 'given'}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_ln = nn.Parameter(final_ln, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))

    @property
    def head(self) -> Tensor:
        """(D, V) output projection."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ============================================================ init =======

@torch.no_grad()
def init_lm(cfg: LMConfig, *, seed: int = 0, device="cuda") -> LM:
    """Random weights from a seeded generator on ``device`` (the JAX
    package's truncated-normal fan-in init; other numbers than its
    ``jax.random`` draws)."""
    _check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dt, device=device)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(Block(
            torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
            torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
            A.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head, dt, device=device),
            ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_type, dt,
                     device=device)))
    head = (None if cfg.tie_embeddings
            else dense_init(gen, cfg.d_model, cfg.vocab, dt, device=device))
    return LM(cfg, embed, layers,
              torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
              head)


def load_jax_params(np_params: Dict, cfg: LMConfig, device="cuda") -> LM:
    """The JAX package's ``init_lm`` pytree, as numpy arrays, as an ``LM``.

    The stacked (L, ...) leaves of ``np_params["layers"]`` are unstacked
    into one ``Block`` each.  Weights keep their (d_in, d_out) layout — the
    port computes ``x @ w`` as the JAX package does — and their dtype
    (``cfg.param_dtype``; the norm gains stay float32).  bfloat16 arrays go
    through float32, which holds them exactly.
    """
    _check_supported(cfg)
    dt = dtype_of(cfg.param_dtype)

    def t(a, dtype=dt):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=device, dtype=dtype)

    lay = np_params["layers"]
    blocks = []
    for l in range(cfg.n_layers):
        at, ff = lay["attn"], lay["ffn"]
        blocks.append(Block(
            t(lay["ln1"][l], torch.float32), t(lay["ln2"][l], torch.float32),
            A.Attention(t(at["wq"][l]), t(at["wk"][l]), t(at["wv"][l]),
                        t(at["wo"][l])),
            FFN(t(ff["w_in"][l]), t(ff["w_out"][l]),
                t(ff["w_gate"][l]) if "w_gate" in ff else None)))
    head = None if cfg.tie_embeddings else t(np_params["lm_head"])
    return LM(cfg, t(np_params["embed"]), blocks,
              t(np_params["final_ln"], torch.float32), head)


# ========================================================= forward =======

def _windows_thetas(cfg: LMConfig, n_layers: int, offset: int = 0
                    ) -> Tuple[List[int], List[float]]:
    wins = [cfg.layer_window(offset + l) for l in range(n_layers)]
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


def _block(blk: Block, x: Tensor, *, cfg: LMConfig, window: int,
           theta: float, impl: str, return_kv: bool = False):
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    a = A.mha_forward(
        blk.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, causal=True, window=window, rope_theta=theta,
        impl=impl, return_kv=return_kv)
    if return_kv:
        a, kv = a
    x = x + a
    h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
    x = x + ffn_apply(blk.ffn, h2, cfg.ffn_type)
    return (x, kv) if return_kv else x


@torch.inference_mode()
def lm_forward(lm: LM, tokens: Tensor, *, impl: str = "chunked") -> Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    cfg = lm.cfg
    x = lm.embed[tokens].to(dtype_of(cfg.compute_dtype))
    wins, thetas = _windows_thetas(cfg, cfg.n_layers)
    for blk, w, th in zip(lm.layers, wins, thetas):
        x = _block(blk, x, cfg=cfg, window=w, theta=th, impl=impl)
    x = rmsnorm(x, lm.final_ln, cfg.norm_eps)
    return _head_logits(x, lm.head)


# ========================================================== serving ======

def _cache_dtype(cfg: LMConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


@torch.inference_mode()
def init_cache(cfg: LMConfig, batch: int, seq: int, dtype=None,
               device="cuda") -> Cache:
    """Empty decode cache: ``{"k", "v"}`` of (L, B, Hkv, seq, Dh)."""
    _check_supported(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.d_head)
    dt = dtype or _cache_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.inference_mode()
def prefill_to_decode_cache(cfg: LMConfig, cache: Cache, prompt_len: int,
                            decode_len: int) -> Cache:
    """Pad a prefill cache's sequence axis to ``decode_len`` (a new,
    preallocated cache that ``decode_step`` then writes in place)."""
    _check_supported(cfg)
    out = {}
    for name, c in cache.items():
        if c.shape[3] != prompt_len:
            raise ValueError(f"cache {name!r} holds {c.shape[3]} positions, "
                             f"prompt_len is {prompt_len}")
        full = torch.zeros(c.shape[:3] + (decode_len,) + c.shape[4:],
                           dtype=c.dtype, device=c.device)
        full[:, :, :, :prompt_len] = c
        out[name] = full
    return out


@torch.inference_mode()
def prefill(lm: LM, tokens: Tensor, *, impl: str = "chunked",
            decode_len: Optional[int] = None) -> Tuple[Tensor, Cache]:
    """Inference prefill: (last-token logits (B, V) f32, cache).

    The cache holds ``decode_len`` positions (the prompt's own unless
    given), the prompt's written at the front: with a decode budget it is
    the preallocated cache ``decode_step`` then writes in place, and needs
    no `prefill_to_decode_cache`.
    """
    cfg = lm.cfg
    b, s = tokens.shape
    if decode_len is not None and decode_len < s:
        raise ValueError(f"decode_len {decode_len} < prompt length {s}")
    cache = init_cache(cfg, b, s if decode_len is None else decode_len,
                       device=tokens.device)
    x = lm.embed[tokens].to(dtype_of(cfg.compute_dtype))
    wins, thetas = _windows_thetas(cfg, cfg.n_layers)
    for l, (blk, w, th) in enumerate(zip(lm.layers, wins, thetas)):
        x, (k, v) = _block(blk, x, cfg=cfg, window=w, theta=th, impl=impl,
                           return_kv=True)
        cache["k"][l, :, :, :s] = k
        cache["v"][l, :, :, :s] = v
    x = rmsnorm(x, lm.final_ln, cfg.norm_eps)
    logits = _head_logits(x[:, -1], lm.head)
    return logits, cache


@torch.inference_mode()
def decode_step(lm: LM, cache: Cache, tokens: Tensor, pos: int, *,
                impl: str = "chunked") -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) int; ``pos`` the new token's position.

    Writes the step's keys and values into ``cache`` in place and returns
    (logits (B, V) f32, cache).
    """
    cfg = lm.cfg
    x = lm.embed[tokens].to(dtype_of(cfg.compute_dtype))      # (B, 1, D)
    x = _decode_scan_gqa(lm, cache, x, pos, impl)
    x = rmsnorm(x, lm.final_ln, cfg.norm_eps)
    return _head_logits(x[:, 0], lm.head), cache


def _decode_block_tail(blk: Block, x: Tensor, a: Tensor, cfg: LMConfig):
    x = x + a
    h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
    return x + ffn_apply(blk.ffn, h2, cfg.ffn_type)


def _decode_scan_gqa(lm: LM, cache: Cache, x: Tensor, pos: int, impl: str):
    cfg = lm.cfg
    wins, thetas = _windows_thetas(cfg, cfg.n_layers)
    posv = torch.full((1,), pos, dtype=torch.long, device=x.device)
    for l, (blk, w, th) in enumerate(zip(lm.layers, wins, thetas)):
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        a, _, _ = A.mha_decode(
            blk.attn, h, cache["k"][l], cache["v"][l], pos=pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            window=w, rope_theta=th, impl=impl, positions=posv)
        x = _decode_block_tail(blk, x, a, cfg)
    return x
