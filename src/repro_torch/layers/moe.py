"""Top-k routed Mixture-of-Experts with capacity-based dispatch: the port of
``src/repro/layers/moe.py``.

Dispatch is the JAX package's sort-and-pack scheme: token→expert
assignments are sorted (stably) by expert id, each takes its rank within
its expert, ranks past the static capacity are dropped, and the expert
FFNs run as one batched product over the (E, C, D) packed buffer.  The JAX
package computes all of it in XLA, outside any Pallas kernel; here it is
plain PyTorch (``argsort``, ``searchsorted``, a scatter into the buffer,
``bmm``).  The combine puts each (token, expert) output back in its
unsorted place and sums a token's k outputs in top-k order — the same sum
as the JAX package's scatter-add, in a fixed order (``index_add_`` on the
card adds with atomics, whose order changes from run to run).

``moe_apply_ep`` (the expert-parallel ``shard_map`` path) needs a mesh and
waits for the multi-device slice; ``moe_apply`` has no ``ctx`` route.
Supports DeepSeek-style shared experts and normalised top-k gates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.layers.common import (FFN, _trunc_normal, dense_init,
                                       ffn_apply, ffn_init)

Tensor = torch.Tensor


class MoE(nn.Module):
    """Router (float32, (D, E)), expert weights (E, D, F) / (E, F, D) in the
    JAX package's layout, and the shared experts as one ``FFN``."""

    def __init__(self, router: Tensor, w_in: Tensor, w_out: Tensor,
                 w_gate: Optional[Tensor] = None,
                 shared: Optional[FFN] = None):
        super().__init__()
        self.router = nn.Parameter(router, requires_grad=False)
        self.w_in = nn.Parameter(w_in, requires_grad=False)
        self.w_out = nn.Parameter(w_out, requires_grad=False)
        self.w_gate = (None if w_gate is None
                       else nn.Parameter(w_gate, requires_grad=False))
        self.shared = shared


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             ffn_type: str, dtype, *, device=None) -> MoE:
    e, f = cfg.n_experts, cfg.d_ff_expert

    def experts(d_in, d_out):
        return (_trunc_normal((e, d_in, d_out), generator, device)
                .mul_(d_in ** -0.5).to(dtype))

    router = dense_init(generator, d_model, e, torch.float32, device=device)
    w_in, w_out = experts(d_model, f), experts(f, d_model)
    w_gate = experts(d_model, f) if ffn_type == "swiglu" else None
    shared = (ffn_init(generator, d_model,
                       cfg.d_ff_shared * cfg.n_shared_experts, ffn_type,
                       dtype, device=device)
              if cfg.n_shared_experts else None)
    return MoE(router, w_in, w_out, w_gate, shared)


def _dispatch_local(x2: Tensor, logits: Tensor, cfg: MoEConfig):
    """Sort-and-pack capacity dispatch of (T, D) tokens.

    Returns (buf (E, C, D), combine info, frac_tokens (E,), frac_probs
    (E,)); info is (experts (T, k), order, e_sorted, slot, keep,
    gate_sorted, cap) — ``experts`` and ``keep`` say which experts each
    token reached."""
    t, d = x2.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts = torch.topk(probs, k, dim=-1)
    if cfg.router_norm_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    frac_tokens = torch.bincount(experts.reshape(-1), minlength=e).to(
        torch.float32) / t
    frac_probs = probs.mean(dim=0)

    cap = min(max(int(t * k / e * cfg.capacity_factor), 4), t)
    e_flat = experts.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    gate_sorted = gate_vals.reshape(-1)[order]
    first_of = torch.searchsorted(
        e_sorted, torch.arange(e, device=x2.device), side="left")
    rank = torch.arange(t * k, device=x2.device) - first_of[e_sorted]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))

    buf = torch.zeros((e, cap + 1, d), dtype=x2.dtype, device=x2.device)
    buf[e_sorted, slot] = x2[tok_sorted]
    info = (experts, order, e_sorted, slot, keep, gate_sorted, cap)
    return buf[:, :cap], info, frac_tokens, frac_probs


def _combine_local(y_buf: Tensor, info, t: int, d: int) -> Tensor:
    experts, order, e_sorted, slot, keep, gate_sorted, cap = info
    y_pairs = y_buf[e_sorted, torch.clamp(slot, max=cap - 1)]
    y_pairs = torch.where(keep[:, None], y_pairs, torch.zeros_like(y_pairs))
    y_pairs = y_pairs * gate_sorted[:, None].to(y_pairs.dtype)
    unsorted = torch.empty_like(y_pairs)
    unsorted[order] = y_pairs
    return unsorted.reshape(t, experts.shape[1], d).sum(dim=1)


def moe_apply(p: MoE, x: Tensor, cfg: MoEConfig,
              ffn_type: str) -> Tuple[Tensor, Tensor]:
    """Apply the MoE FFN.  x: (B, S, D) or (T, D).

    Returns (output matching x's shape, aux load-balancing loss, a float32
    scalar tensor)."""
    shape_in = x.shape
    d = shape_in[-1]
    x2 = x.reshape(-1, d)
    t = x2.shape[0]

    logits = x2.to(torch.float32) @ p.router                 # (T, E)
    buf, info, frac_tokens, frac_probs = _dispatch_local(x2, logits, cfg)
    aux = cfg.aux_loss_coef * cfg.n_experts * torch.sum(
        frac_tokens * frac_probs)

    # ---- expert FFN over the packed buffer ----
    h = torch.bmm(buf, p.w_in)
    if ffn_type == "swiglu":
        h = F.silu(torch.bmm(buf, p.w_gate)) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    y_buf = torch.bmm(h, p.w_out)

    # ---- combine: each pair back to its token, gate-weighted ----
    y = _combine_local(y_buf, info, t, d)

    if p.shared is not None:
        y = y + ffn_apply(p.shared, x2, ffn_type)
    return y.reshape(shape_in), aux
