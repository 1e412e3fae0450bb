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

Two execution paths share the dispatch (`_dispatch_local`): one device
(and decode), and ``moe_apply_ep``, the expert-parallel path that
``moe_apply`` takes on a mesh with a ``model`` dim for a (B, S > 1, D)
slab, as the JAX package does: each rank dispatches its own token slab,
one all-to-all over ``model`` hands every rank the tokens routed to its
experts, and a second one brings the results back.
On a mesh with a ``model`` dim a layer holds only its rank's E/ep experts
(the ``expert`` rule's block, `ShardingCtx.held_blocks`): the EP path runs
them as they are, and the local path (decode) gathers the whole experts
over ``model`` first (what GSPMD inserts for the JAX package).
Supports DeepSeek-style shared experts and normalised top-k gates.
"""

from __future__ import annotations

import types
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.layers.common import (FFN, _trunc_normal, dense_init,
                                       ffn_apply, ffn_init, ffn_specs)

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


def moe_specs(cfg: MoEConfig, ffn_type: str):
    """Logical axes of an MoE layer's weights (the JAX package's)."""
    p = {
        # router replicated: tiny, and the EP path needs full-D logits
        "router": (None, None),
        "w_in": ("expert", "embed", "mlp"),
        "w_out": ("expert", "mlp", "embed"),
    }
    if ffn_type == "swiglu":
        p["w_gate"] = ("expert", "embed", "mlp")
    if cfg.n_shared_experts:
        p["shared"] = ffn_specs(ffn_type)
    return p


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

    # tokens a routed slot sends to each expert (a bincount; counted by a
    # scatter of ones, which meta tensors also take)
    ones = torch.ones(experts.numel(), dtype=torch.float32,
                      device=x2.device)
    frac_tokens = torch.zeros(e, dtype=torch.float32, device=x2.device) \
        .scatter_add_(0, experts.reshape(-1), ones) / t
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


def _experts(p: MoE, buf: Tensor, ffn_type: str) -> Tensor:
    """The experts ``p`` holds over their (E_held, C, D) packed buffer."""
    h = torch.bmm(buf, p.w_in)
    if ffn_type == "swiglu":
        h = F.silu(torch.bmm(buf, p.w_gate)) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p.w_out)


def _ep_size(ctx) -> int:
    """The ``model`` dim of ``ctx``'s mesh (1 without one)."""
    mesh = getattr(ctx, "mesh", None) if ctx is not None else None
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return 1
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))["model"]


def _whole_experts(p: MoE, cfg: MoEConfig, ctx):
    """``p`` with its whole experts: as it is when it holds all E, else its
    E/ep slice all-gathered over ``model`` (in expert order)."""
    e = cfg.n_experts
    held = p.w_in.shape[0]
    if held == e:
        return p
    ep = _ep_size(ctx)
    if ep * held != e:
        raise ValueError(f"the layer holds {held} of {e} experts, not "
                         f"E / ep = {e} / {ep}: pass the mesh's ctx")
    from repro_torch.sharding import collectives as C

    def join(w):
        return None if w is None else C.all_gather(
            w, ctx.mesh, "model", dim=0).reshape((e,) + tuple(w.shape[1:]))

    return types.SimpleNamespace(router=p.router, w_in=join(p.w_in),
                                 w_out=join(p.w_out), w_gate=join(p.w_gate),
                                 shared=p.shared)


def _uses_ep(ctx, x: Tensor, cfg: MoEConfig) -> bool:
    """The JAX package's test for the EP path: a mesh with a ``model`` dim
    that divides the experts, and a (B, S > 1, D) slab."""
    mesh = getattr(ctx, "mesh", None) if ctx is not None else None
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return False
    return (cfg.n_experts % _ep_size(ctx) == 0 and x.dim() == 3
            and x.shape[1] > 1)


def moe_apply_ep(p: MoE, x: Tensor, cfg: MoEConfig, ffn_type: str,
                 ctx) -> Tuple[Tensor, Tensor]:
    """Expert-parallel MoE over the ``model`` dim of ``ctx.mesh``: the
    train / prefill path of the JAX package's ``moe_apply_ep``.

    ``x`` is this rank's (B_l, S, D) token slab: the batch sharded over
    ``(pod, data)``, replicated over ``model``.

      1. each rank dispatches its slab into a local (E, C_l, D) buffer,
         with the capacity of its own T;
      2. one all-to-all over ``model`` (bf16 on the wire)
         turns it into (E/ep, C_l·ep, D): rank m gets, from every member, the tokens
         routed to experts [m·E/ep, (m+1)·E/ep);
      3. rank m runs those experts, the only ones ``p`` holds (its E/ep
         slice, the ``expert`` rule's block, `ShardingCtx.held_blocks`).
         The slice is whole over ``data`` (the JAX package's rules also
         split it over ``data`` and gather it back a layer: here there is
         nothing to gather);
      4. the reverse all-to-all and the local combine put the gate-weighted
         results back in token order; the shared experts run locally.

    The aux loss is each rank's local value averaged over the token axes
    (``pmean``).  Gradients: the ep members of a ``model`` group hold
    copies of the same tokens, so the owner of an expert receives ep
    copies' gradients, ep times the one-device gradient of that group's
    tokens.  The train step's reduction (``collectives.reduce_gradients_``)
    averages a slice over the other axes and divides by ep again.  What
    reaches the optimizer is the one-device gradient of the slice, as the
    world mean leaves it for every replicated weight.
    """
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.specs import mesh_axes

    mesh = ctx.mesh
    sizes = mesh_axes(mesh)
    ep = sizes["model"]
    b, s, d = x.shape
    e = cfg.n_experts
    if e % ep:
        raise ValueError(f"{e} experts do not split over {ep} ranks")
    per = e // ep
    if p.w_in.shape[0] != per:
        raise ValueError(f"the layer holds {p.w_in.shape[0]} experts, not "
                         f"this rank's {per} of {e}: cut it with "
                         f"ShardingCtx.held_blocks")
    token_axes = tuple(a for a in ("pod", "data", "model") if a in sizes)

    x2 = x.reshape(-1, d)
    t_l = x2.shape[0]
    logits = x2.to(torch.float32) @ p.router
    buf, info, frac_t, frac_p = _dispatch_local(x2, logits, cfg)
    aux_local = cfg.aux_loss_coef * e * torch.sum(frac_t * frac_p)
    aux = C.all_mean(aux_local, mesh, token_axes)

    # EP exchange: (E, C_l, D) -> (E/ep, ep·C_l, D), bf16 on the wire
    cap = buf.shape[1]
    recv = C.all_to_all(buf.to(torch.bfloat16), mesh, "model")
    recv = recv.reshape(ep, per, cap, d).transpose(0, 1).reshape(
        per, ep * cap, d).to(x2.dtype)
    y_buf = _experts(p, recv, ffn_type)

    # reverse exchange + local combine
    back = y_buf.to(torch.bfloat16).reshape(per, ep, cap, d).transpose(0, 1)
    back = C.all_to_all(back.reshape(e, cap, d), mesh, "model")
    y = _combine_local(back.to(x2.dtype), info, t_l, d)
    y = y.reshape(b, s, d)
    if p.shared is not None:
        y = y + ffn_apply(p.shared, x, ffn_type)
    return y, aux


def moe_apply(p: MoE, x: Tensor, cfg: MoEConfig, ffn_type: str, *,
              ctx=None) -> Tuple[Tensor, Tensor]:
    """Apply the MoE FFN.  x: (B, S, D) or (T, D).

    When ``ctx`` carries a mesh with a ``model`` dim that divides the
    experts and x is a (B, S > 1, D) slab, dispatch goes through
    `moe_apply_ep`; single-token decode and one device keep the local
    path, which gathers a layer's held expert slices whole first (not
    differentiable: decode runs without gradients).

    Returns (output matching x's shape, aux load-balancing loss, a float32
    scalar tensor)."""
    if _uses_ep(ctx, x, cfg):
        return moe_apply_ep(p, x, cfg, ffn_type, ctx)
    p = _whole_experts(p, cfg, ctx)
    shape_in = x.shape
    d = shape_in[-1]
    x2 = x.reshape(-1, d)
    t = x2.shape[0]

    logits = x2.to(torch.float32) @ p.router                 # (T, E)
    buf, info, frac_tokens, frac_probs = _dispatch_local(x2, logits, cfg)
    aux = cfg.aux_loss_coef * cfg.n_experts * torch.sum(
        frac_tokens * frac_probs)

    # ---- expert FFN over the packed buffer ----
    y_buf = _experts(p, buf, ffn_type)

    # ---- combine: each pair back to its token, gate-weighted ----
    y = _combine_local(y_buf, info, t, d)

    if p.shared is not None:
        y = y + ffn_apply(p.shared, x2, ffn_type)
    return y.reshape(shape_in), aux
