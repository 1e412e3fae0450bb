"""AdamW + global-norm clipping + warmup-cosine schedule over trees of
tensors: the port of ``src/repro/optim/adamw.py``.

A tree is what the checkpoint layer walks (``checkpoint.ckpt._leaves``):
dicts by sorted key, lists, tuples and ``NamedTuple``s in order, ``None``
an empty subtree, tensors as leaves.  Optimizer moments are float32
whatever the parameters' dtype; the update is computed in float32 and cast
to the parameter's dtype, with no float32 master copy, as the JAX package
does.  Decoupled weight decay applies to leaves of two or more dimensions.
``grad_dtype`` casts the gradients before clipping (``'bfloat16'``: the JAX
package's gradient compression before the data-parallel reduction).

All of it is plain PyTorch elementwise work under ``no_grad``: the JAX
package computes it in XLA, outside any Pallas kernel.  ``adamw_update``
is functional by default (new tensors); with ``inplace=True`` it writes
the new parameters and moments into the given tensors, which is what the
JAX package's train step gets by donating its buffers, and what lets a
3B-parameter model's step fit beside its moments.

``opt_state_logical`` mirrors the params' logical axes, so the moments
shard as their parameters do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import _leaves, _unflatten
from repro_torch.layers.common import dtype_of

Tensor = torch.Tensor


class OptState(NamedTuple):
    step: Tensor         # () int32
    mu: object           # tree like params, float32
    nu: object           # tree like params, float32


def _map(fn, tree):
    leaves, _ = _leaves(tree)
    return _unflatten(tree, [fn(x) for x in leaves])


def adamw_init(params) -> OptState:
    """Zero float32 moments like ``params`` and step 0, on the first
    leaf's device."""
    leaves, _ = _leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=_map(zeros, params), nu=_map(zeros, params))


def opt_state_logical(param_logical) -> OptState:
    """Logical axes of an ``OptState`` given the params' logical tree."""
    return OptState(step=(), mu=param_logical, nu=param_logical)


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> float:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * base_lr`` at ``total``; float32 arithmetic as the
    JAX package's.  ``step`` an int or a 0-d tensor."""
    f32 = np.float32
    s = f32(int(step))
    if s < warmup:
        return float(f32(base_lr) * (s + f32(1)) / f32(max(warmup, 1)))
    prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0), f32(1))
    cos = f32(math.cos(math.pi * float(prog)))
    return float(f32(base_lr) * (f32(min_ratio) + f32(1 - min_ratio)
                                 * f32(0.5) * (f32(1) + cos)))


@torch.no_grad()
def global_norm(grads) -> Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a 0-d
    float32 tensor on the first leaf's device)."""
    leaves, _ = _leaves(grads)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        gf = g.to(torch.float32)
        total = total + torch.sum(gf * gf)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)) in their own
    dtypes, the global norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return _map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                grads), gn


@torch.no_grad()
def adamw_update(
    params, grads, state: OptState, *, lr, b1: float = 0.9,
    b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
    max_grad_norm: float = 1.0, grad_dtype: Optional[str] = None,
    inplace: bool = False, grad_norm: Optional[Tensor] = None,
):
    """One AdamW step.  Returns (new params, new state, {"grad_norm"}).

    ``lr`` a float (or 0-d tensor).  The gradients are clipped leaf by leaf
    as `clip_by_global_norm` clips them (no clipped copy of the whole
    tree), by their global norm, or by ``grad_norm`` when given (the norm
    of a whole tree of which this rank holds a part).  With ``inplace``
    the parameter and moment tensors of ``params`` and ``state`` are
    overwritten and returned in the same trees; the gradients are only
    read."""
    flat_g, _ = _leaves(grads)
    if grad_dtype:
        flat_g = [g.to(dtype_of(grad_dtype)) for g in flat_g]
    gnorm = global_norm(flat_g) if grad_norm is None else grad_norm
    scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = int(state.step) + 1
    b1c = float(1 - np.float32(b1) ** np.float32(step))
    b2c = float(1 - np.float32(b2) ** np.float32(step))
    lr = float(lr)

    flat_p, _ = _leaves(params)
    flat_mu, _ = _leaves(state.mu)
    flat_nu, _ = _leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError(f"{len(flat_p)} params, {len(flat_g)} grads, "
                         f"{len(flat_mu)} / {len(flat_nu)} moments")
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
        # the clipped gradient in the gradient's own dtype, then float32
        gf = (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
        if inplace:
            mu.mul_(b1).add_(gf, alpha=1 - b1)
            nu.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        else:
            mu = b1 * mu + (1 - b1) * gf
            nu = b2 * nu + (1 - b2) * gf * gf
        del gf
        delta = torch.sqrt(nu / b2c).add_(eps)
        delta = (mu / b1c).div_(delta)
        pf = p.to(torch.float32)
        if p.dim() >= 2:                 # decoupled decay on matrices only
            delta.add_(pf, alpha=weight_decay)
        delta.mul_(-lr).add_(pf)         # pf - lr * delta
        if inplace:
            p.copy_(delta)
            new_p.append(p)
        else:
            new_p.append(delta.to(p.dtype))
        del delta, pf
        new_mu.append(mu)
        new_nu.append(nu)
    step_t = torch.full((), step, dtype=torch.int32, device=state.step.device)
    return (_unflatten(params, new_p),
            OptState(step_t, _unflatten(state.mu, new_mu),
                     _unflatten(state.nu, new_nu)),
            {"grad_norm": gnorm})
