"""Core layers: norms, dense projections, FFN variants, MLP towers,
initializers, the token cross-entropy.

The port of ``src/repro/layers/common.py``.  Weights keep the JAX
package's layout, (d_in, d_out), and every projection is ``x @ w``, so a
carried weight needs no transpose.  Initializers draw from an explicit
``torch.Generator`` on the weight's device: the same seed does not give the
JAX package's numbers, so parity tests carry weights across instead
(`repro_torch.models.lm.load_jax_params`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init ----

def _trunc_normal(shape, generator: torch.Generator, device) -> Tensor:
    """float32 standard normal truncated to [-3, 3]."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               *, device=None, scale: Optional[float] = None) -> Tensor:
    """Truncated-normal fan-in init (matches common LM practice)."""
    if scale is None:
        scale = d_in ** -0.5
    return (_trunc_normal((d_in, d_out), generator, device)
            .mul_(scale).to(dtype))


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               *, device=None) -> Tensor:
    return _trunc_normal((vocab, d), generator, device).to(dtype)


# --------------------------------------------------------------- norms ----

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm in fp32 with a ``1 + scale`` gain, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor,
              eps: float = 1e-5) -> Tensor:
    """LayerNorm in fp32 (gain ``scale``, ``bias``), cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


# ----------------------------------------------------------------- FFN ----

class FFN(nn.Module):
    """SwiGLU or GELU MLP; weights (d_in, d_out) as in the JAX package."""

    def __init__(self, w_in: Tensor, w_out: Tensor,
                 w_gate: Optional[Tensor] = None):
        super().__init__()
        self.w_in = nn.Parameter(w_in, requires_grad=False)
        self.w_out = nn.Parameter(w_out, requires_grad=False)
        self.w_gate = (None if w_gate is None
                       else nn.Parameter(w_gate, requires_grad=False))


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int,
             ffn_type: str, dtype, *, device=None) -> FFN:
    w_in = dense_init(generator, d_model, d_ff, dtype, device=device)
    w_out = dense_init(generator, d_ff, d_model, dtype, device=device)
    w_gate = (dense_init(generator, d_model, d_ff, dtype, device=device)
              if ffn_type == "swiglu" else None)
    return FFN(w_in, w_out, w_gate)


def ffn_specs(ffn_type: str):
    """Logical axes of an FFN's weights (the JAX package's)."""
    p = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}
    if ffn_type == "swiglu":
        p["w_gate"] = ("embed", "mlp")
    return p


def ffn_apply(p: FFN, x: Tensor, ffn_type: str) -> Tensor:
    h = x @ p.w_in
    if ffn_type == "swiglu":
        h = F.silu(x @ p.w_gate) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return h @ p.w_out


# ----------------------------------------------------------------- MLP ----

class MLP(nn.Module):
    """Plain MLP tower: weights (d_in, d_out) as in the JAX package's
    ``mlp_init`` list of ``{"w", "b"}`` layers."""

    def __init__(self, weights, biases):
        super().__init__()
        self.w = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in weights])
        self.b = nn.ParameterList(
            [nn.Parameter(b, requires_grad=False) for b in biases])

    @classmethod
    def from_numpy(cls, layers, dtype, *, device=None) -> "MLP":
        """The JAX package's ``mlp_init`` layers, as numpy arrays."""
        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
                device=device, dtype=dtype)
        return cls([t(l["w"]) for l in layers], [t(l["b"]) for l in layers])

    def cast(self, dtype) -> "MLP":
        """This MLP with its weights in ``dtype`` (itself when they are)."""
        if self.w[0].dtype == dtype:
            return self
        return MLP([w.to(dtype) for w in self.w], [b.to(dtype) for b in self.b])


def mlp_init(generator: torch.Generator, dims, dtype, *,
             device=None) -> MLP:
    """dims = (d_in, h1, ..., d_out); fan-in truncated-normal weights, zero
    biases."""
    pairs = list(zip(dims, dims[1:]))
    return MLP([dense_init(generator, a, b, dtype, device=device)
                for a, b in pairs],
               [torch.zeros((b,), dtype=dtype, device=device) for _, b in pairs])


def mlp_specs(dims, *, bias: bool = True):
    """Logical axes of an ``mlp_init(dims)`` tower (the JAX package's)."""
    layer = {"w": ("embed", "mlp"), **({"b": ("mlp",)} if bias else {})}
    return [dict(layer) for _ in range(len(dims) - 1)]


def mlp_layers(mlp):
    """(w, b) of each layer of an ``MLP`` or of the JAX package's list of
    ``{"w", "b"}`` dicts (the training tree, `mlp_tree`)."""
    if isinstance(mlp, MLP):
        return list(zip(mlp.w, mlp.b))
    return [(layer["w"], layer["b"]) for layer in mlp]


def mlp_tree(mlp: MLP):
    """An ``MLP`` as the JAX package's list of ``{"w", "b"}`` dicts, of
    tensors sharing the weights' storage (detached: a training tree's own
    leaves)."""
    return [{"w": w.detach(), "b": b.detach()} for w, b in mlp_layers(mlp)]


def mlp_cast(mlp, dtype):
    """``mlp`` with its weights in ``dtype`` (itself when they are)."""
    if isinstance(mlp, MLP):
        return mlp.cast(dtype)
    if mlp[0]["w"].dtype == dtype:
        return mlp
    return [{k: t.to(dtype) for k, t in layer.items()} for layer in mlp]


def mlp_apply(mlp, x: Tensor, *, act=F.relu,
              final_act: bool = False) -> Tensor:
    """``mlp`` an ``MLP`` or a list of ``{"w", "b"}`` dicts."""
    layers = mlp_layers(mlp)
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ------------------------------------------------------------- losses ----

def softmax_xent(logits: Tensor, labels: Tensor, *, z_loss: float = 0.0):
    """Token cross-entropy in float32 with an optional z-loss; labels < 0
    are ignored.  Returns (mean loss, number of valid tokens)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    n = valid.sum().clamp(min=1)
    return nll.sum() / n, n


def seeded_generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` for initialising weights on
    ``device``: on the device itself, or on the CPU for ``meta`` tensors
    (which have no generator of their own and draw nothing: the dry run's
    shapes)."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is available (pass ``device="cpu"`` for the plain path)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run on the kernels' plain versions")
    return device
