"""Core layers: norms, dense projections, FFN variants, MLP towers,
initializers.

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


def mlp_apply(mlp: MLP, x: Tensor, *, act=F.relu,
              final_act: bool = False) -> Tensor:
    n = len(mlp.w)
    for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is available (pass ``device="cpu"`` for the plain path)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run on the kernels' plain versions")
    return device
