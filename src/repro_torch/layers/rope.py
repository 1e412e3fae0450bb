"""Rotary position embeddings (RoPE): the port of ``src/repro/layers/rope.py``."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def rope_freqs(d: int, theta: float, device=None) -> Tensor:
    """(d/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotate the last dim of ``x`` by position.

    Args:
      x:         (..., S, D) with D even; interleaved pairs (x[2i], x[2i+1])
                 are rotated, not the two halves.
      positions: (S,) or broadcastable to x's S axis.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
