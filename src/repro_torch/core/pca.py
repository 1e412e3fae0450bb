"""PCA dimensionality reduction — the paper's compared alternative (§II,
§III.C), the port's copy of ``src/repro/core/pca.py``.

The paper evaluated PCA against plain truncation and found truncation
slightly better for retrieval accuracy at much lower cost; the port keeps
PCA so that the comparison (Table 2b, ``launch/paper_tables.py``) runs on
the card.

The fit is exact by eigendecomposition of the covariance when D is modest
(`fit_pca`), or by subspace power iteration for large D (`fit_pca_power`).
Both are plain PyTorch on any device (products, QR and a small eigh, no
kernel of this repository; the JAX package leaves them to XLA).  The data
is centred a block of rows at a time, so a 1M x 3584 corpus on the card
(14.3 GB) never gets a centred copy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

#: Rows centred at once: bounds the float32 temporary to this many rows.
_ROWS = 1 << 16


class PCAState(NamedTuple):
    mean: Tensor          # (D,)
    components: Tensor    # (D, K) orthonormal columns, by variance, desc
    explained_var: Tensor # (K,)


def pca_state_from_numpy(mean, components, explained_var,
                         device="cpu") -> PCAState:
    """A fitted state given as arrays (for example one the JAX package
    fitted, as numpy) as float32 tensors on ``device``."""
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device)
    return PCAState(as_t(mean), as_t(components), as_t(explained_var))


def _centred_apply(x: Tensor, mean: Tensor,
                   fn: Callable[[int, Tensor], None]) -> None:
    """Calls ``fn(lo, x[lo:hi] - mean)`` for each block of rows."""
    for lo in range(0, x.shape[0], _ROWS):
        fn(lo, x[lo:lo + _ROWS].to(torch.float32) - mean)


def _gram(x: Tensor, mean: Tensor, v: Optional[Tensor] = None) -> Tensor:
    """xcᵀ xc (v None) or xcᵀ (xc v), xc the centred rows, summed over
    blocks of rows."""
    d = x.shape[1]
    out = torch.zeros((d, d if v is None else v.shape[1]),
                      dtype=torch.float32, device=x.device)

    def add(_, xc):
        out.add_(xc.T @ (xc if v is None else xc @ v))

    _centred_apply(x, mean, add)
    return out


def _top(evals: Tensor, k: int) -> Tensor:
    """Indices of the k largest eigenvalues, descending (``argsort(-e)``)."""
    return torch.argsort(-evals, stable=True)[:k]


def fit_pca(x: Tensor, n_components: int) -> PCAState:
    """Exact PCA via ``torch.linalg.eigh`` on the (D, D) float32
    covariance.  O(N·D² + D³)."""
    x = torch.as_tensor(x)
    mean = x.to(torch.float32).mean(dim=0)
    cov = _gram(x, mean) / (x.shape[0] - 1)
    evals, evecs = torch.linalg.eigh(cov)          # ascending
    order = _top(evals, n_components)
    return PCAState(mean=mean, components=evecs[:, order],
                    explained_var=evals[order])


def fit_pca_power(
    x: Tensor, n_components: int, *, n_iter: int = 8, oversample: int = 8,
    start: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> PCAState:
    """Subspace (block power) iteration PCA — avoids the D×D eigh for
    large D.

    Iterates on an oversampled block of K + ``oversample`` columns and
    extracts the top K by Rayleigh–Ritz.  Cost O(n_iter · N · D · (K+p)).

    Args:
      start:     the (D, K+p) start block before its QR; drawn from
                 ``generator`` (a ``torch.Generator`` on ``x``'s device,
                 seeded 0 when None) when not given.  The JAX package
                 draws it from ``jax.random``, so its block must be passed
                 in for the two to agree.
    """
    x = torch.as_tensor(x)
    mean = x.to(torch.float32).mean(dim=0)
    d = x.shape[1]
    kp = min(d, n_components + oversample)
    if start is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        start = torch.randn((d, kp), generator=generator, device=x.device)
    start = torch.as_tensor(start, dtype=torch.float32, device=x.device)
    if tuple(start.shape) != (d, kp):
        raise ValueError(f"start block {tuple(start.shape)} != ({d}, {kp})")
    v, _ = torch.linalg.qr(start)
    for _ in range(n_iter):
        v, _ = torch.linalg.qr(_gram(x, mean, v))
    # Rayleigh–Ritz: solve the small (kp, kp) projected eigenproblem and
    # rotate the basis, instead of trusting raw QR columns.
    t = v.T @ _gram(x, mean, v) / (x.shape[0] - 1)
    evals, w = torch.linalg.eigh((t + t.T) / 2)    # ascending
    order = _top(evals, n_components)
    return PCAState(mean=mean, components=v @ w[:, order],
                    explained_var=evals[order])


def pca_transform(state: PCAState, x: Tensor) -> Tensor:
    """Project ``x`` onto the fitted components: (N, D) -> (N, K)."""
    x = torch.as_tensor(x)
    out = torch.empty((x.shape[0], state.components.shape[1]),
                      dtype=torch.float32, device=x.device)

    def put(lo, xc):
        out[lo:lo + xc.shape[0]] = xc @ state.components

    _centred_apply(x, state.mean, put)
    return out


def fit_rotation(db: Tensor) -> PCAState:
    """Full-rank PCA rotation: preserves all pairwise L2 distances while
    moving variance into the leading dims, so the paper's progressive
    schedule applies to embeddings that were not trained to be truncated.
    Rotate the corpus once at index-build time and each query at search
    time (one (D, D) product)."""
    return fit_pca(db, torch.as_tensor(db).shape[1])


def rotate(state: PCAState, x: Tensor) -> Tensor:
    """Apply the distance-preserving rotation (centering included)."""
    return pca_transform(state, x)
