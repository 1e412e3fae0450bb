"""Retrieval quality metrics (paper §III.E)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def top1_accuracy(retrieved: Tensor, ground_truth: Tensor) -> Tensor:
    """Fraction of queries whose top-1 retrieved index equals the ground truth.

    Args:
      retrieved:    (Q,) or (Q, k) retrieved indices (column 0 = best).
      ground_truth: (Q,) true document index per query.
    """
    if retrieved.dim() == 2:
        retrieved = retrieved[:, 0]
    return (retrieved == ground_truth).to(torch.float32).mean()


def recall_at_k(retrieved: Tensor, ground_truth: Tensor, k: int) -> Tensor:
    """Fraction of queries whose ground truth appears in the top-k retrieved."""
    hits = (retrieved[:, :k] == ground_truth[:, None]).any(dim=1)
    return hits.to(torch.float32).mean()


def overlap_at_k(a: Tensor, b: Tensor, k: int) -> Tensor:
    """Mean per-query overlap |a_k ∩ b_k| / k between two retrieval results."""
    eq = a[:, :k, None] == b[:, None, :k]
    inter = eq.any(dim=2).sum(dim=1)
    return inter.to(torch.float32).mean() / k
