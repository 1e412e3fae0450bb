"""Synthetic embedding corpus with the statistics that make the paper's
experiments reproducible offline.

The port's copy of ``src/repro/rag/corpus.py``: the same
``np.random.default_rng`` draws in the same order, so for a given size and
seed the port's corpus is the JAX package's corpus bit for bit.  The
arrays are made on the host in numpy; `to_device` moves them to the card.

The paper embeds 1M dbpedia documents with text-embedding-3-large (3072) and
gte-Qwen2-7B (3584) and measures top-1 retrieval accuracy of GPT-generated
queries as a function of *truncation* dimensionality (Table II/IV): accuracy
climbs steeply through ~64-256 dims and saturates in the low-to-mid 90s by
the full dimensionality.  Two statistical properties produce that curve:

  1. **Decaying per-dimension signal**: leading dimensions carry more of the
     query-document alignment.  Documents are drawn as
     d_i = s ⊙ z_i,  z ~ N(0, I),  s_j = (1+j)^-alpha.
  2. **Hard distractors**, two kinds:
     - *exact twins* (mirrored/boilerplate documents): retrieval returns the
       twin half the time — a permanent accuracy cap;
     - *late-dim near-twins*: copies that differ only in trailing embedding
       dimensions — indistinguishable at low truncation, resolved as dims
       grow.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Rows a host-to-card copy of `to_device` moves at once (64k rows of 3584
# float32 are 940 MB).
_COPY_ROWS = 1 << 16


@dataclasses.dataclass
class SyntheticCorpus:
    db: np.ndarray          # (N, D) document embeddings
    queries: np.ndarray     # (Q, D) query embeddings
    ground_truth: np.ndarray  # (Q,) index of each query's source document
    scales: np.ndarray      # (D,) the spectrum used


def make_corpus(
    n_docs: int = 100_000,
    dim: int = 1024,
    n_queries: int = 2470,
    *,
    alpha: float = 0.2,
    sigma: float = 1.25,
    sigma_spread: float = 0.55,
    twin_frac: float = 0.08,
    late_twin_frac: float = 0.05,
    late_start_frac: float = 0.25,
    late_sigma: float = 0.6,
    seed: int = 0,
    dtype=np.float32,
) -> SyntheticCorpus:
    """Build the synthetic corpus (the JAX package's draws, in its order).

    Args:
      alpha:        per-dimension signal decay exponent.
      sigma:        median query noise (per-dim scaled by the spectrum).
      sigma_spread: lognormal spread of per-query noise (query difficulty).
      twin_frac:    fraction of *queried* docs given an (effectively exact)
                    twin elsewhere — permanent ~frac/2 top-1 loss.
      late_twin_frac: fraction given a near-twin differing only in dims
                    >= late_start_frac * dim (resolved as dims grow).
      late_sigma:   size of the near-twin's late-dim offset.
    """
    rng = np.random.default_rng(seed)
    scales = (1.0 + np.arange(dim)) ** (-alpha)
    scales = (scales / np.linalg.norm(scales) * np.sqrt(dim)).astype(dtype)

    # scaled in place: the same products as `draw * scales`, half the peak
    # host memory at the paper's 14.3 GB
    db = rng.standard_normal((n_docs, dim), dtype=dtype)
    db *= scales
    # sources live in the first half; twins overwrite rows in the second
    # half so a twin never clobbers another query's source
    gt = rng.choice(n_docs // 2, n_queries, replace=False)

    spare = np.arange(n_docs // 2, n_docs)
    rng.shuffle(spare)
    n_twin = int(n_queries * twin_frac)
    n_late = int(n_queries * late_twin_frac)
    twin_of = rng.choice(n_queries, n_twin + n_late, replace=False)

    # "exact" twins: an infinitesimal symmetric offset (1e-3) so the
    # query-noise sign — not index order — decides ties
    twin_rows = db[gt[twin_of[:n_twin]]].copy()
    twin_rows += 1e-3 * scales * rng.standard_normal(
        (n_twin, dim), dtype=dtype)
    db[spare[:n_twin]] = twin_rows

    # late-dim near-twins: identical leading dims, offset trailing dims
    late0 = int(dim * late_start_frac)
    late_rows = db[gt[twin_of[n_twin:]]].copy()
    late_rows[:, late0:] += (late_sigma * scales[late0:]
                             * rng.standard_normal((n_late, dim - late0),
                                                   dtype=dtype))
    db[spare[n_twin: n_twin + n_late]] = late_rows

    sig_q = sigma * np.exp(
        sigma_spread * rng.standard_normal(n_queries)).astype(dtype)
    queries = db[gt] + sig_q[:, None] * scales * rng.standard_normal(
        (n_queries, dim), dtype=dtype)
    return SyntheticCorpus(db=db, queries=queries.astype(dtype),
                           ground_truth=gt.astype(np.int64), scales=scales)


def make_clustered_corpus(
    n_docs: int = 100_000,
    dim: int = 256,
    n_queries: int = 256,
    *,
    n_clusters: int = 96,
    cluster_spread: float = 2.0,
    cluster_std: float = 0.35,
    sigma: float = 0.25,
    alpha: float = 0.2,
    seed: int = 0,
    dtype=np.float32,
) -> SyntheticCorpus:
    """Topically-clustered corpus — the workload ANN backends are built for:
    a mixture of ``n_clusters`` gaussians over the same decaying spectrum,
    queries noisy copies of their source documents.

    Args:
      cluster_spread: centre scale relative to within-cluster std scale.
      cluster_std:    within-cluster document spread (per-dim scaled).
      sigma:          query noise (per-dim scaled).
    """
    rng = np.random.default_rng(seed)
    scales = (1.0 + np.arange(dim)) ** (-alpha)
    scales = (scales / np.linalg.norm(scales) * np.sqrt(dim)).astype(dtype)

    centers = (cluster_spread * scales
               * rng.standard_normal((n_clusters, dim), dtype=dtype))
    topic = rng.integers(0, n_clusters, n_docs)
    db = centers[topic] + cluster_std * scales * rng.standard_normal(
        (n_docs, dim), dtype=dtype)
    gt = rng.choice(n_docs, n_queries, replace=False)
    queries = db[gt] + sigma * scales * rng.standard_normal(
        (n_queries, dim), dtype=dtype)
    return SyntheticCorpus(db=db, queries=queries.astype(dtype),
                           ground_truth=gt.astype(np.int64), scales=scales)


def to_device(corpus: SyntheticCorpus, device) -> SyntheticCorpus:
    """The corpus with every array a tensor on ``device`` (``db`` copied in
    blocks of rows, so no second host copy of it is made); ``ground_truth``
    becomes int64, the rest keep their type."""
    device = torch.device(device)
    src = corpus.db
    db = torch.empty(src.shape, dtype=torch.from_numpy(src[:0]).dtype,
                     device=device)
    for lo in range(0, src.shape[0], _COPY_ROWS):
        db[lo:lo + _COPY_ROWS].copy_(
            torch.from_numpy(np.ascontiguousarray(src[lo:lo + _COPY_ROWS])))
    return SyntheticCorpus(
        db=db, queries=torch.from_numpy(corpus.queries).to(device),
        ground_truth=torch.from_numpy(corpus.ground_truth).to(device),
        scales=torch.from_numpy(corpus.scales).to(device))
