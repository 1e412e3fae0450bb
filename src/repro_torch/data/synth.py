"""Synthetic recsys batches with planted structure (host-side numpy).

The port's own copy of ``recsys_batch_stream`` from the JAX package
(``src/repro/data/synth.py:49``): clicks come from a planted low-rank
user x item affinity.  The same ``numpy.random.Generator`` state gives the
same batches as the JAX package's generator.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def recsys_batch_stream(
    rng: np.random.Generator, family: str, batch: int, *,
    n_sparse: int = 26, multi_hot: int = 1, vocab: int = 1_000_000,
    n_dense: int = 13, seq_len: int = 100, rank: int = 8,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields batches for the recsys families with planted structure."""
    # latent universes never exceed the id vocabulary, so distinct latents
    # never collide onto one embedding row
    n_users_lat = min(4096, vocab)
    n_items_lat = min(8192, vocab)
    u_lat = rng.normal(size=(n_users_lat, rank)).astype(np.float32)
    i_lat = rng.normal(size=(n_items_lat, rank)).astype(np.float32)

    while True:
        if family == "two_tower":
            nf = max(n_sparse // 2, 1)
            u = rng.integers(0, n_users_lat, batch)
            # positive item correlated with user latent
            scores = u_lat[u] @ i_lat.T + rng.gumbel(size=(batch, n_items_lat)) * 0.5
            pos = scores.argmax(axis=1)
            user_ids = np.stack(
                [(u * 2654435761 + f) % vocab for f in range(nf)], 1
            )[:, :, None].astype(np.int32)
            item_ids = np.stack(
                [(pos * 97 + f * 31) % vocab for f in range(nf)], 1
            )[:, :, None].astype(np.int32)
            yield {"user_ids": np.broadcast_to(user_ids, (batch, nf, multi_hot)).astype(np.int32),
                   "item_ids": np.broadcast_to(item_ids, (batch, nf, multi_hot)).astype(np.int32)}
        elif family == "din":
            # positives are items from the user's recent history, negatives
            # random items
            u = rng.integers(0, n_users_lat, batch)
            aff = u_lat[u] @ i_lat.T
            hist = np.argsort(-(aff + rng.gumbel(size=aff.shape)),
                              axis=1)[:, :seq_len]
            label = (rng.random(batch) < 0.5).astype(np.float32)
            pos = hist[np.arange(batch),
                       rng.integers(0, max(seq_len // 2, 1), batch)]
            neg = rng.integers(0, n_items_lat, batch)
            target = np.where(label > 0.5, pos, neg)
            yield {"hist": (hist % vocab).astype(np.int32),
                   "target": (target % vocab).astype(np.int32),
                   "label": label}
        else:  # autoint / dlrm
            u = rng.integers(0, n_users_lat, batch)
            item = rng.integers(0, n_items_lat, batch)
            aff = np.einsum("br,br->b", u_lat[u], i_lat[item])
            label = (aff + rng.normal(size=batch) * 0.5 > 0).astype(np.float32)
            ids = np.stack(
                [((u if f % 2 else item) * 2654435761 + f * 101) % vocab
                 for f in range(n_sparse)], 1
            )[:, :, None].astype(np.int32)
            out = {"ids": np.broadcast_to(ids, (batch, n_sparse, multi_hot)).astype(np.int32),
                   "label": label}
            if family == "dlrm":
                dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
                dense[:, 0] = aff  # leak signal into a dense feature
                out["dense"] = dense
            yield out
