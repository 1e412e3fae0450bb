"""Synthetic but learnable data streams (host-side numpy): the port's own
copy of ``src/repro/data/synth.py``.

  * LM: an order-1 Markov chain over the vocab (`synthetic_markov_lm`,
    `lm_batch_stream`): the cross-entropy floor is the chain's conditional
    entropy, well below the uniform log V.
  * RecSys: clicks from a planted low-rank user x item affinity
    (`recsys_batch_stream`).

The same ``numpy.random.Generator`` state gives the same arrays as the JAX
package's generators, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def synthetic_markov_lm(
    rng: np.random.Generator, vocab: int, *, branching: int = 16
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse row-stochastic transition matrix: (vocab, branching) next
    ids and their probabilities."""
    nxt = rng.integers(0, vocab, size=(vocab, branching), dtype=np.int32)
    w = rng.dirichlet(np.ones(branching) * 0.5, size=vocab).astype(np.float32)
    return nxt, w


def lm_batch_stream(
    rng: np.random.Generator, vocab: int, batch: int, seq: int,
    *, branching: int = 16,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'tokens': (batch, seq + 1) int32} from a Markov chain."""
    nxt, w = synthetic_markov_lm(rng, vocab, branching=branching)
    state = rng.integers(0, vocab, size=batch, dtype=np.int32)
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = state
        for t in range(seq):
            choice = (rng.random(batch)[:, None] >
                      np.cumsum(w[state], axis=1)).sum(axis=1)
            choice = np.minimum(choice, branching - 1)
            state = nxt[state, choice]
            toks[:, t + 1] = state
        yield {"tokens": toks}


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
