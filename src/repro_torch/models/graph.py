"""Padded edge-list graphs and their synthetic generators — the port of the
serving part of ``src/repro/models/graph.py``.

Graphs are (senders, receivers) int32 edge lists with -1 padding and an
edge mask; aggregation is a segment sum over receivers
(`repro_torch.models.egnn`).  The generators draw from a numpy
``Generator`` exactly as the JAX package's do, so the same seed gives the
same graph in both packages.  The neighbour sampler (``CSRGraph``,
``sampled_subgraph``) belongs to the training path and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.layers.common import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class Graph:
    """Padded edge-list graph of tensors on one device."""

    nodes: Tensor       # (N, F) node features
    coords: Tensor      # (N, 3) coordinates (EGNN) — zeros if unused
    senders: Tensor     # (E,) int32, -1 padding
    receivers: Tensor   # (E,) int32, -1 padding
    edge_attr: Tensor   # (E, Fe) or (E, 0)
    node_mask: Tensor   # (N,) bool
    edge_mask: Tensor   # (E,) bool
    labels: Tensor      # (N,) int32 node labels (or graph label per node 0)

    def to(self, device) -> "Graph":
        return Graph(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


def _graph(arrays: Dict[str, np.ndarray], device) -> Graph:
    return Graph(**{k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for k, a in arrays.items()})


def _random_arrays(rng: np.random.Generator, n_nodes: int, n_edges: int,
                   d_feat: int, n_classes: int, d_edge: int,
                   power_law: bool) -> Dict[str, np.ndarray]:
    """The JAX package's ``random_graph`` draws, in its order, as numpy."""
    if power_law:
        w = rng.pareto(2.0, n_nodes) + 1.0
        p = w / w.sum()
        senders = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
        receivers = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
    else:
        senders = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
        receivers = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    coords = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes, dtype=np.int32)
    ea = (rng.normal(size=(n_edges, d_edge)).astype(np.float32)
          if d_edge else np.zeros((n_edges, 0), np.float32))
    return {"nodes": feats, "coords": coords, "senders": senders,
            "receivers": receivers, "edge_attr": ea,
            "node_mask": np.ones((n_nodes,), bool),
            "edge_mask": np.ones((n_edges,), bool), "labels": labels}


def random_graph(
    rng: np.random.Generator, n_nodes: int, n_edges: int, d_feat: int,
    *, n_classes: int = 16, d_edge: int = 0, power_law: bool = True,
    device="cuda",
) -> Graph:
    """Synthetic graph with (optionally) power-law degree distribution, on
    ``device``."""
    device = resolve_device(device)
    return _graph(_random_arrays(rng, n_nodes, n_edges, d_feat, n_classes,
                                 d_edge, power_law), device)


def batched_molecules(
    rng: np.random.Generator, batch: int, n_nodes: int, n_edges: int,
    d_feat: int, *, n_classes: int = 16, device="cuda",
) -> Graph:
    """``batch`` disjoint small graphs packed into one padded graph
    (block-diagonal adjacency — the standard molecule batching)."""
    device = resolve_device(device)
    gs = [_random_arrays(rng, n_nodes, n_edges, d_feat, n_classes, 0, False)
          for _ in range(batch)]
    off = np.arange(batch) * n_nodes
    cat = {k: np.concatenate([g[k] for g in gs]) for k in gs[0]}
    for k in ("senders", "receivers"):
        cat[k] = np.concatenate(
            [g[k] + o for g, o in zip(gs, off)]).astype(np.int32)
    return _graph(cat, device)
