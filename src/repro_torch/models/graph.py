"""Padded edge-list graphs and their synthetic generators — the port of the
serving part of ``src/repro/models/graph.py``.

Graphs are (senders, receivers) int32 edge lists with -1 padding and an
edge mask; aggregation is a segment sum over receivers
(`repro_torch.models.egnn`).  The generators draw from a numpy
``Generator`` exactly as the JAX package's do, so the same seed gives the
same graph in both packages.  The neighbour sampler (`CSRGraph`,
`sampled_subgraph`: GraphSAGE fanout sampling padded to a static node and
edge budget, for minibatch training) is numpy on the host, as in the JAX
package, and draws what it draws: the same generator gives the same
subgraph, bit for bit, returned as a `Graph` on the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


# --------------------------------------------------------------- sampler --

class CSRGraph:
    """Host-side CSR adjacency for neighbour sampling (build once, sample
    often): ``dst`` the receivers sorted (stably) by sender, ``indptr``
    (n_nodes + 1,) int64."""

    def __init__(self, n_nodes: int, senders: np.ndarray,
                 receivers: np.ndarray):
        order = np.argsort(senders, kind="stable")
        self.dst = receivers[order]
        counts = np.bincount(senders, minlength=n_nodes)
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        self.n_nodes = n_nodes

    def sample_khop(
        self, rng: np.random.Generator, seeds: np.ndarray,
        fanout: Tuple[int, ...],
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """GraphSAGE fanout sampling.

        Returns (node_ids, senders, receivers), senders / receivers local
        ids into node_ids, each hop padded to len(frontier) * fanout with
        -1.  Hop-l edges connect frontier-l nodes to their sampled
        neighbours (messages flow neighbour -> node)."""
        node_ids = [seeds.astype(np.int64)]
        id_of = {int(s): i for i, s in enumerate(seeds)}
        send, recv = [], []
        frontier = seeds.astype(np.int64)
        for f in fanout:
            nxt = []
            max_edges = len(frontier) * f
            s_pad = np.full(max_edges, -1, np.int32)
            r_pad = np.full(max_edges, -1, np.int32)
            e = 0
            for u in frontier:
                lo, hi = self.indptr[u], self.indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = rng.integers(0, deg, f)
                for v in self.dst[lo + take]:
                    v = int(v)
                    if v not in id_of:
                        id_of[v] = len(id_of)
                        nxt.append(v)
                    s_pad[e] = id_of[v]
                    r_pad[e] = id_of[int(u)]
                    e += 1
            send.append(s_pad)
            recv.append(r_pad)
            frontier = np.asarray(nxt, np.int64)
            node_ids.append(frontier)
        return np.concatenate(node_ids), np.concatenate(send), \
            np.concatenate(recv)


def sampled_subgraph(
    rng: np.random.Generator, csr: CSRGraph, features: np.ndarray,
    labels: np.ndarray, coords: Optional[np.ndarray],
    batch_nodes: int, fanout: Tuple[int, ...],
    *, node_budget: int, edge_budget: int, device="cuda",
) -> Graph:
    """A fanout subgraph around ``batch_nodes`` seeds drawn without
    replacement, padded to (node_budget, edge_budget), on ``device``.
    Labels only on the seeds (-1 elsewhere); edges that fall outside the
    node budget are masked."""
    device = resolve_device(device)
    seeds = rng.choice(csr.n_nodes, batch_nodes, replace=False)
    ids, s, r = csr.sample_khop(rng, seeds, fanout)
    ids = ids[:node_budget]
    n = len(ids)
    feat = np.zeros((node_budget, features.shape[1]), np.float32)
    feat[:n] = features[ids]
    lab = np.full(node_budget, -1, np.int32)
    lab[:batch_nodes] = labels[seeds]
    co = np.zeros((node_budget, 3), np.float32)
    if coords is not None:
        co[:n] = coords[ids]
    e = min(len(s), edge_budget)
    s_pad = np.full(edge_budget, -1, np.int32)
    r_pad = np.full(edge_budget, -1, np.int32)
    s_pad[:e], r_pad[:e] = s[:e], r[:e]
    valid_e = ((s_pad >= 0) & (s_pad < node_budget) & (r_pad >= 0)
               & (r_pad < node_budget))
    return _graph({"nodes": feat, "coords": co,
                   "senders": np.where(valid_e, s_pad, -1).astype(np.int32),
                   "receivers": np.where(valid_e, r_pad, -1).astype(np.int32),
                   "edge_attr": np.zeros((edge_budget, 0), np.float32),
                   "node_mask": np.arange(node_budget) < n,
                   "edge_mask": valid_e, "labels": lab}, device)
