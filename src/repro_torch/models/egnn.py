"""E(n)-Equivariant Graph Neural Network (EGNN, arXiv:2102.09844) inference —
the port of ``src/repro/models/egnn.py``.

Per layer (eqs. 3-6 of the paper):

    m_ij  = φ_e(h_i, h_j, ||x_i − x_j||², a_ij)
    x_i'  = x_i + Σ_j (x_i − x_j) φ_x(m_ij) / (deg_i + 1)
    h_i'  = h_i + φ_h(h_i, Σ_j m_ij)

The JAX package gathers by edge, runs the edge MLPs over every edge at once
and scatters with ``jax.ops.segment_sum``.  Here the edges are sorted by
receiver once per forward (`sort_edges`: masked edges go to the tail and
are never read), every message is computed in that order, and each of the
three sums of a layer (degree, coordinate update, messages) is one launch
of the CUDA segment-sum kernel over the CSR pointer (``ops
.sorted_segment_sum``; its plain version on the CPU).

The edge MLPs run over fixed chunks of the sorted edges
(``EDGE_CHUNK_BYTES`` of edge-MLP input at a time), writing into
preallocated message and coordinate-update buffers: on ogbn-products
(61.9M edges) the JAX package's all-edges-at-once form needs over 80 GB,
this about 25 GB, with the same numbers row for row.

Entry points
  egnn_init(cfg, seed=, device=)            -> params (random weights)
  load_jax_params(np_params, cfg, device=)  -> params (the JAX package's
                                               ``egnn_init`` pytree)
  param_tree(params)                        -> that pytree (MLPs as lists
                                               of ``{"w", "b"}``, sharing
                                               the weights' storage)
  egnn_forward(params, graph, cfg)          -> (logits (N, C), coords (N, 3))
  egnn_loss(params, graph, cfg)             -> (loss, metrics), gradients
                                               enabled

``egnn_loss`` runs the same layers with gradients enabled: the chunked
edge MLPs write into the preallocated buffers as in inference (autograd
records each chunk's copy), and each sum's gradient comes from the
segment-sum backward kernel on the card (``ops.sorted_segment_sum`` takes
it only when gradients are asked for).  Both take the params as
``egnn_init`` / ``load_jax_params`` make them or as ``param_tree``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import EGNNConfig
from repro_torch.kernels import ops
from repro_torch.kernels.segment_sum import sort_by_segment
from repro_torch.layers.common import (MLP, dtype_of, mlp_apply, mlp_cast,
                                       mlp_init, mlp_specs, mlp_tree,
                                       resolve_device, seeded_generator)
from repro_torch.models.graph import Graph

Tensor = torch.Tensor
Params = Dict[str, object]

#: Bytes of edge-MLP input ((C, 2d + 1 + d_edge) rows) evaluated at a time.
EDGE_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass
class SortedEdges:
    """The live edges of a graph, sorted by receiver (stable)."""

    senders: Tensor     # (E_live,) int32
    receivers: Tensor   # (E_live,) int32, ascending: the segment ids
    edge_attr: Tensor   # (E_live, Fe)
    indptr: Tensor      # (N + 1,) int32 CSR pointer into the sorted edges


def sort_edges(g: Graph) -> SortedEdges:
    """Sort the live edges by receiver once: masked edges (and receivers
    outside [0, N)) go to segment N at the tail and are dropped.  Padding
    ids are clamped as the JAX package clamps them (-1 reads node 0)."""
    n = g.nodes.shape[0]
    r = torch.where(g.edge_mask, g.receivers.clamp(min=0),
                    torch.full_like(g.receivers, n))
    order, r_s, indptr = sort_by_segment(r, n)
    # one host sync per forward; meta tensors (the dry run) hold no
    # values: every edge counts as live, as the JAX package's padded
    # edges all are computed
    n_live = order.shape[0] if indptr.is_meta else int(indptr[-1])
    order = order[:n_live]
    return SortedEdges(senders=g.senders.clamp(0, n - 1)[order].to(torch.int32),
                       receivers=r_s[:n_live], edge_attr=g.edge_attr[order],
                       indptr=indptr)


@torch.no_grad()
def egnn_init(cfg: EGNNConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights from a seeded generator on ``device``."""
    device = resolve_device(device)
    gen = seeded_generator(device, seed)
    dt = dtype_of(cfg.param_dtype)
    d, de = cfg.d_hidden, cfg.d_edge

    def mlp(dims):
        return mlp_init(gen, dims, dt, device=device)

    layers = [{"phi_e": mlp((2 * d + 1 + de, d, d)), "phi_x": mlp((d, d, 1)),
               "phi_h": mlp((2 * d, d, d))} for _ in range(cfg.n_layers)]
    return {"encoder": mlp((cfg.d_feat_in, d)), "layers": layers,
            "decoder": mlp((d, d, cfg.n_classes))}


def load_jax_params(np_params: Dict, cfg: EGNNConfig, device="cuda") -> Params:
    """The JAX package's ``egnn_init`` pytree, as numpy arrays, as the
    port's params (each MLP layer list an ``MLP``)."""
    device = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)
    if len(np_params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(np_params['layers'])} layers for a "
                         f"{cfg.n_layers}-layer config")

    def mlp(layers):
        return MLP.from_numpy(layers, dt, device=device)

    layers: List[Dict[str, MLP]] = [
        {k: mlp(v) for k, v in layer.items()} for layer in np_params["layers"]]
    return {"encoder": mlp(np_params["encoder"]), "layers": layers,
            "decoder": mlp(np_params["decoder"])}


def _messages(p, hm: Tensor, xm: Tensor, es: SortedEdges, mdt
              ) -> Tuple[Tensor, Tensor]:
    """(m (E_live, d), wdx (E_live, 3)) in sorted edge order, evaluated in
    chunks of ``EDGE_CHUNK_BYTES`` of edge-MLP input."""
    phi_e, phi_x = mlp_cast(p["phi_e"], mdt), mlp_cast(p["phi_x"], mdt)
    e, d = es.senders.shape[0], hm.shape[1]
    m = torch.empty((e, d), dtype=mdt, device=hm.device)
    wdx = torch.empty((e, 3), dtype=mdt, device=hm.device)
    width = 2 * d + 1 + es.edge_attr.shape[1]
    step = max(1, EDGE_CHUNK_BYTES // (width * m.element_size()))
    for lo in range(0, e, step):
        hi = min(lo + step, e)
        s = es.senders[lo:hi].long()
        r = es.receivers[lo:hi].long()
        dx = xm[r] - xm[s]                                   # (C, 3)
        feats = [hm[r], hm[s], (dx * dx).sum(dim=-1, keepdim=True)]
        if es.edge_attr.shape[1]:
            feats.append(es.edge_attr[lo:hi].to(mdt))
        mc = mlp_apply(phi_e, torch.cat(feats, dim=-1), act=F.silu,
                       final_act=True)                       # (C, d)
        m[lo:hi] = mc
        wdx[lo:hi] = dx * mlp_apply(phi_x, mc, act=F.silu)
    return m, wdx


def _layer(p, h: Tensor, x: Tensor, es: SortedEdges, ones: Tensor,
           cfg: EGNNConfig) -> Tuple[Tensor, Tensor]:
    n = h.shape[0]
    mdt = dtype_of(cfg.message_dtype)
    m, wdx = _messages(p, h.to(mdt), x.to(mdt), es, mdt)

    def seg_sum(data):
        return ops.sorted_segment_sum(data.to(torch.float32), es.receivers,
                                      es.indptr, num_segments=n)

    # coordinate update (equivariant): x_i += mean_j (x_i - x_j) phi_x(m_ij)
    deg = seg_sum(ones) + 1.0                                # (N,)
    x = x + seg_sum(wdx) / deg[:, None]
    del wdx
    agg = seg_sum(m)                                         # (N, d) float32
    del m
    h = h + mlp_apply(p["phi_h"], torch.cat([h, agg.to(h.dtype)], dim=-1),
                      act=F.silu)
    return h, x


def param_tree(params: Params) -> Dict:
    """The JAX package's ``egnn_init`` pytree of ``params``: each MLP a
    list of ``{"w", "b"}``, the leaves sharing the weights' storage."""
    def conv(m):
        return mlp_tree(m) if isinstance(m, MLP) else m

    return {"encoder": conv(params["encoder"]),
            "layers": [{k: conv(v) for k, v in layer.items()}
                       for layer in params["layers"]],
            "decoder": conv(params["decoder"])}


def egnn_param_logical(cfg: EGNNConfig) -> Dict:
    """Logical axes of a `param_tree` (the JAX package's
    ``egnn_param_logical``)."""
    return {"encoder": mlp_specs((0, 0)),
            "layers": [{"phi_e": mlp_specs((0, 0, 0)),
                        "phi_x": mlp_specs((0, 0, 0)),
                        "phi_h": mlp_specs((0, 0, 0))}
                       for _ in range(cfg.n_layers)],
            "decoder": mlp_specs((0, 0, 0))}


@torch.no_grad()
def egnn_forward(params: Params, g: Graph, cfg: EGNNConfig
                 ) -> Tuple[Tensor, Tensor]:
    """Returns (logits (N, n_classes), coords' (N, 3))."""
    return _forward(params, g, cfg)


def egnn_loss(params: Params, g: Graph, cfg: EGNNConfig):
    """Masked node-classification cross-entropy (labels -1 ignored), with
    gradients enabled.  Returns (loss, {"loss", "acc", "n"})."""
    with torch.enable_grad():
        logits, _ = _forward(params, g, cfg)
        lf = logits.to(torch.float32)
        valid = (g.labels >= 0) & g.node_mask
        safe = g.labels.clamp(min=0).long()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, safe[:, None])[:, 0]
        nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
        n = valid.sum().clamp(min=1)
        loss = nll.sum() / n
        acc = ((lf.argmax(-1) == safe) & valid).sum() / n
    return loss, {"loss": loss, "acc": acc, "n": n}


def _forward(params: Params, g: Graph, cfg: EGNNConfig
             ) -> Tuple[Tensor, Tensor]:
    h = mlp_apply(params["encoder"], g.nodes.to(dtype_of(cfg.param_dtype)))
    x = g.coords.to(h.dtype)
    es = sort_edges(g)
    ones = torch.ones((es.senders.shape[0],), dtype=torch.float32,
                      device=h.device)
    for p in params["layers"]:
        h, x = _layer(p, h, x, es, ones, cfg)
    logits = mlp_apply(params["decoder"], h, act=F.silu)
    return logits, x
