"""Input-shape sets of each architecture family (the JAX package's
``LM_SHAPES`` / ``lm_shapes``, ``RECSYS_SHAPES`` and ``GNN_SHAPES``, the
port's own copy)."""

import dataclasses

from repro_torch.configs.base import ShapeSpec

LM_SHAPES = {
    "train_4k": ShapeSpec(name="train_4k", kind="train",
                          seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec(name="prefill_32k", kind="prefill",
                             seq_len=32768, global_batch=32),
    "decode_32k": ShapeSpec(name="decode_32k", kind="decode",
                            seq_len=32768, global_batch=128),
    "long_500k": ShapeSpec(name="long_500k", kind="decode",
                           seq_len=524288, global_batch=1),
}


def lm_shapes(*, long_ok: bool, skip_reason: str = ""):
    shapes = dict(LM_SHAPES)
    if not long_ok:
        shapes["long_500k"] = dataclasses.replace(
            shapes["long_500k"],
            skip_reason=skip_reason or (
                "pure full-attention arch: 512k decode requires sub-quadratic "
                "attention / windowed cache (see DESIGN.md §Arch-applicability)"))
    return shapes


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(name="full_graph_sm", kind="graph",
                               n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": ShapeSpec(name="minibatch_lg", kind="graph",
                              n_nodes=232965, n_edges=114615892,
                              batch_nodes=1024, fanout=(15, 10), d_feat=602),
    "ogb_products": ShapeSpec(name="ogb_products", kind="graph",
                              n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": ShapeSpec(name="molecule", kind="graph",
                          n_nodes=30, n_edges=64, graph_batch=128, d_feat=16),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec(name="train_batch", kind="recsys",
                             global_batch=65536),
    "serve_p99": ShapeSpec(name="serve_p99", kind="recsys",
                           global_batch=512),
    "serve_bulk": ShapeSpec(name="serve_bulk", kind="recsys",
                            global_batch=262144),
    "retrieval_cand": ShapeSpec(name="retrieval_cand", kind="recsys",
                                global_batch=1, n_candidates=1_000_000),
}
