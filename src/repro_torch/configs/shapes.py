"""Input-shape sets of the recsys and GNN families (the JAX package's
``RECSYS_SHAPES`` and ``GNN_SHAPES``, the port's own copy)."""

from repro_torch.configs.base import ShapeSpec

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
