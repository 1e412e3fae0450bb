"""EGNN [arXiv:2102.09844; paper]: E(n)-equivariant GNN, 4 layers, hidden 64.

Message passing is a segment sum over receiver-sorted edges; the graph
shapes are full-batch small (cora-like), sampled-minibatch (reddit-like),
full-batch-large (ogbn-products) and batched small molecules.
"""

from repro_torch.configs.base import EGNNConfig
from repro_torch.configs.shapes import GNN_SHAPES

CONFIG = EGNNConfig(
    name="egnn", n_layers=4, d_hidden=64, n_classes=47,
)

SMOKE_CONFIG = EGNNConfig(
    name="egnn-smoke", n_layers=2, d_hidden=16, d_feat_in=8, n_classes=4,
)

SHAPES = GNN_SHAPES
