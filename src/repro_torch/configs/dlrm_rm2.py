"""DLRM-RM2 [arXiv:1906.00091; paper]: Facebook ranking model 2.

13 dense + 26 sparse features, embed_dim=64, bottom MLP 13-512-256-64,
top MLP 512-512-256-1, pairwise-dot interaction; 5M rows per table
(RM2-scale).
"""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="dlrm-rm2", family="dlrm",
    embed_dim=64, n_dense=13, n_sparse=26, vocab_per_field=5_000_000,
    bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1), interaction="dot",
)

SMOKE_CONFIG = RecsysConfig(
    name="dlrm-smoke", family="dlrm",
    embed_dim=16, n_dense=13, n_sparse=6, vocab_per_field=1000,
    bot_mlp=(32, 16), top_mlp=(32, 16, 1),
)

SHAPES = RECSYS_SHAPES
