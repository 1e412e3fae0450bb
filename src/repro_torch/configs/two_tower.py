"""Two-tower retrieval [Yi et al. RecSys'19 (YouTube); unverified].

embed_dim=256, tower MLPs 1024-512-256, dot-product interaction.  8 sparse
fields (4 user + 4 item), 1M rows per field.  ``retrieval_serve`` scores
the user tower's output against the item tower's 1M-item embedding DB
through the paper's progressive search.
"""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="two-tower-retrieval", family="two_tower",
    embed_dim=256, n_sparse=8, vocab_per_field=1_000_000,
    tower_mlp=(1024, 512, 256), interaction="dot",
    retrieval_d_start=64, retrieval_k0=128,
    matryoshka_dims=(64, 128),
)

SMOKE_CONFIG = RecsysConfig(
    name="two-tower-smoke", family="two_tower",
    embed_dim=32, n_sparse=4, vocab_per_field=1000,
    tower_mlp=(64, 32), interaction="dot",
    retrieval_d_start=8, retrieval_k0=16,
    matryoshka_dims=(8, 16),
)

SHAPES = RECSYS_SHAPES
