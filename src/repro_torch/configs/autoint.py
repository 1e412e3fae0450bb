"""AutoInt [arXiv:1810.11921; paper]: self-attention feature interaction.

39 sparse fields, embed_dim=16, 3 attention layers x 2 heads x d_attn=32
(Criteo-scale vocabularies ~ 100k rows/field).
"""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="autoint", family="autoint",
    embed_dim=16, n_sparse=39, vocab_per_field=100_000,
    n_attn_layers=3, n_attn_heads=2, d_attn=32, interaction="self-attn",
)

SMOKE_CONFIG = RecsysConfig(
    name="autoint-smoke", family="autoint",
    embed_dim=8, n_sparse=6, vocab_per_field=500,
    n_attn_layers=2, n_attn_heads=2, d_attn=8,
)

SHAPES = RECSYS_SHAPES
