"""DIN [arXiv:1706.06978; paper]: target-attention over user history.

embed_dim=18, history seq_len=100, attention MLP 80-40, main MLP 200-80,
1M-item vocabulary.
"""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="din", family="din",
    embed_dim=18, vocab_per_field=1_000_000, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80), interaction="target-attn",
)

SMOKE_CONFIG = RecsysConfig(
    name="din-smoke", family="din",
    embed_dim=8, vocab_per_field=1000, seq_len=10,
    attn_mlp=(16, 8), mlp=(32, 16),
)

SHAPES = RECSYS_SHAPES
