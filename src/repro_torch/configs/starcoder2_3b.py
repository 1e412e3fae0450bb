"""StarCoder2-3B [arXiv:2402.19173; hf]: dense GQA decoder, RoPE.

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288, vocab=49152.
StarCoder2 uses a plain GELU FFN (not gated) and learned+rotary positions;
we keep RoPE + RMSNorm (framework-uniform; noted in DESIGN.md).
"""

from repro_torch.configs.base import LMConfig
from repro_torch.configs.shapes import lm_shapes

CONFIG = LMConfig(
    name="starcoder2-3b",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab=49152, ffn_type="mlp",
    rope_theta=1e5, max_position=16384,
)

SMOKE_CONFIG = LMConfig(
    name="starcoder2-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab=512, ffn_type="mlp",
    param_dtype="float32", compute_dtype="float32", remat=False,
)

SHAPES = lm_shapes(long_ok=False)
