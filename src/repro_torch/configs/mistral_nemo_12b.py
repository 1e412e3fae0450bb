"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407; hf]: dense GQA, 128k.

40L, d_model=5120, 32 heads (GQA kv=8), head_dim=128, d_ff=14336,
vocab=131072, SwiGLU, rope theta 1M, full attention.
"""

from repro_torch.configs.base import LMConfig
from repro_torch.configs.shapes import lm_shapes

CONFIG = LMConfig(
    name="mistral-nemo-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072, ffn_type="swiglu",
    rope_theta=1e6, max_position=131072,
)

SMOKE_CONFIG = LMConfig(
    name="mistral-nemo-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512, ffn_type="swiglu",
    param_dtype="float32", compute_dtype="float32", remat=False,
)

SHAPES = lm_shapes(long_ok=False)
