"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B; hf]: 128-expert top-8 MoE.

94L, d_model=4096, 64 heads (GQA kv=4), head_dim=128, 128 routed experts
top-8 (no shared experts), expert d_ff=1536, vocab=151936, SwiGLU.
"""

from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.configs.shapes import lm_shapes

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936, ffn_type="swiglu",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                  capacity_factor=1.25, router_norm_topk=True),
    rope_theta=1e6, max_position=131072,
)

SMOKE_CONFIG = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, ffn_type="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
    param_dtype="float32", compute_dtype="float32", remat=False,
)

SHAPES = lm_shapes(long_ok=False)
