"""DeepSeek-V2-236B [arXiv:2405.04434; hf]: MLA + fine-grained MoE.

60L, d_model=5120, 128 heads, MLA (q_lora=1536, kv_lora=512, d_nope=128,
d_rope=64, d_v=128); MoE: 2 shared + 160 routed experts top-6,
expert d_ff=1536, first layer dense (d_ff=12288); vocab=102400.

Decode uses the absorbed-MLA path: the cache is (c_kv 512 + k_rope 64) per
token — 9x smaller than GQA-8 at the same d_model.
"""

from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig
from repro_torch.configs.shapes import lm_shapes

CONFIG = LMConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=12288, vocab=102400, ffn_type="swiglu",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared_experts=2, d_ff_shared=1536,
                  capacity_factor=1.25, first_k_dense=1),
    rope_theta=1e4, max_position=131072,
)

SMOKE_CONFIG = LMConfig(
    name="deepseek-v2-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
    d_ff=256, vocab=512, ffn_type="swiglu",
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                  d_nope=32, d_rope=16, d_v=32),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                  n_shared_experts=1, d_ff_shared=64, first_k_dense=1),
    param_dtype="float32", compute_dtype="float32", remat=False,
)

SHAPES = lm_shapes(long_ok=False)
