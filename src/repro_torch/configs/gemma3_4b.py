"""Gemma3-4B [hf:google/gemma-3-4b-pt; unverified]: 5:1 local:global, 128k.

34L, d_model=2560, 8 heads (GQA kv=4), head_dim=256, d_ff=10240,
vocab=262144.  Every 6th layer is global (full attention, rope theta 1M);
the rest are 1024-token sliding-window local layers (theta 10k).

long_500k runs for this arch: the hybrid local:global pattern makes decode
sub-quadratic-in-memory (window-sized ring caches on 5/6 of the layers) and
the sequence axis of the remaining global caches shards over the mesh.
"""

from repro_torch.configs.base import LMConfig
from repro_torch.configs.shapes import lm_shapes

CONFIG = LMConfig(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab=262144, ffn_type="swiglu",
    window=1024, local_global_period=6,
    rope_theta=1e6, rope_theta_local=1e4,
    tie_embeddings=True, max_position=131072,
)

SMOKE_CONFIG = LMConfig(
    name="gemma3-smoke",
    n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab=512, ffn_type="swiglu",
    window=16, local_global_period=3,
    rope_theta=1e6, rope_theta_local=1e4, tie_embeddings=True,
    param_dtype="float32", compute_dtype="float32", remat=False,
)

SHAPES = lm_shapes(long_ok=True)
