"""Config dataclasses of the architectures the port serves.

The port's own copy of ``LMConfig``, ``MoEConfig``, ``MLAConfig``,
``ShapeSpec``, ``EGNNConfig`` and ``RecsysConfig`` from the JAX package
(``src/repro/configs/base.py``), field for field, so that a configuration
reads the same in both packages.  Configs are frozen dataclasses.  Every
architecture module in ``repro_torch.configs`` exposes

    CONFIG        — the exact published configuration
    SMOKE_CONFIG  — a reduced same-family configuration for CPU tests
    SHAPES        — shape name -> ShapeSpec
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# --------------------------------------------------------------------------
# LM transformers
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001
    router_norm_topk: bool = True  # normalize top-k gate weights to sum 1
    first_k_dense: int = 0         # leading dense layers (DeepSeek-V2 uses 1)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int               # 0 -> full-rank q projection
    kv_lora_rank: int
    d_nope: int                    # per-head non-rotary dim
    d_rope: int                    # per-head rotary dim (shared key)
    d_v: int                       # per-head value dim


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    ffn_type: str = "swiglu"       # 'swiglu' | 'mlp' (gelu)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # attention pattern
    window: int = 0                # 0 -> full attention
    local_global_period: int = 0   # gemma3: every Nth layer is global (others local)
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0  # gemma3 uses a different theta for local layers
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True             # checkpoint each layer in training
    max_position: int = 131072

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def layer_window(self, layer: int) -> int:
        """Static per-layer sliding window (0 = full attention)."""
        if self.local_global_period <= 0:
            return self.window
        # gemma3 pattern: layers 0..p-2 local, layer p-1 global, repeating.
        if (layer + 1) % self.local_global_period == 0:
            return 0
        return self.window

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            q = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (m.d_nope + m.d_rope)
                 if m.q_lora_rank else d * self.n_heads * (m.d_nope + m.d_rope))
            kv = d * (m.kv_lora_rank + m.d_rope) + m.kv_lora_rank * self.n_heads * (m.d_nope + m.d_v)
            attn = q + kv + self.n_heads * m.d_v * d
        else:
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d
        if self.moe is not None:
            e = self.moe
            gmul = 3 if self.ffn_type == "swiglu" else 2
            moe_ffn = e.n_experts * gmul * d * e.d_ff_expert \
                + e.n_shared_experts * gmul * d * e.d_ff_shared + d * e.n_experts
            dense_ffn = gmul * d * f
            ffn_total = e.first_k_dense * dense_ffn + (L - e.first_k_dense) * moe_ffn
            return emb + L * attn + ffn_total
        gmul = 3 if self.ffn_type == "swiglu" else 2
        return emb + L * (attn + gmul * d * f)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d, L = self.d_model, self.n_layers
        gmul = 3 if self.ffn_type == "swiglu" else 2
        total = self.param_count()
        all_experts = (L - e.first_k_dense) * e.n_experts * gmul * d * e.d_ff_expert
        active_experts = (L - e.first_k_dense) * e.top_k * gmul * d * e.d_ff_expert
        return total - all_experts + active_experts


# --------------------------------------------------------------------------
# input shapes
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture x input-shape) cell of the shape matrix."""

    name: str
    kind: str                      # 'train' | 'prefill' | 'decode' | 'graph' | 'recsys'
    seq_len: int = 0
    global_batch: int = 0
    # graph shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    graph_batch: int = 0           # batched-small-graphs
    # recsys shapes
    n_candidates: int = 0
    skip_reason: str = ""          # non-empty -> documented skip


# --------------------------------------------------------------------------
# GNN
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_feat_in: int = 0             # set per shape
    d_coord: int = 3
    d_edge: int = 0
    n_classes: int = 16
    param_dtype: str = "float32"
    # dtype of the gathered per-edge message tensors
    message_dtype: str = "float32"


# --------------------------------------------------------------------------
# RecSys
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    family: str                    # 'two_tower' | 'din' | 'autoint' | 'dlrm'
    embed_dim: int
    n_dense: int = 0
    n_sparse: int = 0
    vocab_per_field: int = 1_000_000
    multi_hot: int = 1             # ids per sparse field (bag size)
    # two-tower
    tower_mlp: Tuple[int, ...] = ()
    # din
    seq_len: int = 0
    attn_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # dlrm
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    interaction: str = "dot"
    param_dtype: str = "float32"
    # progressive-retrieval integration (two-tower serving)
    retrieval_d_start: int = 64
    retrieval_k0: int = 128
    # Matryoshka auxiliary losses on truncated prefixes (training only)
    matryoshka_dims: Tuple[int, ...] = ()
