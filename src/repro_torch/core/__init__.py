"""The paper's primary contribution: progressive multi-stage retrieval.

Public API:
  make_schedule / ProgressiveSchedule   — stage schedules (§III.D)
  truncated_search                      — the paper's baseline (§III.C)
  progressive_search                    — per-query variant (CUDA kernels
                                          on the card, plain on the CPU)
  progressive_search_plain              — the same through the plain
                                          versions on any device
  progressive_search_pooled             — the paper's pooled variant
                                          (§III.D), stage 0 on the kernel
  build_index / index_for_schedule      — prefix-norm index build
  top1_accuracy / recall_at_k           — metrics (§III.E)
"""

from repro_torch.core.schedule import (
    ProgressiveSchedule,
    Stage,
    make_schedule,
    validate_schedule,
)
from repro_torch.core.index import (
    build_index,
    index_for_schedule,
    prefix_norm_column,
    prefix_squared_norms,
    stage_dims,
)
from repro_torch.core.truncated import (
    cosine_scores,
    inject_candidates,
    l2_scores,
    rescore_candidates,
    truncated_search,
)
from repro_torch.core.progressive import (
    progressive_search,
    progressive_search_plain,
    progressive_search_pooled,
    progressive_search_pooled_plain,
    rescore_ladder,
)
from repro_torch.core.metrics import overlap_at_k, recall_at_k, top1_accuracy

__all__ = [
    "ProgressiveSchedule", "Stage", "make_schedule", "validate_schedule",
    "build_index", "index_for_schedule", "prefix_norm_column",
    "prefix_squared_norms", "stage_dims",
    "l2_scores", "cosine_scores", "truncated_search", "rescore_candidates",
    "inject_candidates", "rescore_ladder",
    "progressive_search", "progressive_search_plain",
    "progressive_search_pooled", "progressive_search_pooled_plain",
    "top1_accuracy", "recall_at_k", "overlap_at_k",
]
