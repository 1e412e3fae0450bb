"""Logical-axis sharding and the collectives over a mesh's named dims.

  repro_torch.sharding.specs        — rules, ``ShardingCtx`` (specs, DTensor
                                      placements, local blocks), ``make_ctx``
  repro_torch.sharding.collectives  — all-gather, all-to-all and means over
                                      named mesh dims, staged through host
                                      memory on ``gloo``
"""

from repro_torch.sharding.specs import (
    DEFAULT_RULES,
    NULL_CTX,
    AbstractMesh,
    ShardingCtx,
    make_ctx,
)

__all__ = ["ShardingCtx", "NULL_CTX", "DEFAULT_RULES", "AbstractMesh",
           "make_ctx"]
