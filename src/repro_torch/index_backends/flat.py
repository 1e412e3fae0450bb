"""Flat progressive backend — the engine's default search path.

No build artifact beyond the store's own buffers (the prefix-norm table is
maintained incrementally by ``DocStore.add``), so the state is a bare
snapshot record: builds are free, nothing ever goes stale, and every row is
covered the moment it lands in the buffer.  On CUDA buffers a search is one
stage-0 scan kernel plus one gather-rescore kernel per later stage.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.progressive import progressive_search, rescore_ladder
from repro_torch.index_backends.base import (
    IndexBackend,
    IndexState,
    StoreStats,
    register_backend,
)

Array = torch.Tensor


@register_backend
class FlatProgressiveBackend(IndexBackend):
    """Stage-0 full scan at truncated dims + progressive rescore (paper §III.D)."""

    name = "flat"

    def build(
        self,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> IndexState:
        return IndexState.from_stats(self.name, stats,
                                     shape_key=(self.name,))

    def _sched(self, overrides):
        # adaptive degradation: swap in the shallower schedule (higher
        # stage-0 truncation error, same final_k → same result width); its
        # stage dims are present in self.dims, so sq-prefix lookups stay
        # precomputed
        if overrides is None or overrides.sched is None:
            return self.sched
        return overrides.sched

    def search(
        self,
        q: Array,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        n_total: int,
        k: int,
        overrides=None,
    ) -> Tuple[Array, Array]:
        scores, ids = progressive_search(
            q, db, self._sched(overrides),
            sq_prefix=sq_prefix,
            index_dims=self.dims,
            valid=valid,
            block_n=min(self.block_n, db.shape[0]),
            metric=self.metric,
        )
        # scores ascend; the leading k columns are the top results (only a
        # single-stage schedule is wider than the engine's out_k)
        return scores[:, :k], ids[:, :k]

    def search_fenced(
        self,
        q: Array,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        n_total: int,
        k: int,
        fence,
        overrides=None,
    ) -> Tuple[Array, Array]:
        sched = self._sched(overrides)
        scores, cand = progressive_search(
            q, db, sched,
            sq_prefix=sq_prefix,
            index_dims=self.dims,
            valid=valid,
            block_n=min(self.block_n, db.shape[0]),
            metric=self.metric,
            stage0_only=True,
        )
        fence((scores, cand))
        scores, ids = rescore_ladder(
            q, db, cand, sched.stages[1:],
            sq_prefix=sq_prefix, index_dims=self.dims,
            valid=valid, metric=self.metric, scores=scores,
        )
        return scores[:, :k], ids[:, :k]
