"""Pluggable index backends for the retrieval engine.

  flat       — stage-0 full scan at truncated dims (the paper's algorithm;
               exact baseline; builds are free, never stale)
  ivf        — k-means coarse quantizer (clustered and probed at
               ``probe_dim``); only probed lists' members are scored —
               float32, int8 or PQ member slabs (sub-linear stage 0,
               rebuilt on churn)
  quantized  — int8 or PQ coded stage-0 block scan, exact full-precision
               rescore

All three share the progressive rescore ladder after candidate generation,
honor the store's validity mask (deleted rows are unreturnable), and keep
rows appended after a build reachable via tail injection until the engine
rebuilds.  See ``base.IndexBackend`` for the protocol.
"""

from repro_torch.index_backends.base import (
    ChurnRebuildBackend,
    IndexBackend,
    IndexState,
    StoreStats,
    backend_names,
    make_backend,
    register_backend,
    tail_ids,
)
from repro_torch.index_backends.flat import FlatProgressiveBackend
from repro_torch.index_backends.ivf import IVFProgressiveBackend
from repro_torch.index_backends.quantized import QuantizedProgressiveBackend

__all__ = [
    "ChurnRebuildBackend", "IndexBackend", "IndexState", "StoreStats",
    "backend_names", "make_backend", "register_backend", "tail_ids",
    "FlatProgressiveBackend", "IVFProgressiveBackend",
    "QuantizedProgressiveBackend",
]
