"""Pluggable index backends for the retrieval engine.

  flat  — stage-0 full scan at truncated dims (the paper's algorithm; exact
          baseline; builds are free, never stale)

The JAX package's ``ivf`` and ``quantized`` backends are not ported yet:
``make_backend`` raises ``NotImplementedError`` for them.  See
``base.IndexBackend`` for the protocol.
"""

from repro_torch.index_backends.base import (
    IndexBackend,
    IndexState,
    StoreStats,
    backend_names,
    make_backend,
    register_backend,
)
from repro_torch.index_backends.flat import FlatProgressiveBackend

__all__ = [
    "IndexBackend", "IndexState", "StoreStats", "backend_names",
    "make_backend", "register_backend",
    "FlatProgressiveBackend",
]
