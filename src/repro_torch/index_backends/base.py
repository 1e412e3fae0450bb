"""The index-backend protocol: pluggable search structures behind the engine.

The paper's progressive search needs only a flat buffer, but its stated
future work — ANN integration — and the repo's north star (corpus scale)
need *index structures* with build state: IVF centroids, int8 code blocks,
and whatever comes next.  This module defines the contract between
`repro_torch.engine.RetrievalEngine` and such structures so new backends slot in
without forking the engine:

  * ``build(db, valid, sq_prefix=..., stats=...) -> IndexState`` — construct
    index state from a snapshot of the store's buffers.  Called at a safe
    point between batches (or on a background thread); must not mutate the
    store.
  * ``search(q, state, db, valid, ...) -> (scores, ids)`` — answer a padded
    query batch against the *live* buffers using the (possibly stale) state.
    Correctness contract: a row whose validity bit is clear is never
    returned, and a live row is always reachable — even when it was appended
    after ``state`` was built (see the tail-injection note below).
  * ``needs_rebuild(state, stats) -> bool`` — staleness policy: the engine
    rebuilds when this fires.  ``must_rebuild`` is the hard variant the
    engine honors even with rebuilds disabled, for backends whose
    correctness (not just quality) degrades past a staleness bound.

**Tail injection.**  Rows appended after a build are not in the index
(IVF lists / int8 codes don't cover them).  Backends keep a static-size
*tail window* (``tail_cap``, sized from the rebuild threshold at build
time): the ids ``[built_size, store.size)`` are injected into every query's
candidate list ahead of the progressive rescore, so un-indexed rows are
scored exactly and stay retrievable between rebuilds.  When the tail
outgrows its window, ``must_rebuild`` fires and the engine rebuilds before
the next dispatch — the window can never be silently exceeded.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.index import stage_dims
from repro_torch.core.schedule import ProgressiveSchedule

Array = torch.Tensor

# Backends of the JAX package that this package does not run yet.
NOT_PORTED = ("ivf", "quantized")


@dataclasses.dataclass(frozen=True)
class StoreStats:
    """Snapshot of a DocStore's mutation counters (feeds ``needs_rebuild``)."""

    size: int            # high-water mark: rows ever appended (pre-compaction)
    n_active: int        # rows with the validity bit set
    capacity: int        # allocated buffer rows
    generation: int      # bumped on every mutation
    total_added: int     # lifetime rows appended
    total_deleted: int   # lifetime rows tombstoned

    @property
    def n_dead(self) -> int:
        return self.size - self.n_active

    @property
    def dead_frac(self) -> float:
        return self.n_dead / self.size if self.size else 0.0


@dataclasses.dataclass
class IndexState:
    """Opaque (to the engine) build artifact + the snapshot it was built at.

    ``shape_key`` participates in the engine's first-dispatch tracking: any
    change that alters the dispatched shapes (list-table width, tail window)
    must change it, so new shapes are attributed correctly.
    """

    kind: str
    generation: int         # store generation at build time
    built_size: int         # rows [0, built_size) are covered by the index
    built_active: int       # live rows at build time
    built_added: int        # store.total_added at build time
    built_deleted: int      # store.total_deleted at build time
    shape_key: Tuple = ()
    data: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_stats(
        cls,
        kind: str,
        stats: "StoreStats",
        *,
        shape_key: Tuple = (),
        data: Optional[Dict] = None,
    ) -> "IndexState":
        """Snapshot the stats fields every backend must record identically —
        staleness accounting over churn depends on them."""
        return cls(
            kind=kind,
            generation=stats.generation,
            built_size=stats.size,
            built_active=stats.n_active,
            built_added=stats.total_added,
            built_deleted=stats.total_deleted,
            shape_key=shape_key,
            data=data if data is not None else {},
        )


class IndexBackend(abc.ABC):
    """Search structure behind the retrieval engine.

    Subclasses are constructed with the engine's static search config
    (schedule / stage dims / metric / scan block) plus backend-specific
    options, and are stateless across builds: all per-corpus state lives in
    the ``IndexState`` they return, which the engine owns and swaps
    atomically.
    """

    name: str = "?"

    def __init__(
        self,
        sched: ProgressiveSchedule,
        *,
        metric: str = "l2",
        block_n: int = 65536,
        device="cuda",
    ):
        self.sched = sched
        self.dims = stage_dims(sched)
        self.metric = metric
        self.block_n = int(block_n)
        self.device = torch.device(device)

    # -- protocol ----------------------------------------------------------
    @abc.abstractmethod
    def build(
        self,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> IndexState:
        """Build index state from a buffer snapshot.  Must not mutate it."""

    @abc.abstractmethod
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
        """((Q, k) scores, (Q, k) int32 ids) over the live buffers.

        ``n_total`` is the store's current high-water row count (`store.size`
        — a host int, so tail windows never change a shape).  May return
        device arrays; the engine syncs.

        ``overrides`` is an optional duck-typed degradation bundle (the
        adaptive policy's `SearchOverrides`: ``n_probe_frac`` /
        ``oversample_frac`` / ``sched`` attributes, frozen and hashable so
        it can ride the engine's shape keys).  Backends honour the knobs they
        have and ignore the rest; the engine only passes it when the
        adaptive policy is degrading, so the kwarg's default keeps custom
        backends working unchanged.  The result width (``k`` columns) must
        not change with ``overrides``.
        """

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
        """`search` with a host fence at the stage-0/rescore boundary.

        ``fence(arrays)`` is an engine-supplied callback: implementations
        call it exactly once with the stage-0 outputs; the engine
        synchronises the device there and timestamps the boundary
        (`repro_torch.obs` trace marks).  This path trades one extra host sync
        per batch for a real stage-0/rescore latency split — it is only
        selected under ``obs.stage_fences``; the default serving path keeps
        the fully fused programs.

        Default: fall back to the fused `search` without calling ``fence``
        (custom backends degrade to traces without the split).
        """
        kw = {} if overrides is None else {"overrides": overrides}
        return self.search(q, state, db, valid, sq_prefix=sq_prefix,
                           n_total=n_total, k=k, **kw)

    def gauges(self, state: IndexState, stats: StoreStats) -> Dict[str, float]:
        """Point-in-time observability gauges for this state (staleness,
        tail occupancy, code coverage, ...), published by the engine's
        metrics collector as ``repro_backend_state{backend=...,key=...}``.
        Keys are backend-defined; values must be numeric."""
        return {}

    def needs_rebuild(self, state: IndexState, stats: StoreStats) -> bool:
        """Soft staleness: rebuild improves quality/cost but isn't required."""
        return False

    def must_rebuild(self, state: IndexState, stats: StoreStats) -> bool:
        """Hard staleness: searching ``state`` would be incorrect."""
        return False

    def absorb_appends(
        self,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> None:
        """Fold rows appended since the build into ``state`` incrementally.

        Called by the engine at the same safe points as ``maybe_rebuild``
        (under ``engine.lock``, never mid-batch); may mutate ``state.data``
        in place but must preserve every traced shape (``shape_key`` is
        fixed for the state's lifetime).  Default: no-op — appended rows
        ride the tail window until the next rebuild.  Backends that can
        absorb appends cheaply (e.g. IVF nearest-centroid assignment into
        spare list slots) override this so append-heavy workloads stop
        forcing early rebuilds.
        """

    def describe(self) -> str:
        return f"{type(self).__name__}(metric={self.metric})"


# -- registry ---------------------------------------------------------------
_REGISTRY: Dict[str, type] = {}


def register_backend(cls: type) -> type:
    """Class decorator: expose a backend under its ``name``."""
    _REGISTRY[cls.name] = cls
    return cls


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_backend(
    spec,
    *,
    sched: ProgressiveSchedule,
    metric: str = "l2",
    block_n: int = 65536,
    device="cuda",
    **opts,
) -> "IndexBackend":
    """Resolve a backend from a name (``'flat'``; ``'ivf'`` and
    ``'quantized'`` are not ported yet) or pass an already-constructed
    instance through."""
    if isinstance(spec, IndexBackend):
        if opts:
            raise ValueError(
                f"backend_opts {sorted(opts)} conflict with an "
                f"already-constructed backend instance"
            )
        return spec
    if spec in NOT_PORTED and spec not in _REGISTRY:
        raise NotImplementedError(
            f"index backend {spec!r} is not ported yet; this package runs "
            f"{backend_names()}")
    try:
        cls = _REGISTRY[spec]
    except KeyError:
        raise ValueError(
            f"unknown index backend {spec!r}; available: {backend_names()}"
        ) from None
    return cls(sched, metric=metric, block_n=block_n, device=device,
               **opts)
