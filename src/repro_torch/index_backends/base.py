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

import numpy as np
import torch

from repro_torch.core.index import stage_dims
from repro_torch.core.schedule import ProgressiveSchedule

Array = torch.Tensor


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


def tail_ids(state: IndexState, n_total: int, tail_cap: int) -> np.ndarray:
    """Static-shape (tail_cap,) int32 id window over un-indexed appended rows.

    Ids ``[built_size, n_total)`` padded with -1 (the candidate sentinel
    ``rescore_candidates`` already scores +inf).  Host-side on purpose: the
    *content* changes per dispatch but the shape never does.
    """
    out = np.full((tail_cap,), -1, np.int32)
    n_tail = min(max(n_total - state.built_size, 0), tail_cap)
    if n_tail:
        out[:n_tail] = np.arange(
            state.built_size, state.built_size + n_tail, dtype=np.int32
        )
    return out


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

    def search_plain(
        self,
        q: Array,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        n_total: int,
        k: int,
    ) -> Tuple[Array, Array]:
        """`search` through the kernels' plain versions on any device, on
        the same state — the reference the kernels' results are checked
        against on the card.  The serving path never calls it."""
        raise NotImplementedError(
            f"{type(self).__name__} has no plain reference route")

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

    # -- persistence ---------------------------------------------------------
    # Data paths (slash-joined nested keys) excluded from state_dict; they
    # reference live store buffers and are re-bound at load (_rebind_loaded).
    _SAVE_SKIP: Tuple[str, ...] = ()

    def state_dict(self, state: IndexState) -> Dict:
        """Serialize ``state`` to ``{"meta": json-able, "arrays": {name:
        np.ndarray}}`` — the JAX package's `IndexBackend.state_dict`
        layout, so a state moves between the two packages either way.

        ``state.data`` is walked as a nested dict of device tensors / host
        arrays / scalars; array leaves land in ``arrays`` under their
        slash-joined path with their kind recorded (``"jax"`` for a device
        array — the JAX package's name for it — ``"np"`` for a host one),
        everything else lands in the meta.  Paths in ``_SAVE_SKIP`` are
        left out and re-attached at load.
        """
        arrays: Dict[str, np.ndarray] = {}
        scalars: Dict[str, object] = {}
        kinds: Dict[str, str] = {}
        dicts: list = []

        def walk(d: Dict, prefix: str) -> None:
            for key, val in d.items():
                path = f"{prefix}{key}"
                if path in self._SAVE_SKIP:
                    continue
                if isinstance(val, dict):
                    dicts.append(path)
                    walk(val, path + "/")
                elif isinstance(val, torch.Tensor):
                    arrays[path] = val.detach().cpu().numpy()
                    kinds[path] = "jax"
                elif isinstance(val, np.ndarray):
                    arrays[path] = val.copy()
                    kinds[path] = "np"
                elif isinstance(val, np.generic):
                    scalars[path] = val.item()
                elif isinstance(val, (bool, int, float, str)) or val is None:
                    scalars[path] = val
                else:
                    raise TypeError(
                        f"cannot serialize state.data[{path!r}] of type "
                        f"{type(val).__name__}; extend "
                        f"{type(self).__name__}.state_dict")

        walk(state.data, "")
        meta = {
            "backend": self.name,
            "kind": state.kind,
            "built_size": state.built_size,
            "built_active": state.built_active,
            "shape_key": _jsonify_key(state.shape_key),
            "scalars": scalars,
            "array_kinds": kinds,
            "dict_paths": dicts,
        }
        return {"meta": meta, "arrays": arrays}

    def load_state(
        self,
        payload: Dict,
        *,
        db: Array,
        valid: Array,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> IndexState:
        """Reconstruct an `IndexState` from a `state_dict` payload — this
        package's or the JAX package's.

        Arrays of kind ``"jax"`` become tensors on the backend's device,
        ``"np"`` arrays stay numpy; dtypes are kept (int8 slabs, uint8
        codes, int32 lists).  The caller guarantees the store holds the
        same rows ``[0, built_size)`` the state was built over; this method
        validates what it can see (backend kind, sizes).  Churn counters
        are re-stamped against the *current* store so staleness accounting
        starts clean: rows appended beyond ``built_size`` since the save
        ride the tail window exactly like rows appended after a build.
        """
        meta, arrays = payload["meta"], payload["arrays"]
        if meta["kind"] != self.name:
            raise ValueError(
                f"checkpointed index is a {meta['kind']!r} state; this "
                f"engine runs the {self.name!r} backend")
        if meta["built_size"] > stats.size:
            raise ValueError(
                f"checkpointed index covers rows [0, {meta['built_size']}) "
                f"but the store holds only {stats.size}; re-add the corpus "
                f"before load_index")
        data: Dict = {}
        for path in meta["dict_paths"]:
            _dig(data, path.split("/"))
        for path, val in meta["scalars"].items():
            parts = path.split("/")
            _dig(data, parts[:-1])[parts[-1]] = val
        for path, arr in arrays.items():
            parts = path.split("/")
            if meta["array_kinds"].get(path) == "jax":
                arr = torch.tensor(np.asarray(arr), device=self.device)
            else:
                # host arrays (list fills, pending ids) are mutated in place
                # by absorb_appends: the loaded state owns its own copy
                arr = np.array(arr)
            _dig(data, parts[:-1])[parts[-1]] = arr
        self._rebind_loaded(data, db=db, valid=valid, sq_prefix=sq_prefix)
        return IndexState(
            kind=meta["kind"],
            generation=stats.generation,
            built_size=meta["built_size"],
            built_active=meta["built_active"],
            # re-stamp churn counters so (adds since load) == (rows past
            # built_size): loaded state starts with zero counted churn
            built_added=stats.total_added - (stats.size - meta["built_size"]),
            built_deleted=stats.total_deleted,
            shape_key=_tuplify_key(meta["shape_key"]),
            data=data,
        )

    def _rebind_loaded(
        self,
        data: Dict,
        *,
        db: Array,
        valid: Array,
        sq_prefix: Optional[Array] = None,
    ) -> None:
        """Hook: re-attach live-buffer references `_SAVE_SKIP` dropped and
        validate loaded shapes against the store.  Default: nothing."""


def _jsonify_key(key):
    """shape_key tuple -> msgpack-able nested list."""
    if isinstance(key, (tuple, list)):
        return [_jsonify_key(x) for x in key]
    return key


def _tuplify_key(key):
    """Nested list -> hashable tuple (the engine's shape-key set)."""
    if isinstance(key, list):
        return tuple(_tuplify_key(x) for x in key)
    return key


def _dig(d: Dict, parts) -> Dict:
    for p in parts:
        d = d.setdefault(p, {})
    return d


class ChurnRebuildBackend(IndexBackend):
    """Shared staleness policy for backends with real build artifacts.

    Soft: rebuild once churn (adds + deletes since build) crosses
    ``rebuild_frac`` of the built corpus.  Hard: rebuild when appended rows
    outgrow the tail window (``state.data['tail_cap']``), since rows past
    it would be unreachable.  Subclasses size their window with
    ``_tail_cap`` at build time and store it in the state.
    """

    def __init__(
        self,
        sched: ProgressiveSchedule,
        *,
        metric: str = "l2",
        block_n: int = 65536,
        device="cuda",
        rebuild_frac: float = 0.25,
        min_rebuild_rows: int = 64,
        tail_window: int = 512,
    ):
        super().__init__(sched, metric=metric, block_n=block_n, device=device)
        self.rebuild_frac = float(rebuild_frac)
        self.min_rebuild_rows = int(min_rebuild_rows)
        self.tail_window = int(tail_window)

    def _churn_since_build(self, state: IndexState, stats: StoreStats) -> int:
        return (stats.total_added - state.built_added) + (
            stats.total_deleted - state.built_deleted
        )

    def _tail_load(self, state: IndexState, stats: StoreStats) -> int:
        """Rows the tail window must currently carry.

        Default: everything appended since the build.  Backends that absorb
        appends into the index between rebuilds (``absorb_appends``)
        override this to count only the rows still outside it.
        """
        return stats.size - state.built_size

    def _tail_cap(self, n_active: int) -> int:
        # 2x the soft-staleness budget, clamped to an absolute window: every
        # query rescores the whole window, so it must NOT scale with the
        # corpus.  needs_rebuild fires at half the window, so the soft
        # trigger always precedes the hard bound.
        soft = max(self.min_rebuild_rows, int(self.rebuild_frac * n_active))
        cap = max(self.min_rebuild_rows, min(2 * soft, self.tail_window))
        # a power of two: the window is part of the dispatched shape, and a
        # stable shape across rebuilds keeps state swaps cheap
        return 1 << (cap - 1).bit_length()

    def needs_rebuild(self, state: IndexState, stats: StoreStats) -> bool:
        if self.must_rebuild(state, stats):
            return True
        # appends approaching the hard tail bound: start rebuilding now
        if self._tail_load(state, stats) >= state.data["tail_cap"] // 2:
            return True
        threshold = max(
            self.min_rebuild_rows,
            self.rebuild_frac * max(state.built_active, 1),
        )
        return self._churn_since_build(state, stats) >= threshold

    def must_rebuild(self, state: IndexState, stats: StoreStats) -> bool:
        # correctness bound: un-absorbed appended rows beyond the tail
        # window would be unreachable until the next build
        return self._tail_load(state, stats) > state.data["tail_cap"]

    def gauges(self, state: IndexState, stats: StoreStats) -> Dict[str, float]:
        tail_cap = int(state.data.get("tail_cap", 0))
        tail_load = self._tail_load(state, stats)
        return {
            "tail_load": float(tail_load),
            "tail_cap": float(tail_cap),
            "tail_fill_frac": tail_load / tail_cap if tail_cap else 0.0,
            "churn_since_build": float(self._churn_since_build(state, stats)),
            "built_size": float(state.built_size),
            "staleness_rows": float(stats.size - state.built_size),
        }


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
    """Resolve a backend from a name — ``'flat'`` (full stage-0 scan),
    ``'ivf'`` (k-means coarse quantizer, probed lists only) or
    ``'quantized'`` (int8 / PQ coded stage 0) — or pass an
    already-constructed instance through."""
    if isinstance(spec, IndexBackend):
        if opts:
            raise ValueError(
                f"backend_opts {sorted(opts)} conflict with an "
                f"already-constructed backend instance"
            )
        return spec
    try:
        cls = _REGISTRY[spec]
    except KeyError:
        raise ValueError(
            f"unknown index backend {spec!r}; available: {backend_names()}"
        ) from None
    return cls(sched, metric=metric, block_n=block_n, device=device,
               **opts)
