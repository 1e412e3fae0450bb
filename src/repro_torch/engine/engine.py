"""RetrievalEngine: queued, shape-bucketed progressive search over a mutable
corpus.

The serving decomposition (standard for RAG retrieval backends — see the
surveys in PAPERS.md):

    submit() ──> RequestQueue ──> step(): pop chunk, pad to bucket,
                                          progressive_search over DocStore
                                          ──> per-request results + stats

* **Shape bucketing** — every dispatch shape is (bucket, capacity) for a
  bucket from a static ladder, so the kernels see a small fixed set of
  shapes; the first dispatch of each shape (which pays one-time set-up:
  kernel build and load, allocator growth) is counted separately in the
  stats so latency percentiles aren't polluted by it.
* **Mutable corpus** — ``add_docs`` / ``delete_docs`` mutate the DocStore's
  capacity-doubling buffers; the validity mask rides through every search
  stage, so a deleted doc can never be returned, even by an in-flight
  candidate list.
* **Pluggable index backends** — the search structure is an
  `repro_torch.index_backends.IndexBackend` (``backend=`` config:
  ``'flat'``, ``'ivf'`` or ``'quantized'``).  Backends declare staleness
  from the store's mutation counters; the engine rebuilds at a safe point
  between batches (synchronously, or on a background thread with
  ``rebuild_mode='background'``) and atomically swaps the index state.  A rebuild doubles
  as tombstone compaction: past ``compact_dead_frac`` dead rows the store's
  buffers are rebuilt without tombstones (live doc ids are REMAPPED —
  ``on_remap`` callbacks let id-holding callers follow).
* **Durability** — ``enable_durability`` / ``recover`` open a mutation
  write-ahead log (`repro_torch.engine.wal`): every ``add_docs`` /
  ``delete_docs`` / compaction is logged (fsync'd) before it is applied or
  acknowledged; ``save_snapshot`` writes the store and index state through
  `repro_torch.checkpoint`, and ``recover`` restores the newest valid
  snapshot and replays the log's tail.  Snapshots and logs are the JAX
  package's files, so either package recovers what the other wrote;
  ``save_index`` / ``load_index`` persist a built index alone, and
  ``apply_replicated`` feeds a follower (`repro_torch.engine.replication`).
* **Observability** — per-request latency (queue + compute split), per-batch
  padding waste, rebuild/compaction counts, and a stage-by-stage timing
  profile (``profile_stages``).
* **Device** — the store's buffers live on the engine's ``device``
  (``"cuda"`` unless the caller passes ``device="cpu"``); on CUDA every
  dispatch runs the hand-written kernels: the flat stage-0 scan, the IVF
  and PQ scans, and the rescore step.

The engine is synchronous and single-host by design: ``step()`` is the unit a
driver loop calls, and ``execute_batch()`` is the direct entry point the
async driver (`repro_torch.engine.driver.EngineDriver`) uses for pre-formed
batches.  Every public mutating/serving method is guarded by ``engine.lock``
(a reentrant lock), so client threads may race ``add_docs`` / ``delete_docs``
/ ``submit`` / ``poll`` against the driver thread's dispatches — the lock is
coarse on purpose: one device, one in-flight batch, and stats counters that
must reconcile exactly under concurrency.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ProgressiveSchedule, make_schedule, stage_dims
from repro_torch.engine.adaptive import SearchOverrides
from repro_torch.engine.batching import BucketPolicy, PendingRequest, RequestQueue, pad_batch
from repro_torch.engine.config import EngineConfig, legacy_config
from repro_torch.engine.faults import FaultPlan
from repro_torch.engine.request import SearchRequest
from repro_torch.engine.store import DocStore
from repro_torch.engine.wal import MutationWAL, WALError
from repro_torch.index_backends import IndexBackend, IndexState, make_backend
from repro_torch.kernels import ops
from repro_torch.obs import (
    NULL_INSTRUMENT,
    MetricsRegistry,
    SlowQueryLog,
    TraceContext,
    TraceRing,
)

Array = torch.Tensor


class UnknownRequest(KeyError):
    """``poll`` was handed a request id the engine never issued."""


class IndexMismatch(ValueError):
    """A `load_index` / `recover` checkpoint disagrees with the live
    engine configuration (backend kind, embedding dim, metric, capacity) —
    raised eagerly instead of a downstream shape failure mid-search."""


class ResultEvicted(KeyError):
    """The request ran, but its result is no longer available.

    Either the client let it sit past the ``max_unpolled`` eviction bound,
    or it was already polled once (results pop), or it was served through
    the async driver's future path (which never parks results).  Distinct
    from ``poll`` returning None — that means "still pending, ask again" —
    and from ``UnknownRequest`` — that means "this id was never issued".
    A slow HTTP client can therefore tell "gone forever" from "bad id".
    """


@dataclasses.dataclass
class RequestStats:
    """Timing breakdown of one completed request."""

    latency_ms: float          # submit -> result ready
    queue_ms: float            # submit -> batch dispatch
    compute_ms: float          # batch dispatch -> device done (shared by batch)
    bucket: int                # static batch size the request rode in
    batch_fill: int            # real requests in that batch (<= bucket)
    compiled: bool             # first dispatch of a new shape (see
                               # RetrievalEngine._dispatch_async)
    # stage-split timings, present only under ``obs.stage_fences`` (the
    # fenced dispatch syncs once at the stage-0 boundary; the default fast
    # path stays fused and reports them as None)
    stage0_ms: Optional[float] = None     # dispatch -> stage-0 scan done
    rescore_ms: Optional[float] = None    # stage-0 done -> rescore done
    # full trace-mark offsets from submit (``TraceContext.spans_ms``);
    # None when ``obs.enabled=False``
    spans: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class RetrievalResult:
    """Top-k neighbours for one request (k == the request's k, which
    defaults to — and never exceeds — ``engine.out_k``)."""

    request_id: int
    scores: np.ndarray         # (out_k,) ascending; +inf marks empty slots
    doc_ids: np.ndarray        # (out_k,) int32; -1 marks empty slots
    stats: RequestStats
    # DocStore.generation at dispatch.  A compaction bumps the generation
    # and remaps doc ids: a client that holds ids across corpus mutations
    # (concurrent serving) can compare this to the live store generation
    # under ``engine.lock`` to detect that its ids predate a remap it missed
    # (results still parked in ``poll`` are remapped by the engine itself).
    store_generation: int = -1
    # served straight from the driver's query cache (no dispatch ran)
    cached: bool = False
    # adaptive-policy pressure level the search ran at (0 = full quality)
    degraded_level: int = 0


# engine counter attribute -> (registry metric name, help text).  The
# attributes stay plain ``stats.n_x += 1`` call sites everywhere;
# ``EngineStats.publish`` mirrors the totals into the bound registry at
# scrape time (collector path), keeping the increment itself lock-free.
_ENGINE_COUNTERS = {
    "n_submitted": ("repro_engine_requests_submitted_total",
                    "Requests accepted via submit/execute_batch"),
    "n_completed": ("repro_engine_requests_completed_total",
                    "Requests completed with a result"),
    "n_batches": ("repro_engine_batches_total", "Batches dispatched"),
    "n_compiles": ("repro_engine_compiles_total",
                   "First dispatches of a new (bucket, capacity, "
                   "shape_key) shape"),
    "n_padded_slots": ("repro_engine_padded_slots_total",
                       "Padding rows dispatched (bucket minus fill)"),
    "n_docs_added": ("repro_engine_docs_added_total", "Documents appended"),
    "n_docs_deleted": ("repro_engine_docs_deleted_total",
                       "Documents tombstoned"),
    "n_rebuilds": ("repro_engine_rebuilds_total",
                   "Index (re)builds adopted"),
    "n_compactions": ("repro_engine_compactions_total",
                      "Store compactions run"),
    "n_rebuild_failures": ("repro_engine_rebuild_failures_total",
                           "Background index builds that raised (retried "
                           "at the next safe point)"),
    "n_recoveries": ("repro_engine_recoveries_total",
                     "Successful recover() runs (snapshot restore + WAL "
                     "replay)"),
    "n_replayed": ("repro_engine_wal_replayed_total",
                   "WAL records replayed across all recoveries"),
}


class EngineStats:
    """Aggregated engine counters + latency distributions.

    Distributions are kept in bounded ring buffers (``window`` most recent
    samples) so a long-lived serving loop doesn't grow memory per request;
    counters are lifetime totals.  ``bind(registry)`` allocates registry
    counters/histograms in a `repro_torch.obs.MetricsRegistry`; the plain int
    attributes stay the source of truth (``summary()`` and every existing
    test read them unchanged, and they keep counting with observability
    disabled) — ``publish()`` mirrors them into the registry from the
    engine's scrape-time collector, so counting costs no registry lock.
    """

    def __init__(self, window: int = 16384) -> None:
        for name in _ENGINE_COUNTERS:
            setattr(self, name, 0)
        self._mirror: Dict[str, object] = {}
        self.h_latency = NULL_INSTRUMENT
        self.h_queue = NULL_INSTRUMENT
        self.h_compute = NULL_INSTRUMENT
        self.h_stage0 = NULL_INSTRUMENT
        self.h_rescore = NULL_INSTRUMENT
        self.h_rebuild = NULL_INSTRUMENT
        self.h_compact = NULL_INSTRUMENT
        self.c_batch_bucket = NULL_INSTRUMENT
        self.latency_ms: Deque[float] = deque(maxlen=window)
        self.queue_ms: Deque[float] = deque(maxlen=window)
        self.compute_ms: Deque[float] = deque(maxlen=window)
        self.bucket_counts: Dict[int, int] = {}

    def bind(self, registry: MetricsRegistry) -> None:
        """Mirror counters into ``registry`` and allocate histograms there
        (no-op instruments when the registry is disabled)."""
        for attr, (metric, help_text) in _ENGINE_COUNTERS.items():
            self._mirror[attr] = registry.counter(metric, help_text)
        self.h_latency = registry.histogram(
            "repro_engine_request_latency_ms",
            "Submit-to-result latency; observes every completed request "
            "(compiles included), so its _count equals "
            "repro_engine_requests_completed_total")
        self.h_queue = registry.histogram(
            "repro_engine_request_queue_ms", "Submit-to-dispatch wait")
        self.h_compute = registry.histogram(
            "repro_engine_batch_compute_ms",
            "Dispatch-to-device-done per batch")
        self.h_stage0 = registry.histogram(
            "repro_engine_stage0_ms",
            "Stage-0 scan span (obs.stage_fences only)")
        self.h_rescore = registry.histogram(
            "repro_engine_rescore_ms",
            "Rescore-ladder span (obs.stage_fences only)")
        self.h_rebuild = registry.histogram(
            "repro_engine_rebuild_ms", "Index build duration")
        self.h_compact = registry.histogram(
            "repro_engine_compact_ms", "Store compaction duration")
        self.c_batch_bucket = registry.counter(
            "repro_engine_batch_bucket_total",
            "Batches dispatched per static bucket size", labels=("bucket",))
        self.publish()

    def publish(self) -> None:
        """Mirror counter totals into the bound registry — called from the
        engine's scrape-time collector, never on the request path (the
        plain ints stay the source of truth)."""
        for attr, c in self._mirror.items():
            c.set_total(getattr(self, attr))
        cb = self.c_batch_bucket
        for bucket, n in self.bucket_counts.items():
            cb.set_total(n, bucket=bucket)

    def record_batch(self, bucket: int, fill: int, compute_ms: float,
                     compiled: bool) -> None:
        self.n_batches += 1
        self.n_padded_slots += bucket - fill
        self.n_compiles += int(compiled)
        self.h_compute.observe(compute_ms)
        if not compiled:
            self.compute_ms.append(compute_ms)
        self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1

    def record_request(self, st: RequestStats) -> None:
        self.record_requests((st,))

    def record_requests(self, sts) -> None:
        """Record a batch's completed requests in one pass — one registry
        lock round-trip per histogram instead of one per request (the
        obs-overhead budget is per-batch, not per-request)."""
        self.n_completed += len(sts)
        # registry histograms observe EVERY completed request — that keeps
        # the scrape invariant latency_ms_count == requests_completed_total
        self.h_latency.observe_many([st.latency_ms for st in sts])
        self.h_queue.observe_many([st.queue_ms for st in sts])
        if sts and sts[0].stage0_ms is not None:
            # batch-uniform: the fence timestamps come from one dispatch
            self.h_stage0.observe_many([st.stage0_ms for st in sts])
            self.h_rescore.observe_many([st.rescore_ms for st in sts])
        for st in sts:
            if st.compiled:
                # compile-inflated latencies would skew steady-state
                # p50/p95; compile events are tracked via n_compiles
                continue
            self.latency_ms.append(st.latency_ms)
            self.queue_ms.append(st.queue_ms)

    @staticmethod
    def _pct(xs, p: float) -> float:
        return float(np.percentile(list(xs), p)) if xs else float("nan")

    def summary(self) -> Dict:
        return {
            "n_submitted": self.n_submitted,
            "n_completed": self.n_completed,
            "n_batches": self.n_batches,
            "n_compiles": self.n_compiles,
            "n_padded_slots": self.n_padded_slots,
            "n_docs_added": self.n_docs_added,
            "n_docs_deleted": self.n_docs_deleted,
            "n_rebuilds": self.n_rebuilds,
            "n_compactions": self.n_compactions,
            "n_rebuild_failures": self.n_rebuild_failures,
            "n_recoveries": self.n_recoveries,
            "n_replayed": self.n_replayed,
            "latency_ms_p50": self._pct(self.latency_ms, 50),
            "latency_ms_p95": self._pct(self.latency_ms, 95),
            "queue_ms_p50": self._pct(self.queue_ms, 50),
            "compute_ms_p50": self._pct(self.compute_ms, 50),
            "bucket_counts": dict(sorted(self.bucket_counts.items())),
        }


class _BackgroundBuild:
    """One-slot background index build: launch, poll, adopt.

    The build thread gets the store's buffers and a stats snapshot taken
    together on the serving thread.  The buffers are updated in place, so
    a backend whose build reads row contents must copy what it needs;
    the flat backend reads none (rows appended mid-build land above the
    snapshot's ``built_size``; deletes are caught by the live validity mask
    at search time).
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._out: Optional[IndexState] = None
        self._err: Optional[BaseException] = None

    @property
    def idle(self) -> bool:
        return self._thread is None

    @property
    def ready(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def launch(self, fn: Callable[[], IndexState]) -> None:
        assert self._thread is None, "build already in flight"
        self._out, self._err = None, None

        def run():
            try:
                self._out = fn()
            except BaseException as e:            # surfaced on take()
                self._err = e

        self._thread = threading.Thread(
            target=run, name="index-rebuild", daemon=True)
        self._thread.start()

    def take(self) -> Optional[IndexState]:
        """Join the finished thread and return its state (or re-raise)."""
        self._thread.join()
        self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        out, self._out = self._out, None
        return out


def _host_float32(vectors) -> np.ndarray:
    """``vectors`` as a float32 host array (one copy off the device for a
    tensor) — the form the WAL logs a batch of rows in."""
    if isinstance(vectors, torch.Tensor):
        return vectors.detach().to("cpu", torch.float32).numpy()
    return np.asarray(vectors, np.float32)


class RetrievalEngine:
    """Progressive-search serving engine over a mutable document corpus."""

    def __init__(
        self,
        d_emb: Optional[int] = None,
        *,
        config: Optional[EngineConfig] = None,
        schedule: Optional[ProgressiveSchedule] = None,
        dtype: torch.dtype = torch.float32,
        backend=None,
        device="cuda",
        **legacy_kwargs,
    ):
        """Construct from a typed ``EngineConfig`` — or the legacy kwargs.

        The blessed surface is ``RetrievalEngine(config=EngineConfig(...))``
        with a typed per-backend block (``FlatConfig``/``IVFConfig``/
        ``QuantizedConfig``).  The legacy keyword form — ``d_emb`` plus any
        of ``d_start``/``k0``/``final_k``/``buckets``/``capacity``/
        ``metric``/``block_n``/``max_unpolled``/``backend``/
        ``backend_opts``/``rebuild_mode``/``compact_dead_frac`` — still
        works: it is folded into the equivalent config through
        `repro_torch.engine.config.legacy_config` (same defaults, now with eager
        option validation), so ``engine.config`` is populated either way.

        ``schedule`` (an explicit ``ProgressiveSchedule`` overriding the
        d_start/k0/final_k derivation), ``dtype`` (device buffer dtype),
        ``device`` (``"cuda"`` by default; ``"cpu"`` runs the plain
        versions) and a pre-constructed ``IndexBackend`` instance as
        ``backend`` remain engine-level arguments — they hold live objects
        and don't serialize.  Without a GPU the default device raises
        instead of moving to the CPU.
        """
        backend_instance: Optional[IndexBackend] = None
        if isinstance(backend, IndexBackend):
            backend_instance, backend = backend, None
            if config is not None:
                raise ValueError(
                    "pass a pre-constructed IndexBackend instance OR a "
                    "config, not both")
            if legacy_kwargs.get("backend_opts") is not None:
                raise ValueError(
                    f"backend_opts {sorted(legacy_kwargs['backend_opts'])} "
                    f"conflict with an already-constructed backend instance")
        if config is None:
            if d_emb is None:
                raise ValueError(
                    "RetrievalEngine needs d_emb (legacy kwargs) or "
                    "config=EngineConfig(...)")
            if backend is not None:
                legacy_kwargs["backend"] = backend
            config = legacy_config(int(d_emb), **legacy_kwargs)
            if backend_instance is not None:
                # the instance itself is wired below; the config records its
                # name only (it may be a user-registered backend the typed
                # config registry has never heard of)
                from repro_torch.engine.config import CustomBackendConfig
                config = dataclasses.replace(
                    config,
                    backend=CustomBackendConfig(backend_instance.name))
        else:
            if legacy_kwargs or backend is not None:
                extra = sorted(legacy_kwargs) + (
                    ["backend"] if backend is not None else [])
                raise ValueError(
                    f"config=EngineConfig(...) conflicts with legacy "
                    f"kwarg(s) {extra}; set them on the config")
            if d_emb is not None and int(d_emb) != config.d_emb:
                raise ValueError(
                    f"d_emb={d_emb} conflicts with config.d_emb="
                    f"{config.d_emb}")
        self.config = config

        self.sched = schedule or make_schedule(
            config.d_start, config.d_emb, config.k0, final_k=config.final_k
        )
        if self.sched.d_max > config.d_emb:
            raise ValueError(
                f"schedule d_max={self.sched.d_max} exceeds "
                f"d_emb={config.d_emb}"
            )
        self.dims = stage_dims(self.sched)
        # actual result width: progressive_search returns stages[-1].k
        # columns (a single-stage schedule keeps k0); slice to final_k so the
        # engine's documented contract holds for every schedule shape
        self.out_k = min(self.sched.final_k, self.sched.stages[-1].k)
        # -- adaptive degradation ladder: one SearchOverrides per pressure
        # level.  A degraded schedule enters the ladder at a LOWER d_start
        # rung (cheaper full-corpus stage-0, same d_max and final_k — the
        # result width never moves), so its stage dims are unioned into
        # self.dims and the store precomputes their sq-prefix columns too
        # (falling back to on-the-fly norms would negate the savings).
        # With adaptive disabled this loop never runs: dims, store layout
        # and every dispatch stay identical to the static path.
        acfg = config.adaptive
        self._level_overrides: Dict[int, SearchOverrides] = {}
        if acfg.enabled:
            all_dims = set(self.dims)
            for lvl in range(1, acfg.levels + 1):
                d_deg = max(acfg.min_d_start,
                            self.sched.d_start >> (lvl * acfg.d_start_shift))
                d_deg = min(d_deg, self.sched.d_start)
                sched_l = None
                if d_deg < self.sched.d_start:
                    sched_l = make_schedule(
                        d_deg, self.sched.d_max, self.sched.k0,
                        final_k=self.sched.final_k)
                    all_dims.update(stage_dims(sched_l))
                self._level_overrides[lvl] = SearchOverrides(
                    level=lvl,
                    n_probe_frac=acfg.n_probe_scale ** lvl,
                    oversample_frac=acfg.oversample_scale ** lvl,
                    sched=sched_l,
                )
            self.dims = tuple(sorted(all_dims))
        self.metric = config.metric
        self.block_n = int(config.block_n)
        self.store = DocStore(config.d_emb, self.dims,
                              capacity=config.capacity, dtype=dtype,
                              device=device)
        self.device = self.store.device
        self.policy = BucketPolicy(config.buckets)
        self.stats = EngineStats()
        # Guards every store/queue/stats mutation and every dispatch: client
        # threads and the async driver thread share the engine through it.
        # Reentrant because step() -> maybe_rebuild() nests, and so callers
        # can compose multi-step critical sections (see EngineDriver).
        self.lock = threading.RLock()
        self._queue = RequestQueue()
        # Completed-but-unpolled results are evicted oldest-first (dicts are
        # insertion-ordered) past max_unpolled, so clients that die between
        # submit() and poll() can't leak memory in a long-lived serving loop
        # (poll() then raises ResultEvicted — distinct from an unknown id).
        self._results: Dict[int, RetrievalResult] = {}
        self._max_unpolled = int(config.max_unpolled)
        self._next_rid = 0
        # queue-path rids not yet parked in _results: lets poll() tell
        # "still pending" (None) from "evicted/consumed" (ResultEvicted)
        self._pending_rids: set = set()
        self._seen_shapes: set = set()

        # -- observability spine: one registry per engine (the driver and
        # HTTP server attach their instruments to it), a bounded ring of
        # recent request traces, and the slow-query log
        obs = config.obs
        self.metrics = MetricsRegistry(enabled=obs.enabled)
        self.stats.bind(self.metrics)
        self.trace_ring = TraceRing(obs.trace_ring)
        self.slow_log = SlowQueryLog(obs.slow_query_ms)
        self._obs_enabled = bool(obs.enabled)
        self._stage_fences = bool(obs.stage_fences and obs.enabled)
        self._c_slow = self.metrics.counter(
            "repro_slow_queries_total",
            "Requests over obs.slow_query_ms (also emitted to the "
            "repro_torch.obs.slowquery logger)")
        self._g_queue_depth = self.metrics.gauge(
            "repro_engine_queue_depth",
            "Requests parked in the engine's own queue")
        self._g_store = self.metrics.gauge(
            "repro_store_state", "DocStore occupancy snapshot",
            labels=("key",))
        self._g_backend = self.metrics.gauge(
            "repro_backend_state",
            "Backend-declared index state gauges (IndexBackend.gauges)",
            labels=("backend", "key"))
        self._c_mask_hits = self.metrics.counter(
            "repro_store_mask_cache_hits_total",
            "Compiled tenant/filter mask cache hits")
        self._c_mask_misses = self.metrics.counter(
            "repro_store_mask_cache_misses_total",
            "Compiled tenant/filter mask cache misses (mask recompiles)")
        self.metrics.register_collector(self._collect_metrics)

        self.backend: IndexBackend = (
            backend_instance if backend_instance is not None
            else make_backend(
                config.backend.name, sched=self.sched, metric=config.metric,
                block_n=self.block_n, device=self.device,
                **config.backend.opts(),
            ))
        if self._level_overrides and self.dims != self.backend.dims:
            # adaptive added degraded-schedule dims: backends look up
            # sq-prefix columns BY VALUE (dims.index), so handing them the
            # store's superset tuple keeps every lookup exact while the
            # degraded stage-0 dims gain precomputed norms too
            self.backend.dims = self.dims
        self.rebuild_mode = config.rebuild_mode
        self.compact_dead_frac = config.compact_dead_frac
        self.on_remap: List[Callable[[np.ndarray], None]] = []
        self._index_state: Optional[IndexState] = None
        self._bg = _BackgroundBuild()
        # states built from pre-compaction buffers hold remapped-away ids;
        # any state older than this store generation must never be adopted
        self._min_state_generation = 0

        # -- fault tolerance: injection plan (inert unless configured), the
        # mutation WAL (None until enable_durability/recover), and the last
        # recovery report
        fcfg = config.fault
        self.faults = FaultPlan.parse(fcfg.inject, seed=fcfg.inject_seed)
        self.wal: Optional[MutationWAL] = None
        self.ckpt_dir: Optional[str] = None
        self.last_recovery: Optional[Dict] = None
        self._rebuild_fail_streak = 0
        self._g_wal = self.metrics.gauge(
            "repro_wal_state",
            "Mutation-WAL state (last_seq / lag_records / n_segments)",
            labels=("key",))

    # -- corpus mutation -----------------------------------------------------
    def add_docs(self, vectors, *, tenant: Optional[str] = None,
                 metadata=None) -> np.ndarray:
        """Append document embeddings; returns their stable doc ids.

        ``vectors`` is a (B, D) numpy array or tensor (a tensor already on
        the engine's device is copied in without a host round trip).
        ``tenant`` namespaces the rows (searches with ``tenant=`` see only
        their own namespace); ``metadata`` — one dict or a per-row sequence
        of dicts — feeds the per-request filter masks.

        With durability enabled the mutation is WAL-logged (fsync'd) BEFORE
        it is applied or acknowledged: a crash after return can never lose
        it, and a crash before the append means the caller never saw an ack.
        The log holds the rows as float32 C-order bytes (a tensor is copied
        to the host once for it).
        """
        with self.lock:
            if self.wal is not None:
                vec = _host_float32(vectors)
                if vec.ndim == 1:
                    vec = vec[None, :]
                if vec.ndim != 2 or vec.shape[1] != self.store.d_emb:
                    raise ValueError(
                        f"expected (B, {self.store.d_emb}) vectors, got "
                        f"shape {vec.shape}")
                # validate metadata BEFORE logging: a record that would be
                # rejected by the store must never enter the log (replay
                # would diverge on it)
                meta_rows = DocStore._check_metadata(metadata, vec.shape[0])
                self.faults.check("wal_write")
                self.wal.append("add", {
                    "start": self.store.size,
                    "v": vec.tobytes(),
                    "shape": list(vec.shape),
                    "tenant": tenant,
                    "metadata": meta_rows,
                })
            ids = self.store.add(vectors, tenant=tenant, metadata=metadata)
            self.stats.n_docs_added += len(ids)
            return ids

    def delete_docs(self, ids) -> int:
        """Tombstone docs by id; they become unreturnable immediately.

        WAL-logged before application, like ``add_docs``."""
        with self.lock:
            if self.wal is not None:
                id_arr = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
                if id_arr.size and (id_arr.min() < 0
                                    or id_arr.max() >= self.store.size):
                    raise IndexError(
                        f"doc ids must be in [0, {self.store.size}), got "
                        f"[{id_arr.min()}, {id_arr.max()}]")
                self.faults.check("wal_write")
                self.wal.append("delete", {"ids": id_arr.tolist()})
            n = self.store.delete(ids)
            self.stats.n_docs_deleted += n
            return n

    @property
    def n_docs(self) -> int:
        with self.lock:
            return self.store.n_active

    # -- index lifecycle -----------------------------------------------------
    def _build_state(self) -> IndexState:
        store = self.store
        self.faults.check("rebuild")
        t0 = time.perf_counter()
        state = self.backend.build(
            store.db, store.valid, sq_prefix=store.sq_prefix,
            stats=store.stats(),
        )
        self.stats.h_rebuild.observe((time.perf_counter() - t0) * 1e3)
        return state

    def _ensure_index(self) -> IndexState:
        if self._index_state is None:
            self._index_state = self._build_state()
            self.stats.n_rebuilds += 1
        return self._index_state

    def _compact(self) -> None:
        """Compact the store and remap every id the engine still holds."""
        if self.wal is not None:
            # compaction is deterministic given the buffers, so the record
            # carries no payload: replay just re-runs store.compact() at
            # the same point in the mutation sequence
            self.wal.append("compact", {})
        t0 = time.perf_counter()
        id_map = self.store.compact()
        self.stats.h_compact.observe((time.perf_counter() - t0) * 1e3)
        self.stats.n_compactions += 1
        self._min_state_generation = self.store.generation
        for res in self._results.values():       # unpolled results follow
            old = res.doc_ids
            res.doc_ids = np.where(
                old >= 0, id_map[np.maximum(old, 0)], -1
            ).astype(old.dtype)
        for cb in self.on_remap:
            cb(id_map)

    def maybe_rebuild(self, *, force: bool = False) -> bool:
        """Rebuild/compact at a safe point if the index state warrants it.

        Called automatically before every dispatch (``step`` /
        ``execute_batch`` / ``search`` / ``warmup``) — under the async driver
        this is what makes rebuild adoption and compaction land *between*
        driver iterations, never mid-batch.  Callable directly to force a
        rebuild.  Returns True if a new state was adopted (or a background
        build launched).
        """
        with self.lock:
            return self._maybe_rebuild_locked(force=force)

    def _maybe_rebuild_locked(self, *, force: bool = False) -> bool:
        # adopt a finished background build first — cheap, and it may
        # satisfy the staleness check below
        adopted = False
        if self._bg.ready:
            try:
                new = self._bg.take()
            except Exception as e:
                # a failed background build must not fail the innocent
                # batch that happened to hit this safe point: count it,
                # leave the old state serving, and let the staleness check
                # below relaunch.  Only a persistent crash loop escalates.
                self.stats.n_rebuild_failures += 1
                self._rebuild_fail_streak += 1
                if (self._rebuild_fail_streak
                        > self.config.fault.rebuild_retries):
                    raise RuntimeError(
                        f"background index rebuild failed "
                        f"{self._rebuild_fail_streak} times in a row"
                    ) from e
                new = None
            else:
                if new is not None:
                    self._rebuild_fail_streak = 0
            # never adopt a state older than what is already serving: a
            # must/forced sync rebuild may have landed while the thread ran
            # (and compaction bumps the floor: pre-compaction ids are dead)
            if (new is not None
                    and new.generation >= self._min_state_generation
                    and (self._index_state is None
                         or new.generation > self._index_state.generation)):
                self._index_state = new
                self.stats.n_rebuilds += 1
                adopted = True

        # incremental maintenance first: backends that can absorb appended
        # rows into the live index (IVF nearest-centroid spare slots) do it
        # here, at the same safe point — absorbed rows stop counting against
        # the tail window, so the staleness checks below see the post-absorb
        # load and append-heavy workloads stop forcing early rebuilds
        if self._index_state is not None:
            store = self.store
            self.backend.absorb_appends(
                self._index_state, store.db, store.valid,
                sq_prefix=store.sq_prefix, stats=store.stats(),
            )

        st = self.store.stats()
        state = self._index_state
        must = state is not None and self.backend.must_rebuild(state, st)
        stale = (state is None or must
                 or self.backend.needs_rebuild(state, st))
        wants_compact = (
            self.compact_dead_frac is not None
            and st.n_dead > 0
            and st.dead_frac >= self.compact_dead_frac
        )
        if self.rebuild_mode == "off" and not (must or state is None or force):
            return adopted
        if not (force or stale or wants_compact):
            return adopted

        if wants_compact:
            # compaction invalidates every id a pre-compaction state holds:
            # it must pair with an immediate synchronous rebuild.  The
            # rebuild lives in a finally so a raising on_remap callback
            # cannot leave the old state serving remapped buffers (it would
            # silently return wrong documents); the callback's exception
            # still propagates to the caller afterwards.
            self._index_state = None
            try:
                self._compact()
            finally:
                self._index_state = self._build_state()
                self.stats.n_rebuilds += 1
            return True
        if state is None:
            self._ensure_index()                  # first build is sync
            return True
        if self.rebuild_mode == "background" and not must and not force:
            if self._bg.idle:
                # snapshot on THIS thread so (buffers, stats) are a
                # consistent pair even if the corpus mutates mid-build
                store = self.store
                db, valid = store.db, store.valid
                sq, snap = store.sq_prefix, store.stats()
                h_rebuild = self.stats.h_rebuild

                def _bg_build():
                    self.faults.check("rebuild")
                    t0 = time.perf_counter()
                    state = self.backend.build(
                        db, valid, sq_prefix=sq, stats=snap)
                    h_rebuild.observe((time.perf_counter() - t0) * 1e3)
                    return state

                self._bg.launch(_bg_build)
                return True
            return adopted                        # build already in flight
        # sync (or correctness-mandated while a background build lags)
        self._index_state = self._build_state()
        self.stats.n_rebuilds += 1
        return True

    @property
    def index_state(self) -> Optional[IndexState]:
        """The live index state (None until the first build)."""
        return self._index_state

    # -- index persistence ---------------------------------------------------
    def save_index(self, ckpt_dir: str, *, keep: int = 3) -> str:
        """Persist the live index state through `repro_torch.checkpoint`.

        Writes the backend's ``state_dict`` (centroids, packed member
        slabs, int8 scales, PQ codebooks — whatever the backend built)
        with the atomic tmp-dir + fsynced-manifest protocol, so a serving
        restart can `load_index` instead of re-running k-means / codebook
        builds.  Builds the index first if none is live yet.
        """
        from repro_torch.checkpoint import save_arrays

        with self.lock:
            state = self._ensure_index()
            payload = self.backend.state_dict(state)
            extra = dict(payload["meta"])
            extra["engine_meta"] = self._index_meta()
            return save_arrays(
                ckpt_dir, state.generation, payload["arrays"],
                extra=extra, keep=keep)

    def _index_meta(self) -> Dict:
        """The engine-identity fingerprint recorded next to persisted index
        state, so a restart with a different configuration fails loudly."""
        return {
            "backend": self.backend.name,
            "d_emb": self.store.d_emb,
            "capacity": self.store.capacity,
            "metric": self.metric,
        }

    def _check_index_meta(self, saved: Optional[Dict], where: str,
                          keys: Tuple[str, ...] = ("backend", "d_emb",
                                                   "metric"),
                          ) -> None:
        """Raise ``IndexMismatch`` when ``saved`` (an ``engine_meta`` dict)
        disagrees with the live engine.  Only identity keys are compared —
        ``capacity`` rides along in the meta for diagnostics but is a
        dynamic buffer size (it doubles with corpus growth; restore adopts
        the snapshot's), not identity.  Pre-``engine_meta`` checkpoints
        (saved is None) skip the check for back-compat."""
        if not saved:
            return
        live = self._index_meta()
        diffs = [
            f"{key}: checkpoint has {saved[key]!r}, engine has "
            f"{live[key]!r}"
            for key in keys
            if key in saved and saved[key] != live[key]
        ]
        if diffs:
            raise IndexMismatch(
                f"{where} does not match the live EngineConfig — "
                + "; ".join(diffs))

    def load_index(self, ckpt_dir: str, *, step: Optional[int] = None) -> bool:
        """Adopt a `save_index` checkpoint as the live index state.

        Contract: the store must already hold the same rows
        ``[0, built_size)`` the checkpoint was built over (the usual
        serving restart re-adds the identical corpus before loading).
        Rows added beyond that ride the tail window exactly like rows
        appended after a build; staleness counters restart clean.  Returns
        False when ``ckpt_dir`` holds no checkpoint; raises
        ``IndexMismatch`` when the checkpoint was saved under a different
        backend kind / embedding dim / capacity / metric, and
        ``CorruptCheckpoint`` when the newest step fails verification.
        """
        from repro_torch.checkpoint import load_arrays

        arrays, meta, _ = load_arrays(ckpt_dir, step=step)
        if arrays is None:
            return False
        with self.lock:
            self._check_index_meta(meta.get("engine_meta"),
                                   f"index checkpoint in {ckpt_dir}")
            store = self.store
            state = self.backend.load_state(
                {"meta": meta, "arrays": arrays},
                db=store.db, valid=store.valid, sq_prefix=store.sq_prefix,
                stats=store.stats(),
            )
            self._index_state = state
            return True

    # -- durability: WAL + snapshots + crash recovery ------------------------
    def enable_durability(self, ckpt_dir: str) -> None:
        """Open (or create) the mutation WAL under ``ckpt_dir/wal``.

        From this point every ``add_docs`` / ``delete_docs`` / compaction
        is logged-then-applied, so ``recover(ckpt_dir)`` in a fresh process
        reconstructs the acknowledged corpus exactly.  ``recover`` calls
        this implicitly; call it directly on a brand-new deployment.
        """
        with self.lock:
            if self.wal is not None:
                return
            os.makedirs(ckpt_dir, exist_ok=True)
            self.ckpt_dir = ckpt_dir
            self.wal = MutationWAL(
                os.path.join(ckpt_dir, "wal"),
                fsync=self.config.fault.wal_fsync)

    def save_snapshot(self, *, keep: Optional[int] = None) -> str:
        """Durably snapshot store + index state; rotate and prune the WAL.

        The snapshot captures the corpus at WAL seq S (its step number IS
        S + 1, so steps are unique and monotonic across restarts); recovery
        restores the newest valid snapshot and replays records with
        ``seq > S``.  Old WAL segments are pruned only past the *oldest
        retained* snapshot, so a torn-newest fallback still replays.
        """
        from repro_torch.checkpoint import all_steps, save_arrays

        with self.lock:
            if self.wal is None or self.ckpt_dir is None:
                raise RuntimeError(
                    "durability is not enabled — call "
                    "enable_durability(ckpt_dir) or recover(ckpt_dir) first")
            self.faults.check("ckpt_save")
            keep = self.config.fault.snapshot_keep if keep is None else keep
            wal_seq = self.wal.last_seq
            store_arrays, store_meta = self.store.snapshot_state()
            arrays = {f"store/{k}": v for k, v in store_arrays.items()}
            extra: Dict = {
                "wal_seq": wal_seq,
                "store_meta": store_meta,
                "engine_meta": self._index_meta(),
            }
            state = self._index_state
            if state is not None:
                payload = self.backend.state_dict(state)
                arrays.update(
                    {f"index/{k}": v for k, v in payload["arrays"].items()})
                extra["index_meta"] = payload["meta"]
            # step number = wal seq + 1 so the empty-log snapshot (seq -1)
            # still gets a valid step 0
            path = save_arrays(self.ckpt_dir, wal_seq + 1, arrays,
                               extra=extra, keep=keep)
            self.wal.rotate()
            steps = all_steps(self.ckpt_dir)
            if steps:
                self.wal.prune(min(steps) - 1)
            return path

    def recover(self, ckpt_dir: str) -> Dict:
        """Restore state from ``ckpt_dir``: newest valid snapshot + WAL tail.

        Walks snapshots newest-to-oldest, skipping any that fail checksum
        verification (``CorruptCheckpoint``); restores the store and index
        from the first valid one; then replays every WAL record past that
        snapshot's sequence number.  A torn WAL tail (crash mid-append)
        truncates cleanly — the lost suffix was never acknowledged.  Leaves
        durability enabled and returns a report dict (also kept as
        ``engine.last_recovery``).  The directory may have been written by
        either package.
        """
        t0 = time.perf_counter()
        with self.lock:
            self.faults.check("ckpt_load")
            report: Dict = {
                "status": "ok", "snapshot_step": None, "fallbacks": 0,
                "replayed": 0, "wal_truncated": False, "duration_ms": 0.0,
            }
            wal_seq = self._restore_newest_snapshot(ckpt_dir, report)
            # open the WAL (truncating any torn tail) and replay the rest
            os.makedirs(ckpt_dir, exist_ok=True)
            self.ckpt_dir = ckpt_dir
            self.wal = MutationWAL(
                os.path.join(ckpt_dir, "wal"),
                fsync=self.config.fault.wal_fsync)
            for rec in self.wal.replay(after_seq=wal_seq):
                self._apply_record(rec)
                report["replayed"] += 1
            report["wal_truncated"] = self.wal.torn_tail
            report["duration_ms"] = (time.perf_counter() - t0) * 1e3
            self.stats.n_recoveries += 1
            self.stats.n_replayed += report["replayed"]
            self.last_recovery = report
            return report

    def _restore_newest_snapshot(self, ckpt_dir: str, report: Dict) -> int:
        """Restore store + index from the newest checksum-valid snapshot
        under ``ckpt_dir`` (corrupt snapshots fall back a step).

        Shared by ``recover`` (primary restart) and the replication
        follower bootstrap — the follower restores read-only and must NOT
        open the WAL, so this helper deliberately touches neither
        ``self.wal`` nor ``self.ckpt_dir``.  Mutates ``report``
        (``snapshot_step`` / ``fallbacks``) and returns the snapshot's WAL
        seq, -1 when no usable snapshot exists.  Caller holds the lock.
        """
        from repro_torch.checkpoint import (CorruptCheckpoint, all_steps,
                                            load_arrays)

        loaded = None
        for step in sorted(all_steps(ckpt_dir), reverse=True):
            try:
                arrays, extra, _ = load_arrays(ckpt_dir, step=step)
            except CorruptCheckpoint:
                report["fallbacks"] += 1
                continue
            loaded = (step, arrays, extra)
            break
        if loaded is None:
            return -1
        step, arrays, extra = loaded
        # capacity is NOT checked here: restore_state adopts the
        # snapshot's buffer capacity, so only identity keys matter
        self._check_index_meta(extra.get("engine_meta"),
                               f"snapshot step {step} in {ckpt_dir}",
                               keys=("backend", "d_emb", "metric"))
        store_arrays = {
            k[len("store/"):]: v for k, v in arrays.items()
            if k.startswith("store/")}
        self.store.restore_state(store_arrays, extra["store_meta"])
        self._index_state = None
        self._min_state_generation = 0
        index_arrays = {
            k[len("index/"):]: v for k, v in arrays.items()
            if k.startswith("index/")}
        if index_arrays and "index_meta" in extra:
            self._index_state = self.backend.load_state(
                {"meta": extra["index_meta"],
                 "arrays": index_arrays},
                db=self.store.db, valid=self.store.valid,
                sq_prefix=self.store.sq_prefix,
                stats=self.store.stats(),
            )
        report["snapshot_step"] = step
        return int(extra["wal_seq"])

    def apply_replicated(self, rec) -> None:
        """Apply one WAL record shipped from a primary (follower path).

        Goes through the exact same ``_apply_record`` used by crash
        recovery — tail injection, capacity doubling, and rebuild
        scheduling all behave as if the mutation happened locally — but is
        never re-logged: a follower must not own a WAL over the primary's
        log directory (it would truncate or extend the live segment).
        """
        with self.lock:
            if self.wal is not None:
                raise WALError(
                    "apply_replicated on an engine with its own WAL open — "
                    "followers replicate, they do not log")
            self._apply_record(rec)

    def _apply_record(self, rec) -> None:
        """Re-apply one WAL record during recovery (never re-logged)."""
        store = self.store
        if rec.kind == "add":
            p = rec.payload
            if int(p["start"]) != store.size:
                raise WALError(
                    f"WAL replay divergence at seq {rec.seq}: record "
                    f"expects start id {p['start']}, store is at "
                    f"{store.size}")
            # a writable copy (torch warns on a read-only numpy buffer)
            vec = np.frombuffer(p["v"], np.float32).reshape(p["shape"]).copy()
            meta_rows = p.get("metadata")
            store.add(vec, tenant=p.get("tenant"), metadata=meta_rows)
            self.stats.n_docs_added += int(p["shape"][0])
        elif rec.kind == "delete":
            n = store.delete(np.asarray(rec.payload["ids"], np.int64))
            self.stats.n_docs_deleted += n
        elif rec.kind == "compact":
            # a replayed compaction invalidates any snapshot-loaded index
            # state (its ids predate the remap); the next dispatch rebuilds
            store.compact()
            self.stats.n_compactions += 1
            self._index_state = None
            self._min_state_generation = store.generation
        else:
            raise WALError(
                f"unknown WAL record kind {rec.kind!r} at seq {rec.seq}")

    # -- request path --------------------------------------------------------
    def check_query(self, query) -> np.ndarray:
        """Validate/normalize one query to a (D,) float32 vector (no lock)."""
        q = np.asarray(query, np.float32)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]
        if q.ndim != 1 or q.shape[0] != self.store.d_emb:
            raise ValueError(
                f"expected one (D={self.store.d_emb},) query vector, got "
                f"shape {q.shape}"
            )
        return q

    def check_request(self, request) -> PendingRequest:
        """Validate a raw query vector or `SearchRequest` into an unstamped
        ``PendingRequest`` (no lock; request_id assigned at enqueue).

        This is the one normalization point for the typed request surface —
        the engine's own ``submit``/``search`` and the async driver both
        route through it, so a raw array behaves exactly like
        ``SearchRequest(query)`` everywhere.
        """
        if not isinstance(request, SearchRequest):
            request = SearchRequest(request)
        q = self.check_query(request.query)
        k = self.out_k if request.k is None else int(request.k)
        if not 1 <= k <= self.out_k:
            raise ValueError(
                f"k={k} outside [1, {self.out_k}]; the engine dispatches a "
                f"static result width — configure final_k for the largest "
                f"k it should serve")
        mask_key = self.store.compile_mask(request.tenant, request.filter)
        now = time.perf_counter()
        deadline = (None if request.deadline_ms is None
                    else now + float(request.deadline_ms) / 1e3)
        trace = TraceContext(now) if self._obs_enabled else None
        return PendingRequest(-1, q, now, k=k, mask_key=mask_key,
                              deadline=deadline, trace=trace)

    def submit(self, request) -> int:
        """Enqueue one request — a raw (D,)/(1, D) query vector or a
        `SearchRequest` carrying per-request k/tenant/filter — and return a
        request id for ``poll``.  (The async driver does not pass through
        here — it forms its own batches and enters via ``execute_batch``,
        stamping each request's client-side submit time itself.)"""
        req = self.check_request(request)
        with self.lock:
            req.request_id = self._next_rid
            self._next_rid += 1
            self._queue.push(req)
            if req.trace is not None:
                req.trace.mark("admit")
            self._pending_rids.add(req.request_id)
            self.stats.n_submitted += 1
            return req.request_id

    def poll(self, request_id: int) -> Optional[RetrievalResult]:
        """Pop the result for ``request_id`` if its batch has run.

        Returns None while the request is still pending.  Raises
        ``UnknownRequest`` for an id the engine never issued, and
        ``ResultEvicted`` for one whose result is gone — evicted past
        ``max_unpolled``, already polled (results pop once), or served
        through the driver's future path.  A slow client can therefore
        distinguish "ask again" (None) from "gone forever" from "bad id".
        """
        with self.lock:
            res = self._results.pop(request_id, None)
            if res is not None:
                return res
            if not 0 <= int(request_id) < self._next_rid:
                raise UnknownRequest(
                    f"request id {request_id} was never issued "
                    f"(ids so far: [0, {self._next_rid}))")
            if request_id in self._pending_rids:
                return None
            raise ResultEvicted(
                f"request {request_id} has no parked result: it was "
                f"evicted, already polled, or driver-served")

    @property
    def n_pending(self) -> int:
        with self.lock:
            return len(self._queue)

    def _execute(self, reqs: List[PendingRequest],
                 overrides: Optional[SearchOverrides] = None,
                 ) -> List[RetrievalResult]:
        """Run one bucket-shaped batch (caller holds ``self.lock``).

        Every request in the chunk must share one ``mask_key`` — the batch
        dispatches with a single row bitmask AND-ed into the validity mask.
        ``step``/``execute_batch`` group by key before calling here.
        ``overrides`` (adaptive policy) degrades the whole batch's search
        knobs; ``None`` is the static full-quality path.
        """
        self._maybe_rebuild_locked()              # safe point between batches
        # build the mask AFTER the rebuild safe point: appends/compaction
        # already landed, so it matches the buffers this dispatch will scan
        mask = self.store.mask_for_key(reqs[0].mask_key)
        bucket = self.policy.bucket_for(len(reqs))
        t_dispatch = time.perf_counter()
        qb = pad_batch(np.stack([r.query for r in reqs]), bucket)
        if self._stage_fences:
            scores, ids, compiled, t_stage0 = self._dispatch_fenced(
                qb, mask=mask, overrides=overrides)
        else:
            scores, ids, compiled = self._dispatch(
                qb, mask=mask, overrides=overrides)
            t_stage0 = None
        t_done = time.perf_counter()
        compute_ms = (t_done - t_dispatch) * 1e3
        stage0_ms = (None if t_stage0 is None
                     else (t_stage0 - t_dispatch) * 1e3)
        rescore_ms = (None if t_stage0 is None
                      else (t_done - t_stage0) * 1e3)
        self.stats.record_batch(bucket, len(reqs), compute_ms, compiled)
        out = []
        sts = []
        records = []
        for j, r in enumerate(reqs):
            spans = None
            if r.trace is not None:
                # inline span build (pipeline order): this loop runs per
                # request under engine.lock, so it stays call-free —
                # dispatch/deliver go straight into the spans dict instead
                # of through mark()/spans_ms()
                m = r.trace.marks
                t0_req = m["submit"]
                spans = {"submit": 0.0}
                t = m.get("admit")
                if t is not None:
                    spans["admit"] = (t - t0_req) * 1e3
                t = m.get("batch")
                if t is not None:
                    spans["batch"] = (t - t0_req) * 1e3
                spans["dispatch"] = (t_dispatch - t0_req) * 1e3
                if t_stage0 is not None:
                    spans["stage0"] = (t_stage0 - t0_req) * 1e3
                    spans["rescore"] = (t_done - t0_req) * 1e3
                spans["deliver"] = (t_done - t0_req) * 1e3
            st = RequestStats(
                latency_ms=(t_done - r.t_submit) * 1e3,
                queue_ms=(t_dispatch - r.t_submit) * 1e3,
                compute_ms=compute_ms,
                bucket=bucket,
                batch_fill=len(reqs),
                compiled=compiled,
                stage0_ms=stage0_ms,
                rescore_ms=rescore_ms,
                spans=spans,
            )
            sts.append(st)
            k = self.out_k if r.k is None else r.k
            out.append(RetrievalResult(
                r.request_id, scores[j][:k], ids[j][:k], st,
                store_generation=self.store.generation,
                degraded_level=0 if overrides is None else overrides.level,
            ))
            if spans is not None:
                records.append({
                    "request_id": r.request_id,
                    "latency_ms": st.latency_ms,
                    "queue_ms": st.queue_ms,
                    "compute_ms": compute_ms,
                    "bucket": bucket,
                    "batch_fill": len(reqs),
                    "compiled": compiled,
                    "spans": spans,
                })
        self.stats.record_requests(sts)
        if records:
            self.trace_ring.push_many(records)
            if self.slow_log.enabled:
                n_slow = sum(self.slow_log.maybe_log(rec)
                             for rec in records)
                if n_slow:
                    self._c_slow.inc(n_slow)
        return out

    def step(self) -> int:
        """Dispatch one bucket-shaped batch from the queue head.

        Requests sharing the head's (tenant, filter) mask key batch
        together; others stay queued for the next ``step`` in arrival
        order.  Returns the number of requests completed (0 if the queue
        is empty).
        """
        with self.lock:
            n = len(self._queue)
            if n == 0:
                return 0
            bucket = self.policy.bucket_for(min(n, self.policy.max_size))
            reqs = self._queue.pop_group(min(n, bucket))
            if self._obs_enabled:
                t_batch = time.perf_counter()
                for r in reqs:
                    if r.trace is not None:
                        r.trace.marks["batch"] = t_batch
            for res in self._execute(reqs):
                self._results[res.request_id] = res
                self._pending_rids.discard(res.request_id)
            while len(self._results) > self._max_unpolled:
                self._results.pop(next(iter(self._results)))
            return len(reqs)

    def execute_batch(
        self, reqs: Sequence[PendingRequest],
        overrides: Optional[SearchOverrides] = None,
    ) -> List[RetrievalResult]:
        """Dispatch pre-formed requests immediately, bypassing the queue.

        The async driver's entry point: its requests already waited out the
        deadline policy in the driver's own queue, so they dispatch now —
        split into consecutive same-``mask_key`` runs (each run shares one
        filter bitmask; the driver's batch formation already groups, so a
        mixed chunk only costs extra dispatches, never reorders results)
        and along the bucket ladder when a run exceeds the top bucket.
        Results return in request order and are never parked in the
        ``poll`` map — the driver resolves its futures directly, so the
        ``max_unpolled`` eviction can't drop them.  Requests with a negative
        ``request_id`` are assigned the next engine id.
        """
        # fault site OUTSIDE the lock: an injected hang here wedges only
        # this thread, so a supervised replacement driver can still dispatch
        self.faults.check("dispatch", queries=[r.query for r in reqs])
        out: List[RetrievalResult] = []
        with self.lock:
            fresh = sum(1 for r in reqs if r.request_id < 0)
            for r in reqs:
                if r.request_id < 0:
                    r.request_id = self._next_rid
                    self._next_rid += 1
            # count only first-time requests: a bisection retry re-enters
            # with its engine id already assigned and must not inflate the
            # submitted/completed reconciliation
            self.stats.n_submitted += fresh
            off = 0
            while off < len(reqs):
                chunk = [reqs[off]]
                off += 1
                while (off < len(reqs)
                       and len(chunk) < self.policy.max_size
                       and reqs[off].mask_key == chunk[0].mask_key):
                    chunk.append(reqs[off])
                    off += 1
                out.extend(self._execute(chunk, overrides=overrides))
        return out

    def run_until_idle(self) -> int:
        """Drain the whole queue; returns total requests completed."""
        done = 0
        while self.n_pending:
            done += self.step()
        return done

    def warmup(self) -> None:
        """Dispatch every bucket shape once at the current corpus capacity.

        Call after (re)building the corpus and before measuring latency:
        first dispatches (kernel build and load, allocator growth) are
        excluded from the stats percentiles, and warming here keeps them
        off the serving path.  Idempotent; cheap when every shape has
        already run.
        """
        with self.lock:
            self._maybe_rebuild_locked()
            probe = np.zeros((1, self.store.d_emb), np.float32)
            # warm the static path AND every adaptive degradation level:
            # each level is one more shape key per bucket, so pressure
            # transitions never hit a first dispatch
            for ov in (None, *self._level_overrides.values()):
                for b in self.policy.sizes:
                    qb = np.repeat(probe, b, axis=0)
                    # warm whichever dispatch path requests actually take
                    if self._stage_fences:
                        self._dispatch_fenced(qb, overrides=ov)
                    else:
                        self._dispatch(qb, overrides=ov)

    # -- synchronous batch API (pipeline / benchmarks) ------------------------
    def search(self, queries, *, k: Optional[int] = None,
               tenant: Optional[str] = None,
               filter: Optional[Dict] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Bucketed search for a (B, D) query batch, bypassing the queue.

        ``k``/``tenant``/``filter`` apply to the whole batch (the
        per-request variants ride `SearchRequest` through ``submit``).
        With the default ``flat`` backend and no filter, results are
        identical to calling ``progressive_search`` directly on the live
        corpus (padding queries are per-query-independent and sliced off);
        the ``ivf`` and ``quantized`` backends return their approximate
        results (stage 0 over probed lists or coded rows), exactly as the
        queued request path would.
        """
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.store.d_emb:
            raise ValueError(
                f"query dim {q.shape[1]} != corpus dim {self.store.d_emb}"
            )
        out_k = self.out_k if k is None else int(k)
        if not 1 <= out_k <= self.out_k:
            raise ValueError(f"k={k} outside [1, {self.out_k}]")
        mask_key = self.store.compile_mask(tenant, filter)
        if q.shape[0] == 0:
            return (np.zeros((0, out_k), np.float32),
                    np.zeros((0, out_k), np.int32))
        with self.lock:
            self._maybe_rebuild_locked()          # safe point: whole batch
            mask = self.store.mask_for_key(mask_key)
            # Overlap: issue every chunk's dispatch before syncing any of
            # them — the device runs them back-to-back on the stream while
            # the host keeps padding and enqueueing (only step() needs a
            # per-batch sync, for timing).
            pend = []
            off = 0
            for bucket in self.policy.plan(q.shape[0]):
                take = min(bucket, q.shape[0] - off)
                s, i, _ = self._dispatch_async(
                    pad_batch(q[off:off + take], bucket), mask=mask)
                pend.append((s, i, take))
                off += take
        out_s = [s[:take, :out_k].cpu().numpy() for s, _, take in pend]
        out_i = [i[:take, :out_k].cpu().numpy() for _, i, take in pend]
        return np.concatenate(out_s), np.concatenate(out_i)

    def overrides_for_level(self, level: int) -> Optional[SearchOverrides]:
        """Degradation knobs for an adaptive pressure level (None for
        level 0 / adaptive disabled; deeper-than-configured levels clamp
        to the deepest configured one)."""
        if level <= 0 or not self._level_overrides:
            return None
        return self._level_overrides.get(
            min(level, max(self._level_overrides)))

    def cache_stamp(self) -> Tuple[int, int, int]:
        """The query cache's staleness stamp: (store generation, mask
        epoch, rebuild count) read atomically under ``engine.lock``.  Any
        component moving invalidates every cached result."""
        with self.lock:
            return (self.store.generation, self.store.mask_epoch,
                    self.stats.n_rebuilds)

    def _dispatch_async(self, q_pad: np.ndarray, mask=None, overrides=None):
        """Hand one padded bucket to the backend; returns device tensors
        without forcing a sync (the caller decides when to block).

        ``compiled`` in the result means "first dispatch of a new (bucket,
        capacity, shape_key, overrides) shape": the host-side key set that
        attributes one-time set-up cost (kernel build and load, allocator
        growth) to the dispatch that paid it.

        ``mask`` is a compiled (capacity,) tenant/metadata bitmask — it is
        AND-ed into the store's validity mask here, and that single AND is
        the entire filtered-search integration: every backend already
        treats a cleared validity bit as "unreturnable", so no backend
        grows any filter code (the mask is data, not shape).
        """
        store = self.store
        state = self._ensure_index()
        shape_key = (q_pad.shape[0], store.capacity, state.shape_key,
                     overrides)
        compiled = shape_key not in self._seen_shapes
        self._seen_shapes.add(shape_key)
        valid = (store.valid if mask is None
                 else torch.logical_and(store.valid, mask))
        # overrides passed only when set: pre-existing custom backends that
        # never heard of the kwarg keep working on the static path
        kw = {} if overrides is None else {"overrides": overrides}
        s, i = self.backend.search(
            self._to_device(q_pad), state, store.db, valid,
            sq_prefix=store.sq_prefix,
            n_total=store.size,
            k=self.out_k,
            **kw,
        )
        return s, i, compiled

    def _to_device(self, q_pad: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(q_pad)).to(self.device)

    def _sync(self) -> None:
        """Wait for the device (the fence of ``obs.stage_fences``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch(self, q_pad: np.ndarray, mask=None, overrides=None):
        s, i, compiled = self._dispatch_async(q_pad, mask=mask,
                                              overrides=overrides)
        return s.cpu().numpy(), i.cpu().numpy(), compiled

    def _dispatch_fenced(self, q_pad: np.ndarray, mask=None, overrides=None):
        """Dispatch with a device-sync fence at the stage-0 boundary
        (``obs.stage_fences``), so the stage-0 / rescore split is
        measurable.  Two device round trips instead of one — an opt-in
        diagnostic path with its own shape keys (the ``"fenced"`` tag keeps
        them apart from the default path's).
        Returns (scores, ids, compiled, t_stage0)."""
        store = self.store
        state = self._ensure_index()
        shape_key = ("fenced", q_pad.shape[0], store.capacity,
                     state.shape_key, overrides)
        compiled = shape_key not in self._seen_shapes
        self._seen_shapes.add(shape_key)
        valid = (store.valid if mask is None
                 else torch.logical_and(store.valid, mask))
        marks: Dict[str, float] = {}

        def fence(arrays) -> None:
            self._sync()
            marks["stage0"] = time.perf_counter()

        kw = {} if overrides is None else {"overrides": overrides}
        s, i = self.backend.search_fenced(
            self._to_device(q_pad), state, store.db, valid,
            sq_prefix=store.sq_prefix,
            n_total=store.size,
            k=self.out_k,
            fence=fence,
            **kw,
        )
        return (s.cpu().numpy(), i.cpu().numpy(), compiled,
                marks.get("stage0"))

    # -- observability --------------------------------------------------------
    def _collect_metrics(self) -> None:
        """Scrape-time collector: counter totals + point-in-time gauges
        under ``engine.lock``.

        Registered on ``self.metrics``; runs only when something renders
        the registry (never per request).  Lock order is engine.lock ->
        registry lock — the same order every hot-path instrument uses, so
        a scrape can never deadlock against a dispatch.
        """
        with self.lock:
            store = self.store
            self.stats.publish()
            self._g_queue_depth.set(float(len(self._queue)))
            # the store keeps plain ints under engine.lock; mirror the
            # lifetime totals instead of double-counting increments
            self._c_mask_hits.set_total(store.mask_cache_hits)
            self._c_mask_misses.set_total(store.mask_cache_misses)
            st = store.stats()
            for key, val in (
                ("size", st.size), ("n_active", st.n_active),
                ("n_dead", st.n_dead), ("capacity", st.capacity),
                ("generation", st.generation),
                ("total_added", st.total_added),
                ("total_deleted", st.total_deleted),
            ):
                self._g_store.set(float(val), key=key)
            state = self._index_state
            if state is not None:
                for key, val in self.backend.gauges(state, st).items():
                    self._g_backend.set(
                        float(val), backend=self.backend.name, key=key)
            if self.wal is not None:
                w = self.wal.summary()
                for key in ("last_seq", "lag_records", "n_segments"):
                    self._g_wal.set(float(w[key]), key=key)

    def profile_stages(self, queries, *, runs: int = 3) -> List[Dict]:
        """Per-stage wall time for a representative batch (post-warmup).

        Runs the schedule stage by stage (stage-0 full scan, then each
        rescore) so the cost split across dims is visible — the one-launch
        ladder hides it.  Always profiles the flat schedule path regardless
        of the configured backend: it answers "where does the schedule
        spend", not "what does this backend cost".  Each stage goes through
        `repro_torch.kernels.ops`, so on CUDA stage 0 is one stage-0 kernel
        launch and every later stage one ``gather_rescore_topk`` step; each
        run is timed between two device synchronisations.
        """
        q = self._to_device(np.atleast_2d(np.asarray(queries, np.float32)))
        store = self.store
        block_n = min(self.block_n, store.capacity)
        dims_t = self.dims
        out = []
        cand = None
        for si, stage in enumerate(self.sched.stages):
            col = dims_t.index(stage.dim)

            if si == 0:
                def fn(c=None, _s=stage):
                    return ops.truncated_search(
                        q, store.db, dim=_s.dim, k=_s.k,
                        db_sq_at_dim=store.sq_prefix[:, col],
                        valid=store.valid, block_n=block_n,
                        metric=self.metric,
                    )
            else:
                def fn(c=cand, _s=stage):
                    return ops.rescore_candidates(
                        q, store.db, c, dim=_s.dim, k=_s.k,
                        db_sq_at_dim=store.sq_prefix[:, col],
                        valid=store.valid, metric=self.metric,
                    )
            res = fn()                          # warm-up
            self._sync()
            ts = []
            for _ in range(runs):
                t0 = time.perf_counter()
                res = fn()
                self._sync()
                ts.append(time.perf_counter() - t0)
            cand = res[1]
            out.append({
                "stage": si,
                "dim": stage.dim,
                "k": stage.k,
                "pool": stage.pool,
                "ms": float(np.median(ts) * 1e3),
            })
        return out

    def describe(self) -> str:
        return (
            f"RetrievalEngine(docs={self.store.n_active}/"
            f"cap={self.store.capacity}, buckets={self.policy.sizes}, "
            f"metric={self.metric}, backend={self.backend.describe()}, "
            f"rebuild={self.rebuild_mode}, sched: {self.sched.describe()})"
        )
