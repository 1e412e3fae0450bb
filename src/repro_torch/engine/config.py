"""Typed engine/backend configuration: eager validation + serialization.

This module replaces the stringly-typed ``RetrievalEngine(backend="ivf",
backend_opts={...})`` surface (and the engine's 18-kwarg ``__init__``) with
config dataclasses:

    cfg = EngineConfig(d_emb=256, final_k=10,
                       backend=IVFConfig(n_lists=64, n_probe=8))
    engine = RetrievalEngine(config=cfg)

* **Eager validation** — a typo'd backend option used to surface as a
  ``TypeError`` deep inside ``make_backend`` (or silently at first build);
  config construction now rejects it immediately, with the field named.
* **Serialization** — ``to_dict()`` / ``from_dict()`` round-trip through
  JSON, which is what the HTTP ``stats`` endpoint reports and what
  ``from_flags`` (the shared CLI surface for ``launch.serve`` and the
  benchmarks) builds.
* **Back-compat** — the old kwargs keep working: ``RetrievalEngine(d_emb,
  backend="ivf", backend_opts={...})`` constructs the equivalent
  ``EngineConfig`` through ``legacy_config`` under the hood, so callers
  migrate incrementally (``engine.config`` is always populated either way).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Tuple, Union


def _validate_choice(obj, field: str, choices) -> None:
    if getattr(obj, field) not in choices:
        raise ValueError(
            f"{type(obj).__name__}.{field} must be one of {choices}, got "
            f"{getattr(obj, field)!r}")


def _validate_positive(obj, *fields: str) -> None:
    for field in fields:
        value = getattr(obj, field)
        if value is not None and value < 1:
            raise ValueError(
                f"{type(obj).__name__}.{field} must be >= 1, got {value}")


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Base for per-backend option blocks (see `repro_torch.index_backends`)."""

    name: ClassVar[str] = "?"

    def opts(self) -> Dict:
        """The backend-constructor kwargs this config carries."""
        return dataclasses.asdict(self)

    def to_dict(self) -> Dict:
        return {"backend": self.name, **self.opts()}


@dataclasses.dataclass(frozen=True)
class FlatConfig(BackendConfig):
    """Exact flat scan — the paper's progressive search, no build artifact."""

    name: ClassVar[str] = "flat"


@dataclasses.dataclass(frozen=True)
class IVFConfig(BackendConfig):
    """IVF coarse quantizer: only the probed lists' members are scored
    (the IVF scan kernels on CUDA), then the exact rescore ladder."""

    name: ClassVar[str] = "ivf"

    n_lists: Optional[int] = None
    n_probe: int = 12
    probe_dim: Optional[int] = None
    balance_factor: Optional[float] = 2.0
    assign_m: int = 8
    kmeans_iters: int = 10
    train_rows: int = 131072
    assign_block: int = 65536
    rebuild_frac: float = 0.25
    min_rebuild_rows: int = 64
    tail_window: int = 512
    min_index_rows: int = 64
    append_spare: int = 8
    use_kernel: Union[str, bool] = "auto"
    stage0_dtype: str = "float32"
    kernel_block_m: int = 128
    kernel_merge: str = "sort"
    pq_m: Optional[int] = None
    pq_codes: int = 256
    pq_iters: int = 10
    pq_oversample: int = 4
    seed: int = 0

    def __post_init__(self):
        _validate_choice(self, "stage0_dtype", ("float32", "int8", "pq"))
        _validate_choice(self, "use_kernel", ("auto", True, False))
        _validate_choice(self, "kernel_merge", ("sort", "select"))
        _validate_positive(
            self, "n_lists", "n_probe", "kmeans_iters", "train_rows",
            "tail_window", "kernel_block_m", "pq_m", "pq_codes",
            "pq_oversample")
        if not 0 < self.rebuild_frac:
            raise ValueError(
                f"IVFConfig.rebuild_frac must be > 0, got "
                f"{self.rebuild_frac}")
        if not 1 <= self.pq_codes <= 256:
            raise ValueError(
                f"IVFConfig.pq_codes must lie in [1, 256], got "
                f"{self.pq_codes}")


@dataclasses.dataclass(frozen=True)
class QuantizedConfig(BackendConfig):
    """Quantized stage-0 block (int8 per-dim or PQ/ADC), exact rescore."""

    name: ClassVar[str] = "quantized"

    rebuild_frac: float = 0.25
    min_rebuild_rows: int = 64
    tail_window: int = 512
    codec: str = "int8"
    pq_m: Optional[int] = None
    pq_codes: int = 256
    pq_iters: int = 10
    pq_train_rows: int = 65536
    pq_oversample: int = 4
    encode_appends: bool = True
    use_kernel: Union[str, bool] = "auto"
    kernel_block_m: int = 128
    kernel_merge: str = "sort"
    seed: int = 0

    def __post_init__(self):
        _validate_choice(self, "codec", ("int8", "pq"))
        _validate_choice(self, "use_kernel", ("auto", True, False))
        _validate_choice(self, "kernel_merge", ("sort", "select"))
        _validate_positive(
            self, "tail_window", "kernel_block_m", "pq_m", "pq_codes",
            "pq_train_rows", "pq_oversample")
        if not 0 < self.rebuild_frac:
            raise ValueError(
                f"QuantizedConfig.rebuild_frac must be > 0, got "
                f"{self.rebuild_frac}")
        if not 1 <= self.pq_codes <= 256:
            raise ValueError(
                f"QuantizedConfig.pq_codes must lie in [1, 256], got "
                f"{self.pq_codes}")


@dataclasses.dataclass(frozen=True)
class CustomBackendConfig(BackendConfig):
    """Name-only record of a pre-constructed ``IndexBackend`` instance.

    User-registered backends plug into the engine as live instances (the
    protocol's extension point); this block keeps ``engine.config``
    populated and serializable for them, but carries no options and cannot
    reconstruct the backend.
    """

    custom_name: str = "?"

    @property
    def name(self) -> str:  # type: ignore[override]
        return self.custom_name

    def opts(self) -> Dict:
        return {}


_BACKEND_CONFIGS: Dict[str, type] = {
    cls.name: cls for cls in (FlatConfig, IVFConfig, QuantizedConfig)
}


def backend_config(name: str, opts: Optional[Dict] = None) -> BackendConfig:
    """Build the typed config for a named backend from legacy-style opts.

    Raises the same "unknown index backend" ``ValueError`` the registry
    would, and a pointed error for an option the backend doesn't take —
    eagerly, instead of a ``TypeError`` inside ``make_backend``.
    """
    cls = _BACKEND_CONFIGS.get(name)
    if cls is None:
        from repro_torch.index_backends import backend_names
        raise ValueError(
            f"unknown index backend {name!r}; available: {backend_names()}")
    opts = dict(opts or {})
    known = {f.name for f in dataclasses.fields(cls)}
    bad = sorted(set(opts) - known)
    if bad:
        raise ValueError(
            f"{cls.__name__} does not take option(s) {bad}; known options: "
            f"{sorted(known)}")
    return cls(**opts)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability section of `EngineConfig` (see `repro_torch.obs`).

    * ``enabled`` — master switch.  ``False`` degrades every metric
      instrument to a shared no-op and skips trace contexts entirely,
      restoring the uninstrumented fast path (the overhead benchmark's
      baseline).
    * ``slow_query_ms`` — latency threshold for the structured JSON
      slow-query log (None disables the log).
    * ``trace_ring`` — capacity of the in-memory ring of recent request
      traces (0 disables it).
    * ``stage_fences`` — opt-in device-sync fence between the
      stage-0 scan and the rescore ladder on the batched (driver) path, so
      traces carry a real stage-0/rescore split.  Off by default: the
      fence costs one extra host sync per batch, and the default path
      stays fused exactly as before.
    """

    enabled: bool = True
    slow_query_ms: Optional[float] = None
    trace_ring: int = 256
    stage_fences: bool = False

    def __post_init__(self):
        if self.slow_query_ms is not None and self.slow_query_ms < 0:
            raise ValueError(
                f"ObsConfig.slow_query_ms must be >= 0 or None, got "
                f"{self.slow_query_ms}")
        if self.trace_ring < 0:
            raise ValueError(
                f"ObsConfig.trace_ring must be >= 0, got {self.trace_ring}")

    @classmethod
    def from_dict(cls, d: Dict) -> "ObsConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"ObsConfig does not take field(s) {bad}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Load-adaptive search policy section (see `repro_torch.engine.adaptive`).

    Level ``L >= 1`` is entered when driver queue depth reaches
    ``depth_high * escalate_factor**(L-1)`` (or queue-wait p95 reaches the
    analogous ``wait_high_ms`` rung); each level scales the per-dispatch
    knobs by ``n_probe_scale**L`` / ``oversample_scale**L`` and enters the
    progressive ladder ``d_start_shift * L`` doublings higher (clamped to
    ``min_d_start``..d_start).  Recovery steps down one level after
    ``hysteresis_s`` seconds of continuous calm below ``recover_frac`` of
    the current level's entry thresholds.  ``enabled=False`` (default)
    keeps the static path byte-identical — no degraded schedules are
    built and no overrides ever reach a backend.
    """

    enabled: bool = False
    levels: int = 2
    depth_high: int = 32
    wait_high_ms: Optional[float] = 50.0
    escalate_factor: float = 2.0
    recover_frac: float = 0.5
    hysteresis_s: float = 2.0
    n_probe_scale: float = 0.5
    oversample_scale: float = 0.5
    d_start_shift: int = 1
    min_d_start: int = 8

    def __post_init__(self):
        _validate_positive(self, "levels", "depth_high", "min_d_start")
        if self.wait_high_ms is not None and self.wait_high_ms <= 0:
            raise ValueError(
                f"AdaptiveConfig.wait_high_ms must be > 0 or None, got "
                f"{self.wait_high_ms}")
        if self.escalate_factor < 1.0:
            raise ValueError(
                f"AdaptiveConfig.escalate_factor must be >= 1, got "
                f"{self.escalate_factor}")
        if not 0 < self.recover_frac <= 1:
            raise ValueError(
                f"AdaptiveConfig.recover_frac must lie in (0, 1], got "
                f"{self.recover_frac}")
        if self.hysteresis_s < 0:
            raise ValueError(
                f"AdaptiveConfig.hysteresis_s must be >= 0, got "
                f"{self.hysteresis_s}")
        for f in ("n_probe_scale", "oversample_scale"):
            if not 0 < getattr(self, f) <= 1:
                raise ValueError(
                    f"AdaptiveConfig.{f} must lie in (0, 1], got "
                    f"{getattr(self, f)}")
        if self.d_start_shift < 0:
            raise ValueError(
                f"AdaptiveConfig.d_start_shift must be >= 0, got "
                f"{self.d_start_shift}")

    @classmethod
    def from_dict(cls, d: Dict) -> "AdaptiveConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"AdaptiveConfig does not take field(s) {bad}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Query-result cache section (see `repro_torch.engine.qcache`).

    ``capacity`` bounds live entries (LRU beyond it); ``near_eps > 0``
    additionally serves near-duplicate queries within that squared-L2
    distance of a cached query (same tenant/filter mask and degradation
    level only).  Invalidation is structural — any store generation /
    mask-epoch / rebuild bump flushes the cache — so no TTL knob exists.
    """

    enabled: bool = False
    capacity: int = 1024
    near_eps: float = 0.0

    def __post_init__(self):
        _validate_positive(self, "capacity")
        if self.near_eps < 0:
            raise ValueError(
                f"CacheConfig.near_eps must be >= 0, got {self.near_eps}")

    @classmethod
    def from_dict(cls, d: Dict) -> "CacheConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"CacheConfig does not take field(s) {bad}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Replication section (see `repro_torch.engine.replication`).

    * ``role`` — ``single`` (no replication), ``primary`` (owns the WAL;
      mutations land here), or ``follower`` (read-only; bootstraps from the
      shared state dir's newest snapshot and tails the primary's WAL).
    * ``poll_s`` — follower WAL-tail poll interval.
    * ``ready_lag_max`` — readiness bound: a follower reports ready only
      once bootstrapped and within this many records of the primary's tail
      (``/healthz?ready=1``).
    * ``min_seq_wait_s`` — serving-side cap on how long a search holding a
      ``min_seq`` consistency token waits for catch-up before returning a
      retryable 503 (bounded further by the request deadline).
    """

    role: str = "single"
    poll_s: float = 0.05
    ready_lag_max: int = 0
    min_seq_wait_s: float = 1.0

    def __post_init__(self):
        _validate_choice(self, "role", ("single", "primary", "follower"))
        if self.poll_s <= 0:
            raise ValueError(
                f"ReplicationConfig.poll_s must be > 0, got {self.poll_s}")
        if self.ready_lag_max < 0:
            raise ValueError(
                f"ReplicationConfig.ready_lag_max must be >= 0, got "
                f"{self.ready_lag_max}")
        if self.min_seq_wait_s < 0:
            raise ValueError(
                f"ReplicationConfig.min_seq_wait_s must be >= 0, got "
                f"{self.min_seq_wait_s}")

    @classmethod
    def from_dict(cls, d: Dict) -> "ReplicationConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(
                f"ReplicationConfig does not take field(s) {bad}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultToleranceConfig:
    """Fault-tolerance section (see `repro_torch.engine.wal` / ``.supervise`` /
    ``.faults``).

    * ``wal_fsync`` — fsync every WAL append before acknowledging the
      mutation (the durability guarantee; turn off only for benchmarks).
    * ``snapshot_keep`` — snapshots retained by ``save_snapshot``; WAL
      segments covered by the oldest retained snapshot are pruned, so a
      torn-newest fallback can still replay.
    * ``heartbeat_timeout_s`` — driver heartbeat age AND oldest-pending
      wait beyond which the supervisor declares the thread hung.
    * ``max_restarts`` — consecutive restarts before the supervisor gives
      up and fails pending requests (the crash loop is then fatal).
    * ``backoff_initial_s`` / ``backoff_max_s`` — capped exponential
      restart backoff.
    * ``rebuild_retries`` — consecutive background-rebuild failures
      tolerated (relaunched at the next safe point) before the error
      escalates to the dispatch path.
    * ``poison_bisect`` — isolate a failing batch by bisection so only the
      offending request fails (``RequestFailed`` / HTTP 503).
    * ``inject`` / ``inject_seed`` — deterministic fault-injection spec
      (see `repro_torch.engine.faults.FaultPlan.parse`); empty = inert.
    """

    wal_fsync: bool = True
    snapshot_keep: int = 3
    heartbeat_timeout_s: float = 5.0
    max_restarts: int = 5
    backoff_initial_s: float = 0.05
    backoff_max_s: float = 2.0
    rebuild_retries: int = 3
    poison_bisect: bool = True
    inject: str = ""
    inject_seed: int = 0

    def __post_init__(self):
        _validate_positive(self, "snapshot_keep")
        for f in ("heartbeat_timeout_s", "backoff_initial_s",
                  "backoff_max_s"):
            if getattr(self, f) <= 0:
                raise ValueError(
                    f"FaultToleranceConfig.{f} must be > 0, got "
                    f"{getattr(self, f)}")
        if self.max_restarts < 0 or self.rebuild_retries < 0:
            raise ValueError(
                f"FaultToleranceConfig.max_restarts/rebuild_retries must "
                f"be >= 0, got {self.max_restarts}/{self.rebuild_retries}")
        # parse eagerly so a typo'd spec fails at config time, not at the
        # first fault-site check deep inside a dispatch
        from repro_torch.engine.faults import FaultPlan
        FaultPlan.parse(self.inject, seed=self.inject_seed)

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultToleranceConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(
                f"FaultToleranceConfig does not take field(s) {bad}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Full static configuration of a `RetrievalEngine`.

    ``backend`` is a typed per-backend block (``FlatConfig`` / ``IVFConfig``
    / ``QuantizedConfig``).  Everything validates at construction; the
    schedule itself is derived from (d_start, k0, final_k) exactly as the
    legacy kwargs did (pass ``schedule=`` to the engine to override).
    """

    d_emb: int
    d_start: int = 32
    k0: int = 32
    final_k: int = 1
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    capacity: int = 1024
    metric: str = "l2"
    block_n: int = 65536
    max_unpolled: int = 65536
    backend: BackendConfig = dataclasses.field(default_factory=FlatConfig)
    rebuild_mode: str = "sync"
    compact_dead_frac: Optional[float] = 0.3
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    adaptive: AdaptiveConfig = dataclasses.field(
        default_factory=AdaptiveConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    fault: FaultToleranceConfig = dataclasses.field(
        default_factory=FaultToleranceConfig)
    replication: ReplicationConfig = dataclasses.field(
        default_factory=ReplicationConfig)

    def __post_init__(self):
        _validate_positive(self, "d_emb", "d_start", "k0", "final_k",
                           "capacity", "block_n", "max_unpolled")
        if not isinstance(self.obs, ObsConfig):
            raise ValueError(
                f"EngineConfig.obs must be an ObsConfig, got "
                f"{type(self.obs).__name__}")
        if not isinstance(self.adaptive, AdaptiveConfig):
            raise ValueError(
                f"EngineConfig.adaptive must be an AdaptiveConfig, got "
                f"{type(self.adaptive).__name__}")
        if not isinstance(self.cache, CacheConfig):
            raise ValueError(
                f"EngineConfig.cache must be a CacheConfig, got "
                f"{type(self.cache).__name__}")
        if not isinstance(self.fault, FaultToleranceConfig):
            raise ValueError(
                f"EngineConfig.fault must be a FaultToleranceConfig, got "
                f"{type(self.fault).__name__}")
        if not isinstance(self.replication, ReplicationConfig):
            raise ValueError(
                f"EngineConfig.replication must be a ReplicationConfig, "
                f"got {type(self.replication).__name__}")
        if self.d_start > self.d_emb:
            raise ValueError(
                f"EngineConfig.d_start={self.d_start} exceeds "
                f"d_emb={self.d_emb}")
        _validate_choice(self, "rebuild_mode", ("sync", "background", "off"))
        _validate_choice(self, "metric", ("l2", "cosine"))
        if not isinstance(self.backend, BackendConfig):
            raise ValueError(
                f"EngineConfig.backend must be a BackendConfig "
                f"(FlatConfig/IVFConfig/QuantizedConfig), got "
                f"{type(self.backend).__name__}; legacy name+opts callers "
                f"go through backend_config()")
        object.__setattr__(
            self, "buckets", tuple(int(b) for b in self.buckets))
        if not self.buckets or any(b < 1 for b in self.buckets) or (
                list(self.buckets) != sorted(set(self.buckets))):
            raise ValueError(
                f"EngineConfig.buckets must be ascending unique positive "
                f"sizes, got {self.buckets}")
        if self.compact_dead_frac is not None and not (
                0 < self.compact_dead_frac <= 1):
            raise ValueError(
                f"EngineConfig.compact_dead_frac must lie in (0, 1] or be "
                f"None, got {self.compact_dead_frac}")

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict:
        """JSON-able dict (the HTTP ``stats`` endpoint reports this)."""
        out = dataclasses.asdict(self)
        out["buckets"] = list(self.buckets)
        out["backend"] = self.backend.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: Dict) -> "EngineConfig":
        d = dict(d)
        be = dict(d.pop("backend", {"backend": "flat"}))
        name = be.pop("backend")
        d["backend"] = backend_config(name, be)
        if "obs" in d:
            d["obs"] = ObsConfig.from_dict(d["obs"])
        if "adaptive" in d:
            d["adaptive"] = AdaptiveConfig.from_dict(d["adaptive"])
        if "cache" in d:
            d["cache"] = CacheConfig.from_dict(d["cache"])
        if "fault" in d:
            d["fault"] = FaultToleranceConfig.from_dict(d["fault"])
        if "replication" in d:
            d["replication"] = ReplicationConfig.from_dict(d["replication"])
        if "buckets" in d:
            d["buckets"] = tuple(d["buckets"])
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"EngineConfig does not take field(s) {bad}")
        return cls(**d)

    # -- CLI surface ---------------------------------------------------------
    @staticmethod
    def add_flags(ap) -> None:
        """Register the shared engine flags on an argparse parser (the one
        surface ``launch.serve`` and the HTTP benchmarks draw from)."""
        ap.add_argument("--d-start", type=int, default=32)
        ap.add_argument("--k0", type=int, default=32)
        ap.add_argument("--final-k", type=int, default=1)
        ap.add_argument("--buckets", type=str, default="1,2,4,8,16,32",
                        help="comma-separated static retrieval batch sizes")
        ap.add_argument("--backend", type=str, default="flat",
                        choices=tuple(sorted(_BACKEND_CONFIGS)),
                        help="index backend behind the retrieval engine")
        ap.add_argument("--use-kernel", type=str, default="auto",
                        choices=("auto", "true", "false"),
                        help="ivf/quantized-pq: stage 0 through the IVF / "
                             "PQ scan kernels (auto: on CUDA)")
        ap.add_argument("--stage0-dtype", type=str, default="float32",
                        choices=("float32", "int8", "pq"),
                        help="ivf only: member-slab dtype for the fused "
                             "kernel (pq = ADC LUT scan over PQ codes)")
        ap.add_argument("--codec", type=str, default="int8",
                        choices=("int8", "pq"),
                        help="quantized only: stage-0 code block codec")
        ap.add_argument("--pq-m", type=int, default=0,
                        help="PQ subspaces per row (0 = auto, aim 8-dim "
                             "subspaces); must divide the stage-0 dim")
        ap.add_argument("--rebuild-mode", type=str, default="sync",
                        choices=("sync", "background", "off"))
        ap.add_argument("--no-obs", action="store_true",
                        help="disable metrics/traces (uninstrumented fast "
                             "path; the overhead-benchmark baseline)")
        ap.add_argument("--slow-query-ms", type=float, default=0.0,
                        help="log a structured JSON record for requests "
                             "slower than this (0 = disabled)")
        ap.add_argument("--trace-ring", type=int, default=256,
                        help="recent-request trace ring capacity")
        ap.add_argument("--stage-fences", action="store_true",
                        help="fence stage-0 vs rescore on the batched path "
                             "so traces carry the split (extra host sync)")
        ap.add_argument("--adaptive", action="store_true",
                        help="enable the load-adaptive search policy "
                             "(degrade recall instead of availability "
                             "under queue pressure)")
        ap.add_argument("--adaptive-levels", type=int, default=2,
                        help="number of degradation levels")
        ap.add_argument("--adaptive-depth-high", type=int, default=32,
                        help="driver queue depth entering level 1")
        ap.add_argument("--adaptive-wait-high-ms", type=float, default=50.0,
                        help="queue-wait p95 (ms) entering level 1 "
                             "(0 = depth-only)")
        ap.add_argument("--adaptive-hysteresis-s", type=float, default=2.0,
                        help="continuous calm time before stepping one "
                             "level back down")
        ap.add_argument("--qcache", action="store_true",
                        help="enable the mutation-aware query-result cache "
                             "in front of the driver queue")
        ap.add_argument("--qcache-capacity", type=int, default=1024,
                        help="cached query results (LRU beyond this)")
        ap.add_argument("--qcache-near-eps", type=float, default=0.0,
                        help="serve near-duplicate queries within this "
                             "squared-L2 distance (0 = exact-only)")
        ap.add_argument("--ft-heartbeat-timeout-s", type=float, default=5.0,
                        help="driver heartbeat age declaring the thread "
                             "hung (supervisor restart trigger)")
        ap.add_argument("--ft-max-restarts", type=int, default=5,
                        help="consecutive driver restarts before the "
                             "supervisor gives up")
        ap.add_argument("--ft-backoff-initial-s", type=float, default=0.05,
                        help="initial restart backoff (doubles per "
                             "consecutive restart)")
        ap.add_argument("--ft-backoff-max-s", type=float, default=2.0,
                        help="restart backoff cap")
        ap.add_argument("--ft-rebuild-retries", type=int, default=3,
                        help="consecutive background-rebuild failures "
                             "retried before escalating")
        ap.add_argument("--ft-snapshot-keep", type=int, default=3,
                        help="snapshots retained (older WAL segments "
                             "pruned past the oldest)")
        ap.add_argument("--no-poison-bisect", action="store_true",
                        help="fail a whole batch on dispatch error instead "
                             "of bisecting to isolate the poison request")
        ap.add_argument("--wal-no-fsync", action="store_true",
                        help="skip the per-append WAL fsync (benchmarks "
                             "only: acked mutations may be lost on crash)")
        ap.add_argument("--inject", type=str, default="",
                        help="deterministic fault-injection spec, e.g. "
                             "'dispatch:crash@once=3;rebuild:error@first=2' "
                             "(chaos testing; empty = inert)")
        ap.add_argument("--inject-seed", type=int, default=0,
                        help="seed for probabilistic (p=) fault rules")
        ap.add_argument("--role", type=str, default="single",
                        choices=("single", "primary", "follower", "router"),
                        help="replication role: primary owns the WAL, "
                             "followers tail it read-only from the shared "
                             "--state-dir, router fronts --replicas")
        ap.add_argument("--replica-poll-s", type=float, default=0.05,
                        help="follower WAL-tail poll interval")
        ap.add_argument("--ready-lag-max", type=int, default=0,
                        help="follower readiness: max records behind the "
                             "primary's tail for /healthz?ready=1")
        ap.add_argument("--min-seq-wait-s", type=float, default=1.0,
                        help="max wait for a min_seq consistency token "
                             "before a retryable 503")

    @classmethod
    def from_flags(cls, args, *, d_emb: int,
                   capacity: Optional[int] = None) -> "EngineConfig":
        """Build an EngineConfig from ``add_flags`` argparse output."""
        use_kernel = {"auto": "auto", "true": True,
                      "false": False}[args.use_kernel]
        pq_m = args.pq_m or None
        if args.backend == "ivf":
            be = IVFConfig(use_kernel=use_kernel,
                           stage0_dtype=args.stage0_dtype,
                           pq_m=pq_m if args.stage0_dtype == "pq" else None)
        elif args.backend == "quantized":
            be = QuantizedConfig(codec=args.codec, use_kernel=use_kernel,
                                 pq_m=pq_m if args.codec == "pq" else None)
        else:
            be = FlatConfig()
        d_start = min(args.d_start, d_emb)
        return cls(
            d_emb=d_emb,
            d_start=d_start,
            k0=args.k0,
            final_k=args.final_k,
            buckets=tuple(int(x) for x in args.buckets.split(",")),
            capacity=capacity if capacity is not None else 1024,
            backend=be,
            rebuild_mode=args.rebuild_mode,
            obs=ObsConfig(
                enabled=not args.no_obs,
                slow_query_ms=args.slow_query_ms or None,
                trace_ring=args.trace_ring,
                stage_fences=args.stage_fences,
            ),
            adaptive=AdaptiveConfig(
                enabled=args.adaptive,
                levels=args.adaptive_levels,
                depth_high=args.adaptive_depth_high,
                wait_high_ms=args.adaptive_wait_high_ms or None,
                hysteresis_s=args.adaptive_hysteresis_s,
            ),
            cache=CacheConfig(
                enabled=args.qcache,
                capacity=args.qcache_capacity,
                near_eps=args.qcache_near_eps,
            ),
            fault=FaultToleranceConfig(
                wal_fsync=not args.wal_no_fsync,
                snapshot_keep=args.ft_snapshot_keep,
                heartbeat_timeout_s=args.ft_heartbeat_timeout_s,
                max_restarts=args.ft_max_restarts,
                backoff_initial_s=args.ft_backoff_initial_s,
                backoff_max_s=args.ft_backoff_max_s,
                rebuild_retries=args.ft_rebuild_retries,
                poison_bisect=not args.no_poison_bisect,
                inject=args.inject,
                inject_seed=args.inject_seed,
            ),
            replication=ReplicationConfig(
                # the router role builds no engine of its own
                role=(args.role if args.role in ("primary", "follower")
                      else "single"),
                poll_s=args.replica_poll_s,
                ready_lag_max=args.ready_lag_max,
                min_seq_wait_s=args.min_seq_wait_s,
            ),
        )


def legacy_config(
    d_emb: int,
    *,
    d_start: int = 32,
    k0: int = 32,
    final_k: int = 1,
    buckets=(1, 2, 4, 8, 16, 32),
    capacity: int = 1024,
    metric: str = "l2",
    block_n: int = 65536,
    max_unpolled: int = 65536,
    backend="flat",
    backend_opts: Optional[Dict] = None,
    rebuild_mode: str = "sync",
    compact_dead_frac: Optional[float] = 0.3,
    obs: Optional[ObsConfig] = None,
    adaptive: Optional[AdaptiveConfig] = None,
    cache: Optional[CacheConfig] = None,
    fault: Optional[FaultToleranceConfig] = None,
    replication: Optional[ReplicationConfig] = None,
) -> "EngineConfig":
    """The deprecation shim: old-style engine kwargs -> ``EngineConfig``.

    ``RetrievalEngine``'s legacy keyword path routes through here, so the
    stringly-typed surface keeps working while gaining the typed configs'
    eager validation.  A pre-constructed ``IndexBackend`` instance (also
    legacy) is handled by the engine itself and never reaches this shim.
    """
    return EngineConfig(
        d_emb=d_emb, d_start=min(d_start, d_emb), k0=k0, final_k=final_k,
        buckets=tuple(buckets), capacity=capacity, metric=metric,
        block_n=block_n, max_unpolled=max_unpolled,
        backend=(backend if isinstance(backend, BackendConfig)
                 else backend_config(backend, backend_opts)),
        rebuild_mode=rebuild_mode, compact_dead_frac=compact_dead_frac,
        obs=obs if obs is not None else ObsConfig(),
        adaptive=adaptive if adaptive is not None else AdaptiveConfig(),
        cache=cache if cache is not None else CacheConfig(),
        fault=fault if fault is not None else FaultToleranceConfig(),
        replication=(replication if replication is not None
                     else ReplicationConfig()),
    )
