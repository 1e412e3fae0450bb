"""Retrieval serving engine: request queueing, shape-bucketed batching, an
async deadline-batching driver, and a mutable (add/delete) corpus on top of
the flat index backend, with the corpus in device memory.

Public API:
  RetrievalEngine                — submit/poll/step serving loop + batch search
                                   (typed ``EngineConfig`` or legacy kwargs,
                                   explicit ``device``); thread-safe behind
                                   ``engine.lock``
  SearchRequest                  — typed per-request options (k, tenant,
                                   metadata filter, deadline)
  EngineConfig + FlatConfig      — eager-validating, serializable engine and
                                   backend configuration
  EngineDriver                   — background thread owning batch formation:
                                   deadline-based flushes, futures,
                                   backpressure, drain/abort shutdown
  RetrievalFuture                — write-once result handle from ``submit``
  DriverStopped, DriverQueueFull,
  DeadlineExceeded               — driver client-facing exceptions
  UnknownRequest, ResultEvicted  — ``poll`` signals: never-issued id vs a
                                   result that is gone for good
  FilterError                    — malformed metadata-filter spec
  RetrievalResult, RequestStats  — per-request outputs and timing breakdown
  EngineStats, DriverStats       — aggregate counters / latency percentiles
  DocStore                       — capacity-doubling device buffers + validity
                                   mask, tombstone compaction, tenant
                                   namespaces + metadata filter masks,
                                   ``restore_state`` from either package's
                                   ``snapshot_state``
  BucketPolicy                   — static batch-size ladder
  DeadlineBatcher, BatchDecision — pure deadline-flush policy
  AdaptivePolicy, SearchOverrides
                                 — load-adaptive degradation
  QueryCache                     — exact + near-duplicate query-result cache
  FaultPlan, InjectedFault,
  InjectedCrash, PoisonError     — deterministic fault-injection harness
  RequestFailed                  — request isolated by poison-batch bisection
"""

from repro_torch.engine.adaptive import AdaptivePolicy, SearchOverrides
from repro_torch.engine.batching import (
    BatchDecision,
    BucketPolicy,
    DeadlineBatcher,
    PendingRequest,
    RequestQueue,
    pad_batch,
)
from repro_torch.engine.config import (
    AdaptiveConfig,
    BackendConfig,
    CacheConfig,
    EngineConfig,
    FaultToleranceConfig,
    FlatConfig,
    backend_config,
)
from repro_torch.engine.driver import (
    DeadlineExceeded,
    DriverQueueFull,
    DriverStats,
    DriverStopped,
    EngineDriver,
    RequestFailed,
    RetrievalFuture,
)
from repro_torch.engine.engine import (
    EngineStats,
    RequestStats,
    ResultEvicted,
    RetrievalEngine,
    RetrievalResult,
    UnknownRequest,
)
from repro_torch.engine.faults import (
    FaultPlan,
    InjectedCrash,
    InjectedFault,
    PoisonError,
)
from repro_torch.engine.qcache import QueryCache
from repro_torch.engine.request import FilterError, SearchRequest, canonical_filter
from repro_torch.engine.store import DocStore
from repro_torch.index_backends import StoreStats

__all__ = [
    "AdaptivePolicy", "SearchOverrides", "QueryCache",
    "BatchDecision", "BucketPolicy", "DeadlineBatcher", "PendingRequest",
    "RequestQueue", "pad_batch",
    "AdaptiveConfig", "BackendConfig", "CacheConfig", "EngineConfig",
    "FaultToleranceConfig", "FlatConfig", "backend_config",
    "DeadlineExceeded", "DriverQueueFull", "DriverStats", "DriverStopped",
    "EngineDriver", "RequestFailed", "RetrievalFuture",
    "DocStore", "EngineStats", "FilterError", "RequestStats",
    "ResultEvicted", "RetrievalEngine", "RetrievalResult", "SearchRequest",
    "StoreStats", "UnknownRequest", "canonical_filter",
    "FaultPlan", "InjectedCrash", "InjectedFault", "PoisonError",
]
