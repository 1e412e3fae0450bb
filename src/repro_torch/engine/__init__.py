"""Retrieval serving engine: request queueing, shape-bucketed batching, an
async deadline-batching driver, and a mutable (add/delete) corpus on top of
pluggable index backends, with the corpus in device memory; durability
(mutation WAL, snapshots, recovery) and WAL-shipped replication in the JAX
package's file formats.

Public API:
  RetrievalEngine                — submit/poll/step serving loop + batch search
                                   (typed ``EngineConfig`` or legacy kwargs,
                                   explicit ``device``); thread-safe behind
                                   ``engine.lock``
  SearchRequest                  — typed per-request options (k, tenant,
                                   metadata filter, deadline)
  EngineConfig + FlatConfig/IVFConfig/QuantizedConfig
                                 — eager-validating, serializable engine and
                                   per-backend configuration
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
  MutationWAL, WALError          — fsync'd mutation write-ahead log behind
                                   ``enable_durability``/``recover``
  WALCursor, WALGap              — seq-keyed tailing reader over a WAL
                                   directory (replication shipping:
                                   rotate/prune-safe, gap detection)
  ReplicaApplier,
  PrimaryReplication             — WAL-shipped replication: follower
                                   snapshot bootstrap + tail catch-up,
                                   replica_lag, min_seq waits
  ReplicationConfig              — role/poll/lag-bound knobs on
                                   ``EngineConfig.replication``
  FaultToleranceConfig           — WAL/supervision/injection knobs on
                                   ``EngineConfig.fault``
  FaultPlan, InjectedFault,
  InjectedCrash, PoisonError     — deterministic fault-injection harness
  Supervisor, SupervisorGaveUp   — driver watchdog: heartbeat detection,
                                   capped-backoff restarts
  RequestFailed                  — request isolated by poison-batch bisection
  IndexMismatch                  — loaded index incompatible with live config
  CorruptCheckpoint              — checksum/parse failure in a saved step
                                   (``recover`` falls back a step)
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
    IVFConfig,
    QuantizedConfig,
    ReplicationConfig,
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
    IndexMismatch,
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
from repro_torch.engine.replication import PrimaryReplication, ReplicaApplier
from repro_torch.engine.supervise import Supervisor, SupervisorGaveUp
from repro_torch.engine.wal import MutationWAL, WALCursor, WALError, WALGap
from repro_torch.checkpoint import CorruptCheckpoint
from repro_torch.engine.qcache import QueryCache
from repro_torch.engine.request import FilterError, SearchRequest, canonical_filter
from repro_torch.engine.store import DocStore
from repro_torch.index_backends import StoreStats

__all__ = [
    "AdaptivePolicy", "SearchOverrides", "QueryCache",
    "BatchDecision", "BucketPolicy", "DeadlineBatcher", "PendingRequest",
    "RequestQueue", "pad_batch",
    "AdaptiveConfig", "BackendConfig", "CacheConfig", "EngineConfig",
    "FaultToleranceConfig", "FlatConfig", "IVFConfig", "QuantizedConfig",
    "backend_config",
    "DeadlineExceeded", "DriverQueueFull", "DriverStats", "DriverStopped",
    "EngineDriver", "RequestFailed", "RetrievalFuture",
    "DocStore", "EngineStats", "FilterError", "IndexMismatch",
    "RequestStats",
    "ResultEvicted", "RetrievalEngine", "RetrievalResult", "SearchRequest",
    "StoreStats", "UnknownRequest", "canonical_filter",
    "CorruptCheckpoint", "FaultPlan", "InjectedCrash", "InjectedFault",
    "MutationWAL", "PoisonError", "PrimaryReplication", "ReplicaApplier",
    "ReplicationConfig", "Supervisor", "SupervisorGaveUp",
    "WALCursor", "WALError", "WALGap",
]
