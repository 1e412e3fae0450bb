"""Observability layer: metrics registry, trace spans, slow-query log.

  MetricsRegistry        — thread-safe counters / gauges / fixed-bucket
                           histograms with labels + cardinality caps;
                           Prometheus text exposition and JSON snapshot
  TraceContext, TraceRing,
  SlowQueryLog           — per-request pipeline timestamps (submit →
                           deliver), a bounded ring of recent traces, and
                           a structured JSON slow-query log
  summarize_latency, histogram_counts, percentile_from_counts,
  DEFAULT_LATENCY_BUCKETS_MS
                         — the shared bucket ladder + percentile math used
                           by both the online histograms and the offline
                           benchmarks, so p50/p95 mean the same thing in
                           BENCH_*.json and on /metrics
  parse_prometheus       — exposition-format parser for tests and the
                           load benchmark's invariant checks

Everything here is dependency-free (stdlib only) and safe to update under
``engine.lock``; ``MetricsRegistry(enabled=False)`` degrades every
instrument to a shared no-op so the uninstrumented fast path is restored.
"""

from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_INSTRUMENT,
    histogram_counts,
    parse_prometheus,
    percentile_from_counts,
    summarize_latency,
)
from repro_torch.obs.trace import (
    MARK_ORDER,
    SlowQueryLog,
    TraceContext,
    TraceRing,
)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_MS", "Counter", "Gauge", "Histogram",
    "MARK_ORDER", "MetricsRegistry", "NULL_INSTRUMENT", "SlowQueryLog",
    "TraceContext", "TraceRing", "histogram_counts", "parse_prometheus",
    "percentile_from_counts", "summarize_latency",
]
