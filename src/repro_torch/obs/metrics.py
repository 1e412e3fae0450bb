"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

The serving spine updates metrics under ``engine.lock`` (and the driver's
condition variable), so every instrument here is deliberately cheap: one
registry-wide ``threading.Lock`` around a dict lookup and a float add — no
allocation on the hot path after the first observation of a label set.

* **Labels** — each instrument is a *family*; a concrete series is the
  family plus a tuple of label values.  Families declare their label names
  up front and cap distinct label-value sets (``max_series``, default 64):
  past the cap, new series collapse into a reserved ``"__overflow__"``
  series so an unbounded tenant universe cannot grow memory without bound.
* **Histograms** — fixed upper-bound buckets (``DEFAULT_LATENCY_BUCKETS_MS``
  spans 0.1ms..10s).  Offline benchmarks and the online engine share the
  same bucket definitions through ``summarize_latency`` /
  ``percentile_from_counts``, so a p95 in ``BENCH_engine.json`` and a p95
  scraped from ``/metrics`` mean the same thing.
* **Exposition** — ``render_prometheus()`` emits Prometheus text format
  0.0.4 (``# TYPE`` lines, cumulative ``_bucket{le=...}`` series,
  ``_sum``/``_count``); ``snapshot()`` is the JSON-able equivalent.
  ``parse_prometheus`` round-trips the text form for tests and the load
  benchmark's mid-run invariant checks.
* **Disabled mode** — ``MetricsRegistry(enabled=False)`` hands out shared
  no-op instruments: every ``inc``/``set``/``observe`` is a single
  attribute lookup + pass, restoring the uninstrumented fast path.

Collectors (``register_collector``) let components publish point-in-time
gauges lazily: they run at ``render_prometheus``/``snapshot`` time, not per
request — the engine registers one that snapshots store/backend state under
its own lock only when something actually scrapes.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Shared fixed bucket ladder for every latency histogram (milliseconds).
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

_OVERFLOW = ("__overflow__",)


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for a disabled registry."""

    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def add(self, amount: float, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def set_total(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def observe_many(self, values, **labels) -> None:
        pass

    def value(self, **labels) -> float:
        return 0.0

    def count(self, **labels) -> float:
        return 0.0

    def percentile(self, p: float, **labels) -> float:
        return float("nan")


NULL_INSTRUMENT = _NullInstrument()


class _Family:
    """Base: one named metric family with labeled series."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labels: Sequence[str], max_series: int):
        self._reg = registry
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self.max_series = int(max_series)
        self._series: Dict[Tuple, object] = {}

    def _key(self, labels: Dict) -> Tuple:
        # fast path: unlabeled family + no kwargs (the per-request hot
        # instruments) — skip the set comparisons entirely
        if not labels and not self.label_names:
            return ()
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[n]) for n in self.label_names)
        # cardinality cap: unseen label sets past the bound collapse into
        # one reserved overflow series (bounded memory, visible truncation)
        if key not in self._series and len(self._series) >= self.max_series:
            return _OVERFLOW if self.label_names else key
        return key

    def _series_items(self) -> List[Tuple[Tuple, object]]:
        return sorted(self._series.items())

    def _label_str(self, key: Tuple, extra: str = "") -> str:
        if key == _OVERFLOW and self.label_names:
            parts = [f'{self.label_names[0]}="__overflow__"']
            parts += [f'{n}=""' for n in self.label_names[1:]]
        else:
            parts = [f'{n}="{v}"' for n, v in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Family):
    """Monotonically-increasing float counter family."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._reg._lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0.0) + amount

    add = inc

    def set_total(self, value: float, **labels) -> None:
        """Publish an externally-tracked lifetime total (collector path:
        a component that already keeps its own int just mirrors it)."""
        with self._reg._lock:
            self._series[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._reg._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def _render(self, out: List[str]) -> None:
        for key, v in self._series_items():
            out.append(
                f"{self.name}{self._label_str(key)} {_format_value(v)}")


class Gauge(_Family):
    """Set-to-current-value gauge family."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._reg._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._reg._lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._reg._lock:
            return float(self._series.get(self._key(labels), 0.0))

    _render = Counter._render


class Histogram(_Family):
    """Fixed-bucket histogram family (per-series counts + sum + count)."""

    kind = "histogram"

    def __init__(self, registry, name, help, labels, max_series,
                 buckets: Sequence[float]):
        super().__init__(registry, name, help, labels, max_series)
        bkts = tuple(float(b) for b in buckets)
        if not bkts or list(bkts) != sorted(set(bkts)):
            raise ValueError(
                f"histogram {name!r} buckets must be ascending/unique, "
                f"got {buckets}")
        self.buckets = bkts

    def _slot(self, key: Tuple) -> Dict:
        s = self._series.get(key)
        if s is None:
            s = {"counts": [0] * (len(self.buckets) + 1),
                 "sum": 0.0, "count": 0}
            self._series[key] = s
        return s

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._reg._lock:
            s = self._slot(self._key(labels))
            s["counts"][i] += 1
            s["sum"] += v
            s["count"] += 1

    def observe_many(self, values, **labels) -> None:
        """Batch ``observe``: one lock round-trip for a whole batch of
        samples (the engine records a batch's requests in one call)."""
        if not values:
            return
        vs = [float(v) for v in values]
        slots = [bisect.bisect_left(self.buckets, v) for v in vs]
        with self._reg._lock:
            s = self._slot(self._key(labels))
            counts = s["counts"]
            for i in slots:
                counts[i] += 1
            s["sum"] += sum(vs)
            s["count"] += len(vs)

    def count(self, **labels) -> int:
        with self._reg._lock:
            s = self._series.get(self._key(labels))
            return int(s["count"]) if s else 0

    def percentile(self, p: float, **labels) -> float:
        with self._reg._lock:
            s = self._series.get(self._key(labels))
            counts = list(s["counts"]) if s else []
        return percentile_from_counts(counts, self.buckets, p)

    def _render(self, out: List[str]) -> None:
        for key, s in self._series_items():
            cum = 0
            for ub, c in zip(self.buckets, s["counts"]):
                cum += c
                le = 'le="' + _format_value(ub) + '"'
                out.append(
                    f"{self.name}_bucket{self._label_str(key, le)} {cum}")
            cum += s["counts"][-1]
            le_inf = 'le="+Inf"'
            out.append(
                f"{self.name}_bucket{self._label_str(key, le_inf)} {cum}")
            out.append(
                f"{self.name}_sum{self._label_str(key)} "
                f"{_format_value(s['sum'])}")
            out.append(
                f"{self.name}_count{self._label_str(key)} {s['count']}")


class MetricsRegistry:
    """One process-local metric namespace + its exposition surface.

    ``enabled=False`` returns shared no-op instruments from every factory —
    the callers' code paths are unchanged but nothing is recorded (the
    ``obs.enabled=False`` fast path the overhead benchmark measures).
    """

    def __init__(self, *, enabled: bool = True, max_series: int = 64):
        self.enabled = bool(enabled)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []

    def _family(self, cls, name: str, help: str, labels, **kw):
        if not self.enabled:
            return NULL_INSTRUMENT
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}")
                return fam
            fam = cls(self, name, help, tuple(labels),
                      kw.pop("max_series", self.max_series), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._family(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._family(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  ) -> Histogram:
        return self._family(Histogram, name, help, labels, buckets=buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Register a scrape-time callback that sets gauges/counters."""
        if self.enabled:
            with self._lock:
                self._collectors.append(fn)

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._collect()
        out: List[str] = []
        with self._lock:
            fams = sorted(self._families.items())
        for name, fam in fams:
            if fam.help:
                out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.kind}")
            with self._lock:
                fam._render(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict:
        """JSON-able dump: {name: {kind, series: {label-str: value|hist}}}."""
        self._collect()
        out: Dict = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                series = {}
                for key, v in fam._series_items():
                    label = ",".join(
                        f"{n}={x}"
                        for n, x in zip(fam.label_names, key)) or ""
                    if isinstance(v, dict):
                        series[label] = {
                            "count": v["count"], "sum": v["sum"],
                            "counts": list(v["counts"]),
                            "buckets": list(fam.buckets),
                        }
                    else:
                        series[label] = v
                out[name] = {"kind": fam.kind, "series": series}
        return out


# -- shared percentile math (offline benchmarks use the same buckets) -------

def histogram_counts(values, buckets: Sequence[float]
                     = DEFAULT_LATENCY_BUCKETS_MS) -> List[int]:
    """Bucket a value list exactly as ``Histogram.observe`` does.

    Returns ``len(buckets) + 1`` counts; the last slot is the +Inf bucket.
    """
    counts = [0] * (len(buckets) + 1)
    bkts = list(buckets)
    for v in values:
        counts[bisect.bisect_left(bkts, float(v))] += 1
    return counts


def percentile_from_counts(counts: Sequence[int], buckets: Sequence[float],
                           p: float) -> float:
    """Bucket-interpolated percentile (Prometheus ``histogram_quantile``
    style: linear within the winning bucket, lower bound 0 for the first)."""
    total = sum(counts)
    if total == 0:
        return float("nan")
    rank = (p / 100.0) * total
    cum = 0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(buckets):          # +Inf bucket: no upper bound
                return float(buckets[-1])
            lo = 0.0 if i == 0 else float(buckets[i - 1])
            hi = float(buckets[i])
            frac = (rank - prev_cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(buckets[-1]) if buckets else float("nan")


def summarize_latency(values_ms, pcts: Sequence[float] = (50.0, 95.0),
                      buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                      ) -> Dict[str, float]:
    """Benchmark-side percentile summary on the shared bucket ladder.

    ``{"p50": ..., "p95": ...}`` computed through the very same bucket
    definitions the online histograms use, so offline BENCH numbers and
    ``/metrics`` percentiles are directly comparable (both carry the same
    bucket-resolution error, instead of exact-vs-bucketed skew).
    """
    counts = histogram_counts(values_ms, buckets)
    return {f"p{int(p) if float(p).is_integer() else p}":
            percentile_from_counts(counts, buckets, p) for p in pcts}


# -- exposition parsing (tests + load-bench invariant checks) ---------------

def parse_prometheus(text: str) -> Dict[str, Dict[Tuple, float]]:
    """Parse text exposition into {metric_name: {label-tuple: value}}.

    Label tuples are sorted ``(name, value)`` pairs.  Raises ``ValueError``
    on a malformed line — the load benchmark treats that as a hard failure.
    """
    out: Dict[str, Dict[Tuple, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                labels_raw, value_raw = rest.rsplit("}", 1)
                labels = []
                for part in _split_labels(labels_raw):
                    ln, _, lv = part.partition("=")
                    if not (lv.startswith('"') and lv.endswith('"')):
                        raise ValueError("unquoted label value")
                    labels.append((ln.strip(), lv[1:-1]))
                key = tuple(sorted(labels))
            else:
                name, value_raw = line.rsplit(None, 1)
                key = ()
            value = float(value_raw.strip().replace("+Inf", "inf"))
        except Exception as e:
            raise ValueError(
                f"malformed exposition line {lineno}: {line!r} ({e})"
            ) from None
        out.setdefault(name.strip(), {})[key] = value
    return out


def _split_labels(raw: str) -> List[str]:
    """Split ``a="x",b="y"`` on commas outside quotes."""
    parts, buf, quoted = [], [], False
    for ch in raw:
        if ch == '"':
            quoted = not quoted
        if ch == "," and not quoted:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in (s.strip() for s in parts) if p]
