"""The port's observability spine, mirrored from the JAX package's
``tests/test_obs.py``: metrics registry, trace spans, slow-query log.

Covers the `repro_torch.obs` unit surface (label cardinality caps,
histogram bucket math, concurrent increments, Prometheus exposition golden
format) and the wired engine/driver behaviour: span monotonicity under a
racing add/delete workload, slow-query logging via an injected sleepy
backend, and an 8-thread stats hammer that reconciles every counter
against the number of results actually delivered.  Engines run on
``device="cpu"`` (the plain search path).
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.engine import EngineDriver, RetrievalEngine, SearchRequest
from repro_torch.engine.config import ObsConfig
from repro_torch.index_backends.flat import FlatProgressiveBackend
from repro_torch.obs import (
    DEFAULT_LATENCY_BUCKETS_MS,
    MARK_ORDER,
    MetricsRegistry,
    NULL_INSTRUMENT,
    SlowQueryLog,
    TraceContext,
    TraceRing,
    histogram_counts,
    parse_prometheus,
    percentile_from_counts,
    summarize_latency,
)

RNG = np.random.default_rng(7)


def cpu_engine(*args, **kw):
    """A ``RetrievalEngine`` on the CPU (the port's default device is CUDA)."""
    return RetrievalEngine(*args, device="cpu", **kw)


D = 16
WAIT = 30.0


def make_engine(n_docs=64, **kw):
    kw.setdefault("d_start", 4)
    kw.setdefault("k0", 8)
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("capacity", 256)
    kw.setdefault("block_n", 32)
    eng = cpu_engine(D, **kw)
    db = RNG.normal(size=(n_docs, D)).astype(np.float32)
    eng.add_docs(db)
    return eng, db


# -- registry ---------------------------------------------------------------

class TestRegistry:
    def test_counter_inc_and_value(self):
        reg = MetricsRegistry()
        c = reg.counter("x_total", "help")
        c.inc()
        c.inc(2.5)
        assert c.value() == pytest.approx(3.5)

    def test_counter_rejects_decrease(self):
        c = MetricsRegistry().counter("x_total")
        with pytest.raises(ValueError, match="cannot decrease"):
            c.inc(-1)

    def test_label_names_enforced(self):
        c = MetricsRegistry().counter("x_total", labels=("tenant",))
        with pytest.raises(ValueError, match="takes labels"):
            c.inc(route="/v1/search")
        with pytest.raises(ValueError, match="takes labels"):
            c.inc()                       # missing label entirely

    def test_duplicate_registration_must_match(self):
        reg = MetricsRegistry()
        c1 = reg.counter("x_total", labels=("a",))
        assert reg.counter("x_total", labels=("a",)) is c1
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total", labels=("a",))
        with pytest.raises(ValueError, match="already registered"):
            reg.counter("x_total", labels=("b",))

    def test_cardinality_cap_collapses_to_overflow(self):
        reg = MetricsRegistry(max_series=2)
        c = reg.counter("t_total", "per-tenant", labels=("tenant",))
        c.inc(tenant="a")
        c.inc(tenant="b")
        c.inc(tenant="c")                 # past the cap
        c.inc(tenant="d")
        c.inc(tenant="a")                 # existing series still direct
        assert c.value(tenant="a") == 2.0
        parsed = parse_prometheus(reg.render_prometheus())
        series = parsed["t_total"]
        assert series[(("tenant", "a"),)] == 2.0
        assert series[(("tenant", "__overflow__"),)] == 2.0
        assert (("tenant", "c"),) not in series

    def test_disabled_registry_hands_out_noop(self):
        reg = MetricsRegistry(enabled=False)
        c = reg.counter("x_total")
        assert c is NULL_INSTRUMENT
        c.inc()
        c.observe(1.0)
        assert c.value() == 0.0
        assert reg.render_prometheus().strip() == ""

    def test_concurrent_increments_lose_nothing(self):
        reg = MetricsRegistry()
        c = reg.counter("hits_total", labels=("tenant",))
        h = reg.histogram("lat_ms", buckets=(1.0, 10.0))
        n_threads, per_thread = 8, 500

        def worker(tid):
            for i in range(per_thread):
                c.inc(tenant=f"t{tid % 2}")
                h.observe(float(i % 20))

        ts = [threading.Thread(target=worker, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
        total = c.value(tenant="t0") + c.value(tenant="t1")
        assert total == n_threads * per_thread
        assert h.count() == n_threads * per_thread


class TestHistogram:
    def test_bucket_math_matches_offline_helper(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat_ms", buckets=(1.0, 5.0, 25.0))
        values = [0.2, 1.0, 1.1, 4.9, 5.0, 30.0, 100.0]
        for v in values:
            h.observe(v)
        snap = reg.snapshot()["lat_ms"]["series"][""]
        assert snap["counts"] == histogram_counts(values, (1.0, 5.0, 25.0))
        assert snap["count"] == len(values)
        assert snap["sum"] == pytest.approx(sum(values))

    def test_observe_on_bucket_boundary_counts_le(self):
        # Prometheus buckets are `le` (inclusive upper bound)
        counts = histogram_counts([1.0], (1.0, 5.0))
        assert counts == [1, 0, 0]

    def test_percentile_interpolation(self):
        buckets = (10.0, 20.0)
        counts = [10, 10, 0]              # uniform halves, nothing in +Inf
        assert percentile_from_counts(counts, buckets, 50.0) == \
            pytest.approx(10.0)
        assert percentile_from_counts(counts, buckets, 75.0) == \
            pytest.approx(15.0)
        assert percentile_from_counts(counts, buckets, 100.0) == \
            pytest.approx(20.0)

    def test_percentile_empty_is_nan(self):
        import math
        assert math.isnan(percentile_from_counts([0, 0], (1.0,), 50.0))

    def test_summarize_latency_keys_and_consistency(self):
        values = [float(v) for v in RNG.uniform(0.5, 400.0, size=200)]
        s = summarize_latency(values)
        assert set(s) == {"p50", "p95"}
        counts = histogram_counts(values)
        assert s["p95"] == pytest.approx(percentile_from_counts(
            counts, DEFAULT_LATENCY_BUCKETS_MS, 95.0))
        assert s["p50"] <= s["p95"]

    def test_bad_buckets_rejected(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError, match="ascending"):
            reg.histogram("h", buckets=(5.0, 1.0))


class TestPrometheusExposition:
    def test_golden_format(self):
        reg = MetricsRegistry()
        reg.counter("req_total", "requests served",
                    labels=("route",)).inc(3, route="/v1/search")
        reg.gauge("depth", "queue depth").set(7)
        h = reg.histogram("lat_ms", "latency", buckets=(1.0, 10.0))
        h.observe(0.5)
        h.observe(2.0)
        h.observe(99.0)
        text = reg.render_prometheus()
        assert text.splitlines() == [
            "# HELP depth queue depth",
            "# TYPE depth gauge",
            "depth 7",
            "# HELP lat_ms latency",
            "# TYPE lat_ms histogram",
            'lat_ms_bucket{le="1"} 1',
            'lat_ms_bucket{le="10"} 2',
            'lat_ms_bucket{le="+Inf"} 3',
            "lat_ms_sum 101.5",
            "lat_ms_count 3",
            "# HELP req_total requests served",
            "# TYPE req_total counter",
            'req_total{route="/v1/search"} 3',
        ]

    def test_parse_round_trip(self):
        reg = MetricsRegistry()
        reg.counter("a_total", labels=("x", "y")).inc(2, x="u,v", y="w")
        reg.histogram("h_ms", buckets=(1.0,)).observe(0.5)
        parsed = parse_prometheus(reg.render_prometheus())
        assert parsed["a_total"][(("x", "u,v"), ("y", "w"))] == 2.0
        assert parsed["h_ms_count"][()] == 1.0
        assert parsed["h_ms_bucket"][(("le", "+Inf"),)] == 1.0

    def test_parse_rejects_malformed(self):
        with pytest.raises(ValueError, match="malformed"):
            parse_prometheus("what even is this line {")
        with pytest.raises(ValueError, match="malformed"):
            parse_prometheus('m{l=unquoted} 1')


# -- trace primitives -------------------------------------------------------

class TestTrace:
    def test_spans_are_offsets_in_pipeline_order(self):
        tr = TraceContext(100.0)
        tr.mark("deliver", 100.5)         # insertion order != pipeline order
        tr.mark("dispatch", 100.2)
        spans = tr.spans_ms()
        assert list(spans) == ["submit", "dispatch", "deliver"]
        assert spans["submit"] == 0.0
        assert spans["dispatch"] == pytest.approx(200.0)
        assert spans["deliver"] == pytest.approx(500.0)
        assert list(spans) == [m for m in MARK_ORDER if m in spans]

    def test_ring_bounded_most_recent_kept(self):
        ring = TraceRing(capacity=4)
        for i in range(10):
            ring.push({"request_id": i})
        assert len(ring) == 4
        assert [r["request_id"] for r in ring.snapshot()] == [6, 7, 8, 9]
        assert [r["request_id"] for r in ring.snapshot(2)] == [8, 9]

    def test_ring_zero_capacity_drops_everything(self):
        ring = TraceRing(capacity=0)
        ring.push({"request_id": 1})
        assert len(ring) == 0 and ring.snapshot() == []

    def test_slow_log_thresholds(self):
        log = SlowQueryLog(threshold_ms=10.0)
        assert not log.maybe_log({"latency_ms": 9.9})
        assert log.maybe_log({"latency_ms": 10.0, "request_id": 5})
        assert log.n_logged == 1
        rec = log.recent()[0]
        assert rec["request_id"] == 5
        assert rec["slow_query_threshold_ms"] == 10.0

    def test_slow_log_disabled_by_none(self):
        log = SlowQueryLog(threshold_ms=None)
        assert not log.enabled
        assert not log.maybe_log({"latency_ms": 1e9})
        assert log.n_logged == 0


# -- engine wiring ----------------------------------------------------------

class TestEngineObs:
    def test_search_results_carry_spans(self):
        eng, db = make_engine()
        rid = eng.submit(db[3])
        eng.run_until_idle()
        res = eng.poll(rid)
        spans = res.stats.spans
        assert spans is not None
        for name in ("submit", "admit", "batch", "dispatch", "deliver"):
            assert name in spans
        ordered = [spans[m] for m in MARK_ORDER if m in spans]
        assert ordered == sorted(ordered)
        assert res.stats.stage0_ms is None          # fused fast path
        assert res.stats.rescore_ms is None

    def test_stage_fences_split_compute(self):
        eng, db = make_engine(obs=ObsConfig(stage_fences=True))
        plain = cpu_engine(D, d_start=4, k0=8, buckets=(1, 2, 4),
                                capacity=256, block_n=32)
        plain.add_docs(db)
        rid = eng.submit(db[5])
        eng.run_until_idle()
        res = eng.poll(rid)
        assert res.stats.stage0_ms is not None
        assert res.stats.rescore_ms is not None
        assert res.stats.stage0_ms + res.stats.rescore_ms == \
            pytest.approx(res.stats.compute_ms, rel=0.05, abs=0.5)
        assert {"stage0", "rescore"} <= set(res.stats.spans)
        # the fenced path returns the same top hit as the fused path
        rid2 = plain.submit(db[5])
        plain.run_until_idle()
        assert res.doc_ids[0] == plain.poll(rid2).doc_ids[0] == 5

    def test_metrics_surface_covers_components(self):
        eng, db = make_engine()
        for i in range(5):
            eng.submit(db[i])
        eng.run_until_idle()
        text = eng.metrics.render_prometheus()
        parsed = parse_prometheus(text)
        assert parsed["repro_engine_requests_completed_total"][()] == 5.0
        assert parsed["repro_engine_request_latency_ms_count"][()] == 5.0
        assert parsed["repro_engine_queue_depth"][()] == 0.0
        store = {k[0][1]: v for k, v in
                 parsed["repro_store_state"].items()}
        assert store["n_active"] == 64.0
        assert store["capacity"] == 256.0
        # the flat backend declares no gauges, but the family is exposed
        assert "# TYPE repro_backend_state gauge" in text
        # counters stay reconciled with the legacy stats surface
        s = eng.stats.summary()
        assert parsed["repro_engine_batches_total"][()] == s["n_batches"]

    def test_ivf_backend_gauges_published(self):
        eng = cpu_engine(
            D, d_start=4, k0=8, buckets=(1, 2, 4), capacity=256,
            block_n=32, backend="ivf",
            backend_opts=dict(n_lists=8, n_probe=4, min_index_rows=16,
                              min_rebuild_rows=16))
        db = RNG.normal(size=(64, D)).astype(np.float32)
        eng.add_docs(db)
        eng.submit(db[0])
        eng.run_until_idle()
        parsed = parse_prometheus(eng.metrics.render_prometheus())
        series = parsed["repro_backend_state"]
        assert {dict(k)["backend"] for k in series} == {"ivf"}
        gauges = {dict(k)["key"]: v for k, v in series.items()}
        assert gauges["built_size"] == 64.0
        assert {"tail_load", "tail_cap", "staleness_rows"} <= set(gauges)

    def test_trace_ring_collects_requests(self):
        eng, db = make_engine(obs=ObsConfig(trace_ring=3))
        for i in range(7):
            eng.submit(db[i])
            eng.run_until_idle()
        assert len(eng.trace_ring) == 3
        last = eng.trace_ring.snapshot()[-1]
        assert {"request_id", "latency_ms", "spans"} <= set(last)

    def test_obs_disabled_restores_bare_path(self):
        eng, db = make_engine(obs=ObsConfig(enabled=False))
        rid = eng.submit(db[0])
        eng.run_until_idle()
        res = eng.poll(rid)
        assert res.stats.spans is None              # no TraceContext at all
        assert len(eng.trace_ring) == 0
        assert eng.metrics.render_prometheus().strip() == ""
        # the legacy stats surface still works
        assert eng.stats.summary()["n_completed"] == 1


class SleepyBackend(FlatProgressiveBackend):
    """Flat backend with a host-side stall injected into every search —
    drives real per-dispatch latency for the slow-query-log test."""

    def __init__(self, *args, sleep_s=0.02, **kw):
        super().__init__(*args, **kw)
        self.sleep_s = sleep_s

    def search(self, *args, **kw):
        time.sleep(self.sleep_s)
        return super().search(*args, **kw)


class TestSlowQueryLog:
    def test_sleepy_backend_trips_the_log(self):
        from repro_torch.core import make_schedule

        sched = make_schedule(4, D, 8, final_k=1)
        backend = SleepyBackend(sched, metric="l2", block_n=32,
                                sleep_s=0.02)
        eng = cpu_engine(
            D, d_start=4, k0=8, buckets=(1, 2, 4), capacity=256,
            block_n=32, backend=backend,
            obs=ObsConfig(slow_query_ms=5.0))
        db = RNG.normal(size=(32, D)).astype(np.float32)
        eng.add_docs(db)
        for i in range(3):
            eng.submit(db[i])
            eng.run_until_idle()
        assert eng.slow_log.n_logged == 3
        recent = eng.slow_log.recent()
        assert all(r["latency_ms"] >= 5.0 for r in recent)
        assert all(r["slow_query_threshold_ms"] == 5.0 for r in recent)
        assert eng.metrics.counter(
            "repro_slow_queries_total").value() == 3.0

    def test_fast_requests_stay_unlogged(self):
        eng, db = make_engine(obs=ObsConfig(slow_query_ms=60_000.0))
        eng.submit(db[0])
        eng.run_until_idle()
        assert eng.slow_log.n_logged == 0
        assert eng.metrics.counter(
            "repro_slow_queries_total").value() == 0.0


# -- driver wiring ----------------------------------------------------------

class TestDriverObs:
    def test_span_monotonicity_under_racing_churn(self):
        eng, db = make_engine(n_docs=64, capacity=512)
        stop = threading.Event()

        def churn():
            i = 0
            while not stop.is_set():
                ids = eng.add_docs(
                    RNG.normal(size=(2, D)).astype(np.float32))
                eng.delete_docs(ids)
                i += 1
                time.sleep(0.001)

        churn_t = threading.Thread(target=churn)
        churn_t.start()
        try:
            with EngineDriver(eng, max_wait_ms=2.0) as driver:
                results = [driver.retrieve(db[i % 64], timeout=WAIT)
                           for i in range(24)]
        finally:
            stop.set()
            churn_t.join(WAIT)
        for res in results:
            spans = res.stats.spans
            assert spans is not None
            for name in ("submit", "admit", "batch", "dispatch", "deliver"):
                assert name in spans, f"missing {name}: {spans}"
            ordered = [spans[m] for m in MARK_ORDER if m in spans]
            assert ordered == sorted(ordered), spans
            assert spans["submit"] == 0.0
            assert spans["deliver"] == pytest.approx(
                res.stats.latency_ms, rel=1e-6, abs=1e-6)
        parsed = parse_prometheus(eng.metrics.render_prometheus())
        assert parsed["repro_driver_queue_wait_ms_count"][()] == 24.0
        assert parsed["repro_driver_requests_submitted_total"][()] == 24.0

    def test_stats_hammer_reconciles_exactly(self):
        """8 threads hammering submit/result; every total must equal the
        number of results actually delivered — no lost or double counts.
        Half the traffic is tenant-filtered so the store's mask-cache
        counters race the scrapes too (no torn reads: plain ints under
        engine.lock, mirrored whole at collect time)."""
        eng, db = make_engine(n_docs=64, capacity=256)
        eng.add_docs(RNG.normal(size=(16, D)).astype(np.float32),
                     tenant="obs")
        n_threads, per_thread = 8, 16
        delivered = []
        lock = threading.Lock()
        errors = []

        def client(tid):
            try:
                out = []
                for i in range(per_thread):
                    q = db[(tid * 7 + i) % 64]
                    req = (SearchRequest(q, tenant="obs") if i % 2
                           else q)
                    out.append(driver.retrieve(req, timeout=WAIT))
                with lock:
                    delivered.extend(out)
            except Exception as e:          # pragma: no cover - diagnostic
                errors.append(e)

        with EngineDriver(eng, max_wait_ms=1.0) as driver:
            ts = [threading.Thread(target=client, args=(t,))
                  for t in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(WAIT)
        assert not errors
        total = n_threads * per_thread
        assert len(delivered) == total
        assert all(r.stats.spans is not None for r in delivered)

        s = eng.stats.summary()
        ds = driver.stats.summary()
        assert s["n_submitted"] == s["n_completed"] == total
        assert ds["n_submitted"] == ds["n_completed"] == total
        assert ds["n_cancelled"] == ds["n_expired"] == 0

        parsed = parse_prometheus(eng.metrics.render_prometheus())
        assert parsed["repro_engine_requests_submitted_total"][()] == total
        assert parsed["repro_engine_requests_completed_total"][()] == total
        assert parsed["repro_engine_request_latency_ms_count"][()] == total
        assert parsed["repro_engine_request_queue_ms_count"][()] == total
        assert parsed["repro_driver_requests_completed_total"][()] == total
        assert parsed["repro_driver_queue_wait_ms_count"][()] == total
        # batch accounting: bucket-labelled flushes sum to the batch total
        flushes = sum(parsed["repro_driver_flush_total"].values())
        assert flushes == s["n_batches"]
        fills = sum(parsed["repro_engine_batch_bucket_total"].values())
        assert fills == s["n_batches"]
        # mask-cache counters: one key ("obs", no filter) and no epoch
        # bump mid-hammer => exactly one compile; the prometheus mirror
        # must equal the plain ints exactly (scrape-time set_total — a
        # torn read would show partial totals here)
        with eng.lock:
            mc = eng.store.mask_cache_stats()
        assert mc["misses"] == 1
        assert mc["hits"] >= 1
        assert mc["entries"] == 1
        assert parsed["repro_store_mask_cache_hits_total"][()] == mc["hits"]
        assert (parsed["repro_store_mask_cache_misses_total"][()]
                == mc["misses"])
