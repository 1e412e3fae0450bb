"""The port's async engine driver, mirrored from the JAX package's
``tests/test_driver.py``: deadline policy (fake clock), lifecycle
(start/stop/drain/abort), expired-request shedding, exception propagation,
backpressure, and multi-threaded stress against a mutating corpus.
Engines run on ``device="cpu"`` (the plain search path).

Every blocking wait in this file carries an explicit timeout so a
deadlocked driver fails the test instead of hanging the suite.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.engine import (
    BucketPolicy,
    DeadlineBatcher,
    DeadlineExceeded,
    DriverQueueFull,
    DriverStopped,
    EngineDriver,
    FaultToleranceConfig,
    RetrievalEngine,
    SearchRequest,
)

RNG = np.random.default_rng(23)


def cpu_engine(*args, **kw):
    """A ``RetrievalEngine`` on the CPU (the port's default device is CUDA)."""
    return RetrievalEngine(*args, device="cpu", **kw)


D = 16
WAIT = 30.0          # generous future timeout: only hit on driver bugs


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


class TestDeadlineBatcher:
    """Pure policy decisions under a fake clock — no threads, no sleeping."""

    POLICY = BucketPolicy((1, 2, 4, 8))

    def test_idle_when_empty(self):
        b = DeadlineBatcher(self.POLICY, max_wait_s=0.5)
        assert b.decide(0, 0.0, 100.0).action == "idle"

    def test_waits_before_deadline_with_exact_remaining(self):
        b = DeadlineBatcher(self.POLICY, max_wait_s=0.5)
        d = b.decide(3, oldest_arrival=10.0, now=10.2)
        assert d.action == "wait"
        assert d.wait_s == pytest.approx(0.3)

    def test_flushes_partial_batch_at_deadline(self):
        b = DeadlineBatcher(self.POLICY, max_wait_s=0.5)
        d = b.decide(3, oldest_arrival=10.0, now=10.5)
        assert (d.action, d.n, d.reason) == ("flush", 3, "deadline")
        # ... and well past it
        d = b.decide(3, oldest_arrival=10.0, now=99.0)
        assert (d.action, d.n, d.reason) == ("flush", 3, "deadline")

    def test_full_bucket_flushes_ignoring_deadline(self):
        b = DeadlineBatcher(self.POLICY, max_wait_s=1e9)
        d = b.decide(8, oldest_arrival=10.0, now=10.0)
        assert (d.action, d.n, d.reason) == ("flush", 8, "full")
        # oversized backlog still flushes exactly one top bucket
        d = b.decide(23, oldest_arrival=10.0, now=10.0)
        assert (d.action, d.n, d.reason) == ("flush", 8, "full")

    def test_zero_wait_flushes_on_arrival(self):
        b = DeadlineBatcher(self.POLICY, max_wait_s=0.0)
        d = b.decide(1, oldest_arrival=10.0, now=10.0)
        assert (d.action, d.n, d.reason) == ("flush", 1, "deadline")

    def test_negative_wait_rejected(self):
        with pytest.raises(ValueError, match="max_wait_s"):
            DeadlineBatcher(self.POLICY, max_wait_s=-0.001)

    def test_wait_shrinks_as_clock_advances(self):
        b = DeadlineBatcher(self.POLICY, max_wait_s=1.0)
        w1 = b.decide(2, 0.0, 0.25).wait_s
        w2 = b.decide(2, 0.0, 0.75).wait_s
        assert w1 == pytest.approx(0.75) and w2 == pytest.approx(0.25)
        assert w2 < w1


class TestLifecycle:
    def test_context_manager_serves_and_rejects_after_exit(self):
        eng, db = make_engine()
        with EngineDriver(eng, max_wait_ms=1.0) as driver:
            assert driver.running
            res = driver.retrieve(db[3], timeout=WAIT)
            assert res.doc_ids[0] == 3
        assert not driver.running
        with pytest.raises(DriverStopped):
            driver.submit(db[0])

    def test_double_start_raises(self):
        eng, _ = make_engine()
        driver = EngineDriver(eng).start()
        try:
            with pytest.raises(RuntimeError, match="already"):
                driver.start()
        finally:
            driver.stop()

    def test_stop_is_idempotent(self):
        eng, _ = make_engine()
        driver = EngineDriver(eng).start()
        driver.stop()
        driver.stop()                            # no error, no hang

    def test_stop_drain_completes_every_accepted_request(self):
        eng, db = make_engine()
        # huge deadline: nothing would flush on its own before stop()
        driver = EngineDriver(eng, max_wait_ms=60_000).start()
        futures = [driver.submit(db[i]) for i in range(11)]
        driver.stop(drain=True, timeout=WAIT)
        ids = [f.result(WAIT).doc_ids[0] for f in futures]
        assert ids == list(range(11))
        assert driver.stats.n_completed == 11
        assert driver.stats.n_cancelled == 0

    def test_stop_abort_cancels_pending_futures(self):
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000).start()
        futures = [driver.submit(db[i]) for i in range(3)]
        driver.stop(drain=False, timeout=WAIT)
        for f in futures:
            with pytest.raises(DriverStopped):
                f.result(WAIT)
        assert driver.stats.n_cancelled == 3

    def test_unstarted_driver_drains_inline_on_stop(self):
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000)
        fut = driver.submit(db[5])               # accepted before start()
        driver.stop(drain=True)
        assert fut.result(0).doc_ids[0] == 5

    def test_concurrent_abort_cannot_revoke_drain_promise(self):
        """A stop(drain=False) racing an in-progress stop(drain=True) must
        not flip the drain policy: every accepted request is still served."""
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000).start()
        futures = [driver.submit(db[i]) for i in range(9)]
        first = threading.Thread(
            target=driver.stop, kwargs={"drain": True}, daemon=True)
        first.start()
        # wait until the draining stop owns the shutdown...
        t0 = time.perf_counter()
        while driver.running and time.perf_counter() - t0 < WAIT:
            time.sleep(0.001)
        driver.stop(drain=False)                 # ...then try to abort it
        first.join(timeout=WAIT)
        assert not first.is_alive()
        ids = [f.result(WAIT).doc_ids[0] for f in futures]
        assert ids == list(range(9))
        assert driver.stats.n_cancelled == 0

    def test_stop_retry_after_timeout_can_abort(self):
        """Regression: a drain stop() whose join timed out left the driver
        wedged in the stopping state forever — a later stop(drain=False)
        could not downgrade the drain policy and reclaim the thread."""
        eng, db = make_engine(fault=FaultToleranceConfig(
            inject="dispatch:hang@every=1,s=0.4"))
        driver = EngineDriver(eng, max_wait_ms=0.0).start()
        futs = [driver.submit(db[i]) for i in range(4)]
        # every dispatch wedges 0.4s, so a short drain timeout must fire
        with pytest.raises(TimeoutError):
            driver.stop(drain=True, timeout=0.05)
        # the retry downgrades drain -> abort and reclaims the thread
        driver.stop(drain=False, timeout=WAIT)
        assert not driver.running
        for f in futs:                # served by the wedged dispatch, or
            try:                      # cancelled by the abort — never stuck
                f.result(WAIT)
            except DriverStopped:
                pass
        with pytest.raises(DriverStopped):
            driver.submit(db[0])

    def test_submit_during_drain_is_rejected(self):
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000)
        driver.submit(db[0])
        driver.stop(drain=True)
        with pytest.raises(DriverStopped):
            driver.submit(db[1])


class TestExpiredShedding:
    """Regression: a flushed group whose members ALL expired must not
    dispatch an empty batch, must count each shed exactly once in
    ``n_expired``, and must still count the flush under its reason."""

    def test_all_expired_group_never_dispatches(self):
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000)   # unstarted
        futs = [driver.submit(SearchRequest(db[i], deadline_ms=0.01))
                for i in range(3)]
        time.sleep(0.05)                      # every client budget expires
        batches_before = eng.stats.n_batches
        driver.stop(drain=True)               # inline drain forms the batch
        for f in futs:
            with pytest.raises(DeadlineExceeded):
                f.result(0)
        assert driver.stats.n_expired == 3    # each shed counted exactly once
        assert driver.stats.n_completed == 0
        assert driver.stats.n_flush_drain == 1   # the flush still happened
        assert eng.stats.n_batches == batches_before   # no empty dispatch

    def test_mixed_expiry_dispatches_survivors_once(self):
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000)
        dead = [driver.submit(SearchRequest(db[i], deadline_ms=0.01))
                for i in range(2)]
        live = [driver.submit(SearchRequest(db[i], deadline_ms=600_000.0))
                for i in range(2, 4)]
        time.sleep(0.05)
        batches_before = eng.stats.n_batches
        driver.stop(drain=True)
        for f in dead:
            with pytest.raises(DeadlineExceeded):
                f.result(0)
        assert [f.result(0).doc_ids[0] for f in live] == [2, 3]
        assert driver.stats.n_expired == 2
        assert driver.stats.n_completed == 2
        assert driver.stats.n_flush_drain == 1
        assert eng.stats.n_batches == batches_before + 1


class TestServing:
    def test_retrieve_matches_engine_search(self):
        eng, db = make_engine()
        q = db[:7] + 0.01 * RNG.normal(size=(7, D)).astype(np.float32)
        _, direct = eng.search(q)
        with EngineDriver(eng, max_wait_ms=0.0) as driver:
            got = np.stack(
                [driver.retrieve(v, timeout=WAIT).doc_ids for v in q])
        np.testing.assert_array_equal(got, direct)

    def test_full_bucket_flushes_without_waiting_deadline(self):
        eng, db = make_engine()
        eng.warmup()
        # deadline is a minute: only the full-bucket rule can flush in time
        with EngineDriver(eng, max_wait_ms=60_000) as driver:
            futures = [driver.submit(v) for v in db[:4]]
            ids = [f.result(WAIT).doc_ids[0] for f in futures]
        assert ids == [0, 1, 2, 3]
        assert driver.stats.n_flush_full == 1
        assert driver.stats.n_flush_deadline == 0

    def test_deadline_flushes_partial_batch(self):
        eng, db = make_engine()
        eng.warmup()
        with EngineDriver(eng, max_wait_ms=20.0) as driver:
            res = driver.retrieve(db[2], timeout=WAIT)   # lone request
        assert res.doc_ids[0] == 2
        assert res.stats.batch_fill == 1
        assert driver.stats.n_flush_deadline == 1

    def test_request_latency_includes_driver_queue_wait(self):
        eng, db = make_engine()
        eng.warmup()
        with EngineDriver(eng, max_wait_ms=50.0) as driver:
            res = driver.retrieve(db[0], timeout=WAIT)
        # the ~50ms deadline wait happened in the driver's queue, but it must
        # be charged to the request's engine-side latency split
        assert res.stats.queue_ms >= 25.0
        assert res.stats.latency_ms >= res.stats.queue_ms

    def test_backpressure_blocks_then_raises_queue_full(self):
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000, max_queue=2)
        driver.submit(db[0])
        driver.submit(db[1])                     # queue now full (not started)
        t0 = time.perf_counter()
        with pytest.raises(DriverQueueFull):
            driver.submit(db[2], timeout=0.05)
        assert time.perf_counter() - t0 >= 0.04  # it actually waited
        driver.stop(drain=False)

    def test_result_timeout_raises(self):
        eng, db = make_engine()
        driver = EngineDriver(eng, max_wait_ms=60_000)  # never started
        fut = driver.submit(db[0])
        with pytest.raises(TimeoutError):
            fut.result(0.05)
        driver.stop(drain=False)

    def test_dispatch_exception_propagates_and_driver_survives(self):
        eng, db = make_engine()
        eng.warmup()
        boom = {"armed": True}
        orig = eng.backend.search

        def exploding_search(*a, **kw):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected backend failure")
            return orig(*a, **kw)

        eng.backend.search = exploding_search
        try:
            with EngineDriver(eng, max_wait_ms=0.0) as driver:
                bad = driver.submit(db[0])
                with pytest.raises(RuntimeError, match="injected"):
                    bad.result(WAIT)
                assert bad.exception(0) is not None
                # the driver thread survived the batch failure
                ok = driver.retrieve(db[1], timeout=WAIT)
                assert ok.doc_ids[0] == 1
            assert driver.stats.n_batch_errors == 1
        finally:
            eng.backend.search = orig

    def test_future_exception_is_none_on_success(self):
        eng, db = make_engine()
        with EngineDriver(eng, max_wait_ms=0.0) as driver:
            fut = driver.submit(db[0])
            assert fut.exception(WAIT) is None
            assert fut.done()

    def test_bad_query_rejected_at_submit_not_in_driver_thread(self):
        eng, _ = make_engine()
        with EngineDriver(eng) as driver:
            with pytest.raises(ValueError, match="query vector"):
                driver.submit(np.zeros((3, D), np.float32))
        assert driver.stats.n_submitted == 0


class TestConcurrency:
    def test_stress_many_clients_racing_mutations(self):
        """≥ 8 client threads retrieving while mutators add/delete docs.

        Every future must resolve with ids that were valid at dispatch time
        (in-range or the -1 sentinel), and the engine's counters must
        reconcile exactly afterwards — the whole point of engine.lock.
        """
        n_clients, per_client = 8, 12
        # compaction off: it remaps the ids the mutators hold between their
        # add and delete calls (correct behavior, but it's the interleave
        # test in test_backends.py that exercises the remap protocol — this
        # test pins the locking/stats story with stable ids)
        eng, db = make_engine(n_docs=96, capacity=1024,
                              compact_dead_frac=None)
        eng.warmup()
        errors = []
        stop_mutating = threading.Event()

        def mutator(seed):
            rng = np.random.default_rng(seed)
            try:
                while not stop_mutating.is_set():
                    ids = eng.add_docs(
                        rng.normal(size=(3, D)).astype(np.float32))
                    eng.delete_docs(ids[:1])
                    time.sleep(0.001)
            except Exception as e:
                errors.append(e)

        def client(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(per_client):
                    q = db[rng.integers(len(db))]
                    res = driver.retrieve(q, timeout=WAIT)
                    ids = res.doc_ids
                    ok = (ids == -1) | ((ids >= 0) & (ids < 1 << 30))
                    assert ok.all(), f"malformed ids {ids}"
            except Exception as e:
                errors.append(e)

        with EngineDriver(eng, max_wait_ms=1.0, max_queue=64) as driver:
            mutators = [threading.Thread(target=mutator, args=(100 + i,),
                                         daemon=True) for i in range(2)]
            clients = [threading.Thread(target=client, args=(i,),
                                        daemon=True) for i in range(n_clients)]
            for t in mutators + clients:
                t.start()
            for t in clients:
                t.join(timeout=WAIT)
                assert not t.is_alive(), "client thread hung"
            stop_mutating.set()
            for t in mutators:
                t.join(timeout=WAIT)
                assert not t.is_alive(), "mutator thread hung"
        assert not errors, errors[:3]
        assert driver.stats.n_completed == n_clients * per_client
        s = eng.stats.summary()
        assert s["n_submitted"] == s["n_completed"] == n_clients * per_client
        assert s["n_docs_added"] == eng.store.total_added
        assert s["n_docs_deleted"] == eng.store.total_deleted

    def test_stats_counters_reconcile_under_races(self):
        """Race-detection for the engine-lock fix: unguarded ``+=`` on the
        stats counters from many threads drifts; with engine.lock the totals
        must reconcile exactly."""
        # compaction off: ids held across another thread's safe point would
        # be remapped (see test_backends.py for that protocol); counters are
        # what's under test here
        eng, db = make_engine(n_docs=32, capacity=2048,
                              compact_dead_frac=None)
        eng.warmup()
        n_threads, iters = 6, 25
        errors = []

        def hammer(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(iters):
                    ids = eng.add_docs(
                        rng.normal(size=(2, D)).astype(np.float32))
                    eng.delete_docs(ids[1:])
                    rid = eng.submit(db[rng.integers(len(db))])
                    eng.step()
                    eng.poll(rid)                # may be None if another
                    # thread's step served it; either way it was completed
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive(), "hammer thread hung"
        assert not errors, errors[:3]
        eng.run_until_idle()
        s = eng.stats.summary()
        total = n_threads * iters
        assert s["n_submitted"] == s["n_completed"] == total
        assert s["n_docs_added"] == eng.store.total_added == 32 + 2 * total
        assert s["n_docs_deleted"] == eng.store.total_deleted == total

    def test_driver_with_background_rebuilds_and_appends(self):
        """Background index rebuilds adopt at driver safe points while
        clients keep retrieving; appended docs stay reachable throughout."""
        eng = cpu_engine(
            D, d_start=4, k0=8, buckets=(1, 2, 4), capacity=512, block_n=32,
            backend="quantized", backend_opts={"min_rebuild_rows": 16},
            rebuild_mode="background",
        )
        rng = np.random.default_rng(3)
        base = rng.normal(size=(64, D)).astype(np.float32)
        eng.add_docs(base)
        eng.warmup()
        errors = []

        def client(seed):
            r = np.random.default_rng(seed)
            try:
                for _ in range(10):
                    i = r.integers(len(base))
                    res = driver.retrieve(base[i], timeout=WAIT)
                    assert (res.doc_ids >= -1).all()
            except Exception as e:
                errors.append(e)

        with EngineDriver(eng, max_wait_ms=0.5) as driver:
            threads = [threading.Thread(target=client, args=(i,), daemon=True)
                       for i in range(4)]
            for t in threads:
                t.start()
            # force churn past the rebuild threshold while clients run
            for _ in range(6):
                eng.add_docs(rng.normal(size=(8, D)).astype(np.float32))
                time.sleep(0.005)
            for t in threads:
                t.join(timeout=WAIT)
                assert not t.is_alive()
        assert not errors, errors[:3]
        # Churn (48 appended rows) is past the rebuild threshold; drive the
        # safe point until the background build is launched AND adopted —
        # deterministic, instead of hoping the clients' dispatches raced the
        # mutator at the right moments.
        deadline = time.perf_counter() + WAIT
        while eng.stats.n_rebuilds < 2:
            eng.maybe_rebuild()
            assert time.perf_counter() < deadline, "rebuild never adopted"
            time.sleep(0.01)
        # a fresh doc appended after all that is immediately retrievable
        probe = rng.normal(size=(1, D)).astype(np.float32) * 5.0
        [nid] = eng.add_docs(probe)
        _, idx = eng.search(probe)
        assert idx[0, 0] == nid
