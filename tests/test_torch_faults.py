"""The port's fault-injection harness and the fault paths that need no
durability layer, mirrored from the JAX package's ``tests/test_faults.py``:
fault-plan parsing and firing, background-rebuild retries, and poison-batch
bisection in the driver.  The WAL, snapshot, recovery, supervision and
index-persistence tests wait for the durability slice.

Everything here is deterministic: failures come from the seeded
`repro_torch.engine.faults.FaultPlan` harness.  Engines run on
``device="cpu"`` (the plain search path).  Every blocking wait carries a
timeout so a broken path fails the test instead of hanging the suite.
"""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.engine import (
    EngineDriver,
    FaultPlan,
    FaultToleranceConfig,
    InjectedFault,
    PoisonError,
    RequestFailed,
    RetrievalEngine,
)

RNG = np.random.default_rng(41)
D = 16
WAIT = 30.0


def make_engine(n_docs=48, fault=None, **kw):
    kw.setdefault("d_start", 4)
    kw.setdefault("k0", 8)
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("capacity", 64)
    kw.setdefault("block_n", 32)
    eng = RetrievalEngine(D, fault=fault, device="cpu", **kw)
    db = RNG.normal(size=(n_docs, D)).astype(np.float32)
    if n_docs:
        eng.add_docs(db)
    return eng, db


# ---------------------------------------------------------------------------
# fault-plan parsing + firing
# ---------------------------------------------------------------------------
class TestFaultPlan:
    def test_empty_spec_is_inert(self):
        plan = FaultPlan.parse("")
        assert plan.empty
        for _ in range(3):
            plan.check("dispatch")
        assert plan.summary() == {"calls": {}, "fired": {}}

    def test_once_fires_exactly_on_kth_call(self):
        plan = FaultPlan.parse("rebuild:error@once=2")
        plan.check("rebuild")
        with pytest.raises(InjectedFault):
            plan.check("rebuild")
        plan.check("rebuild")                     # 3rd call: quiet again
        assert plan.summary()["fired"] == {"rebuild:error": 1}

    def test_first_and_every_qualifiers(self):
        plan = FaultPlan.parse("wal_write:error@first=2")
        for _ in range(2):
            with pytest.raises(InjectedFault):
                plan.check("wal_write")
        plan.check("wal_write")
        plan = FaultPlan.parse("wal_write:error@every=2")
        plan.check("wal_write")
        with pytest.raises(InjectedFault):
            plan.check("wal_write")

    def test_probabilistic_rule_replays_identically(self):
        def draw():
            plan = FaultPlan.parse("dispatch:error@p=0.5", seed=9)
            out = []
            for _ in range(32):
                try:
                    plan.check("dispatch")
                    out.append(0)
                except InjectedFault:
                    out.append(1)
            return out

        assert draw() == draw()
        assert 0 < sum(draw()) < 32

    def test_poison_fires_only_on_marker_query(self):
        plan = FaultPlan.parse("dispatch:poison@v=123.0")
        clean = np.zeros(4, np.float32)
        bad = clean.copy()
        bad[0] = 123.0
        plan.check("dispatch", queries=[clean, clean])
        with pytest.raises(PoisonError):
            plan.check("dispatch", queries=[clean, bad])

    def test_bad_specs_rejected(self):
        for spec in ("nowhere:error@once=1",       # unknown site
                     "dispatch:melt@once=1",       # unknown action
                     "dispatch:error",             # never fires
                     "rebuild:poison@v=1.0",       # poison off-dispatch
                     "dispatch:poison",            # poison without marker
                     "dispatch:error@zap=1"):      # unknown qualifier
            with pytest.raises(ValueError):
                FaultPlan.parse(spec)

    def test_config_parses_spec_eagerly(self):
        with pytest.raises(ValueError):
            FaultToleranceConfig(inject="dispatch:bogus@once=1")


# ---------------------------------------------------------------------------
# rebuild retries
# ---------------------------------------------------------------------------
class TestRebuildRetry:
    def make_bg_engine(self, inject, retries=3):
        # warm the initial (sync) build with an inert plan, THEN arm the
        # faults and grow the corpus: only background rebuilds fail
        eng = RetrievalEngine(
            D, d_start=4, k0=8, buckets=(1, 2), capacity=256, block_n=32,
            backend="quantized", backend_opts={"min_rebuild_rows": 8},
            rebuild_mode="background",
            fault=FaultToleranceConfig(rebuild_retries=retries),
            device="cpu")
        db = RNG.normal(size=(48, D)).astype(np.float32)
        eng.add_docs(db)
        eng.search(db[:1])
        assert eng.stats.n_rebuilds == 1
        eng.faults = FaultPlan.parse(inject)
        eng.add_docs(RNG.normal(size=(48, D)).astype(np.float32))
        return eng, db

    def test_transient_failures_retried_to_success(self):
        eng, db = self.make_bg_engine("rebuild:error@first=2")
        deadline = time.perf_counter() + WAIT
        while eng.stats.n_rebuilds < 2:          # beyond the warm build
            eng.maybe_rebuild()
            assert time.perf_counter() < deadline, "rebuild never adopted"
            time.sleep(0.01)
        assert eng.stats.n_rebuild_failures == 2
        _, idx = eng.search(db[:4])
        np.testing.assert_array_equal(idx[:, 0], np.arange(4))

    def test_persistent_failure_escalates_past_budget(self):
        eng, _ = self.make_bg_engine("rebuild:error@first=50", retries=2)
        deadline = time.perf_counter() + WAIT
        with pytest.raises(RuntimeError, match="failed .* times in a row"):
            while time.perf_counter() < deadline:
                eng.maybe_rebuild()
                time.sleep(0.01)
        assert eng.stats.n_rebuild_failures == 3  # budget 2 + the last straw


# ---------------------------------------------------------------------------
# poison isolation by batch bisection
# ---------------------------------------------------------------------------
class TestPoisonBisection:
    def test_poison_request_fails_alone(self):
        eng, db = make_engine(buckets=(1, 2, 4), fault=FaultToleranceConfig(
            inject="dispatch:poison@v=777.0"))
        poison = db[1].copy()
        poison[0] = 777.0
        driver = EngineDriver(eng, max_wait_ms=60_000)   # unstarted: inline
        futs = [driver.submit(db[0]), driver.submit(poison),
                driver.submit(db[2]), driver.submit(db[3])]
        driver.stop(drain=True)
        with pytest.raises(RequestFailed, match="bisection"):
            futs[1].result(0)
        for i in (0, 2, 3):
            assert futs[i].result(0).doc_ids[0] == i
        assert driver.stats.n_quarantined == 1
        assert driver.stats.n_bisections >= 1
        assert driver.stats.n_completed == 3

    def test_bisect_disabled_fails_whole_batch(self):
        eng, db = make_engine(buckets=(1, 2, 4), fault=FaultToleranceConfig(
            inject="dispatch:poison@v=777.0", poison_bisect=False))
        poison = db[1].copy()
        poison[0] = 777.0
        driver = EngineDriver(eng, max_wait_ms=60_000)
        futs = [driver.submit(db[0]), driver.submit(poison),
                driver.submit(db[2]), driver.submit(db[3])]
        driver.stop(drain=True)
        for f in futs:
            with pytest.raises(PoisonError):
                f.result(0)
        assert driver.stats.n_quarantined == 0

    def test_two_poisons_both_isolated(self):
        eng, db = make_engine(buckets=(1, 2, 4), fault=FaultToleranceConfig(
            inject="dispatch:poison@v=777.0"))
        p1, p2 = db[0].copy(), db[3].copy()
        p1[0] = p2[0] = 777.0
        driver = EngineDriver(eng, max_wait_ms=60_000)
        futs = [driver.submit(p1), driver.submit(db[1]),
                driver.submit(db[2]), driver.submit(p2)]
        driver.stop(drain=True)
        for i in (0, 3):
            with pytest.raises(RequestFailed):
                futs[i].result(0)
        for i in (1, 2):
            assert futs[i].result(0).doc_ids[0] == i
        assert driver.stats.n_quarantined == 2

    def test_singleton_failure_propagates_raw(self):
        """A failing batch of ONE is not 'isolated' — the client sees the
        real exception (same contract as before bisection existed)."""
        eng, db = make_engine(buckets=(1,), fault=FaultToleranceConfig(
            inject="dispatch:poison@v=777.0"))
        poison = db[0].copy()
        poison[0] = 777.0
        driver = EngineDriver(eng, max_wait_ms=60_000)
        fut = driver.submit(poison)
        driver.stop(drain=True)
        with pytest.raises(PoisonError):
            fut.result(0)
        assert driver.stats.n_quarantined == 0
