"""The port's durability and WAL replication layer, mirrored from the JAX
package's tests, and held against that package across the two.

Mirrors (engines on ``device="cpu"``, the plain search path):
``tests/test_faults.py`` — ``TestMutationWAL``, ``TestRecovery``,
``TestSubprocessCrash`` (the child imports ``repro_torch``),
``TestSupervision`` and ``TestIndexCompatibility``; the index checkpoint
round trips of ``tests/test_backends.py``; ``tests/test_replication.py`` —
``TestWALCursor``, ``TestRecoverCorners`` and ``TestReplicaApplier``; and
``tests/test_engine.py::test_profile_stages_covers_schedule``.

Across packages: a state directory (snapshot + WAL tail) written by either
package is recovered by the other and searched with results equal to the
writer's; one mutation sequence gives byte-identical WAL segments in both;
a port follower tails a ``repro`` primary; a ``repro`` index checkpoint
loads into the port.

Tolerance: ids, sizes and counters are compared exactly; scores
``rtol=1e-5, atol=1e-4`` (the engine-parity tolerance: XLA and torch sum
the float32 products in another order).  Every blocking wait carries a
timeout so a broken path fails the test instead of hanging the suite.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.engine import RetrievalEngine as JEngine
from repro_torch.engine import (
    DriverStopped,
    EngineDriver,
    FaultPlan,
    FaultToleranceConfig,
    IndexMismatch,
    InjectedFault,
    MutationWAL,
    PrimaryReplication,
    ReplicaApplier,
    RetrievalEngine,
    Supervisor,
    SupervisorGaveUp,
    WALCursor,
    WALError,
    WALGap,
)

RNG = np.random.default_rng(41)
D = 16
WAIT = 30.0
RTOL, ATOL = 1e-5, 1e-4
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

# tight supervision knobs so watchdog tests converge in milliseconds
FAST_FT = dict(heartbeat_timeout_s=0.15, backoff_initial_s=0.01,
               backoff_max_s=0.05)


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


def wait_until(pred, timeout=WAIT, msg="condition"):
    deadline = time.perf_counter() + timeout
    while not pred():
        assert time.perf_counter() < deadline, f"timed out waiting: {msg}"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# WAL unit behavior (tests/test_faults.py::TestMutationWAL)
# ---------------------------------------------------------------------------
class TestMutationWAL:
    def test_append_replay_round_trip(self, tmp_path):
        wal = MutationWAL(str(tmp_path))
        assert wal.append("add", {"start": 0, "n": 2}) == 0
        assert wal.append("delete", {"ids": [1]}) == 1
        wal.close()
        wal2 = MutationWAL(str(tmp_path))
        recs = list(wal2.replay())
        assert [(r.seq, r.kind) for r in recs] == [(0, "add"), (1, "delete")]
        assert recs[1].payload["ids"] == [1]
        assert wal2.last_seq == 1 and not wal2.torn_tail

    def test_replay_after_seq_skips_prefix(self, tmp_path):
        wal = MutationWAL(str(tmp_path))
        for i in range(5):
            wal.append("add", {"i": i})
        assert [r.seq for r in wal.replay(after_seq=2)] == [3, 4]

    def test_torn_tail_truncated_and_appendable(self, tmp_path):
        wal = MutationWAL(str(tmp_path))
        wal.append("add", {"i": 0})
        wal.append("add", {"i": 1})
        wal.close()
        [log] = [p for p in os.listdir(tmp_path) if p.endswith(".log")]
        path = os.path.join(tmp_path, log)
        # crash mid-append: chop the last record in half
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 7)
        wal2 = MutationWAL(str(tmp_path))
        assert wal2.torn_tail
        assert wal2.last_seq == 0                 # seq 1 was torn away
        assert wal2.append("add", {"i": "next"}) == 1
        assert [r.seq for r in wal2.replay()] == [0, 1]

    def test_corrupt_record_stops_replay(self, tmp_path):
        wal = MutationWAL(str(tmp_path))
        wal.append("add", {"i": 0})
        off_ok = os.path.getsize(
            os.path.join(tmp_path, "wal-000000000000.log"))
        wal.append("add", {"i": 1})
        wal.close()
        path = os.path.join(tmp_path, "wal-000000000000.log")
        with open(path, "r+b") as f:             # flip a payload byte
            f.seek(off_ok + 9)
            byte = f.read(1)
            f.seek(off_ok + 9)
            f.write(bytes([byte[0] ^ 0xFF]))
        wal2 = MutationWAL(str(tmp_path))
        assert [r.seq for r in wal2.replay()] == [0]
        assert wal2.torn_tail

    def test_rotate_and_prune(self, tmp_path):
        wal = MutationWAL(str(tmp_path))
        for i in range(3):
            wal.append("add", {"i": i})
        wal.rotate()
        assert wal.lag == 0 and wal.n_segments == 2
        wal.append("add", {"i": 3})
        assert wal.lag == 1
        # seqs 0..2 are covered: the old segment goes, the active one stays
        assert wal.prune(2) == 1
        assert wal.n_segments == 1
        assert [r.seq for r in wal.replay()] == [3]
        wal.close()

    def test_closed_wal_refuses_appends(self, tmp_path):
        wal = MutationWAL(str(tmp_path))
        wal.close()
        with pytest.raises(WALError, match="closed"):
            wal.append("add", {})

    def test_every_append_is_fsynced(self, tmp_path, monkeypatch):
        """The default WAL fsyncs each record before ``append`` returns,
        so an engine acknowledges only mutations that are on disk."""
        eng, _ = make_engine(n_docs=0)
        eng.enable_durability(str(tmp_path))
        assert eng.wal.fsync
        synced = []
        real = os.fsync
        monkeypatch.setattr(os, "fsync",
                            lambda fd: (synced.append(fd), real(fd))[1])
        eng.add_docs(RNG.normal(size=(2, D)).astype(np.float32))
        assert len(synced) == 1
        eng.delete_docs([0])
        assert len(synced) == 2
        eng.wal.close()


# ---------------------------------------------------------------------------
# engine durability: WAL + snapshots + recover() (TestRecovery)
# ---------------------------------------------------------------------------
def durable_engine(tmp_path, n_docs=48, **kw):
    # durability first, THEN the seed corpus: every row is WAL-covered
    eng, _ = make_engine(n_docs=0, **kw)
    eng.enable_durability(str(tmp_path))
    db = RNG.normal(size=(n_docs, D)).astype(np.float32)
    if n_docs:
        eng.add_docs(db)
    return eng, db


class TestRecovery:
    def test_wal_only_recovery_no_snapshot(self, tmp_path):
        eng, db = durable_engine(tmp_path)
        extra = RNG.normal(size=(4, D)).astype(np.float32)
        ids = eng.add_docs(extra)
        eng.delete_docs(ids[:1])
        eng.wal.close()

        eng2, _ = make_engine(n_docs=0)
        report = eng2.recover(str(tmp_path))
        assert report["status"] == "ok"
        assert report["snapshot_step"] is None
        assert report["replayed"] == 3            # seed add + add + delete
        assert eng2.n_docs == eng.n_docs
        np.testing.assert_array_equal(
            eng2.search(db[:4])[1], eng.search(db[:4])[1])

    def test_snapshot_plus_tail_replay(self, tmp_path):
        eng, db = durable_engine(tmp_path)
        eng.search(db[:2])                        # build index state
        eng.save_snapshot()
        post = RNG.normal(size=(3, D)).astype(np.float32)
        ids = eng.add_docs(post)                  # lands in the WAL tail
        eng.delete_docs([0])
        eng.wal.close()

        eng2, _ = make_engine(n_docs=0)
        report = eng2.recover(str(tmp_path))
        assert report["snapshot_step"] is not None
        assert report["replayed"] == 2
        assert report["fallbacks"] == 0
        assert eng2.n_docs == eng.n_docs
        # tail-added docs retrievable; deleted doc stays deleted
        _, idx = eng2.search(post)
        np.testing.assert_array_equal(idx[:, 0], ids)
        assert 0 not in eng2.search(db[:1])[1][0]

    def test_recovered_engine_keeps_logging(self, tmp_path):
        eng, db = durable_engine(tmp_path)
        eng.wal.close()
        eng2, _ = make_engine(n_docs=0)
        eng2.recover(str(tmp_path))
        more = RNG.normal(size=(2, D)).astype(np.float32)
        ids = eng2.add_docs(more)
        eng2.wal.close()
        eng3, _ = make_engine(n_docs=0)
        eng3.recover(str(tmp_path))
        _, idx = eng3.search(more)
        np.testing.assert_array_equal(idx[:, 0], ids)

    def test_corrupt_newest_snapshot_falls_back(self, tmp_path):
        eng, db = durable_engine(tmp_path)
        eng.save_snapshot()
        eng.add_docs(RNG.normal(size=(2, D)).astype(np.float32))
        path2 = eng.save_snapshot()
        # corrupt the NEWEST snapshot's arrays
        npz = os.path.join(path2, "arrays.npz")
        blob = bytearray(open(npz, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(npz, "wb").write(bytes(blob))
        eng.wal.close()

        eng2, _ = make_engine(n_docs=0)
        report = eng2.recover(str(tmp_path))
        assert report["fallbacks"] == 1
        # the older snapshot + the 'add' WAL record reconstruct everything
        assert report["replayed"] >= 1
        assert eng2.n_docs == eng.n_docs

    def test_torn_wal_tail_reported(self, tmp_path):
        eng, _ = durable_engine(tmp_path)
        eng.wal.close()
        wal_dir = os.path.join(tmp_path, "wal")
        [log] = sorted(p for p in os.listdir(wal_dir) if p.endswith(".log"))
        path = os.path.join(wal_dir, log)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
        eng2, _ = make_engine(n_docs=0)
        report = eng2.recover(str(tmp_path))
        assert report["wal_truncated"]
        assert eng2.n_docs == 0                   # seed add record was torn

    def test_recover_rejects_mismatched_config(self, tmp_path):
        eng, _ = durable_engine(tmp_path)
        eng.save_snapshot()
        eng.wal.close()
        other = RetrievalEngine(D, d_start=4, k0=8, buckets=(1,),
                                capacity=64, backend="quantized",
                                backend_opts={"min_rebuild_rows": 16},
                                device="cpu")
        with pytest.raises(IndexMismatch, match="backend"):
            other.recover(str(tmp_path))

    def test_wal_validation_precedes_logging(self, tmp_path):
        """A rejected mutation must not leave a WAL record behind (it
        would diverge on replay)."""
        eng, _ = durable_engine(tmp_path)
        seq_before = eng.wal.last_seq
        with pytest.raises(ValueError):
            eng.add_docs(np.zeros((2, D + 3), np.float32))
        with pytest.raises(ValueError):
            eng.add_docs(torch.zeros((2, D + 3)))
        with pytest.raises(ValueError):
            eng.add_docs(np.zeros((2, D), np.float32),
                         metadata=[{"a": 1}])          # 1 dict for 2 rows
        with pytest.raises(IndexError):
            eng.delete_docs([10_000])
        assert eng.wal.last_seq == seq_before

    def test_snapshot_requires_durability(self):
        eng, _ = make_engine()
        with pytest.raises(RuntimeError, match="durability"):
            eng.save_snapshot()

    def test_snapshot_prunes_wal_segments(self, tmp_path):
        eng, _ = durable_engine(tmp_path, fault=FaultToleranceConfig(
            snapshot_keep=1))
        for _ in range(3):
            eng.add_docs(RNG.normal(size=(2, D)).astype(np.float32))
            eng.save_snapshot()
        assert eng.wal.lag == 0
        # keep=1: only the newest snapshot's tail segment (+ active) remain
        assert eng.wal.n_segments <= 2

    def test_tenant_and_metadata_survive_recovery(self, tmp_path):
        eng, _ = make_engine(n_docs=0)
        eng.enable_durability(str(tmp_path))
        a = RNG.normal(size=(3, D)).astype(np.float32)
        b = RNG.normal(size=(3, D)).astype(np.float32)
        ids_a = eng.add_docs(a, tenant="alice",
                             metadata=[{"lang": "en"}] * 3)
        eng.add_docs(b, tenant="bob", metadata=[{"lang": "fr"}] * 3)
        eng.save_snapshot()
        c = RNG.normal(size=(2, D)).astype(np.float32)
        ids_c = eng.add_docs(c, tenant="alice",
                             metadata=[{"lang": "de"}] * 2)
        eng.wal.close()

        eng2, _ = make_engine(n_docs=0)
        eng2.recover(str(tmp_path))
        assert sorted(eng2.store.tenants()) == ["alice", "bob"]
        assert eng2.store.tenant_doc_count("alice") == 5
        _, idx = eng2.search(c[:1], tenant="alice", filter={"lang": "de"})
        assert idx[0, 0] == ids_c[0]
        # snapshot-covered rows kept their tenant column too
        _, idx = eng2.search(a[:1], tenant="alice")
        assert idx[0, 0] == ids_a[0]

    def test_tensor_adds_logged_and_replayed_bit_exact(self, tmp_path):
        """``add_docs`` takes tensors on the engine's device: the log holds
        their float32 bytes and replay restores the same bits."""
        eng, _ = make_engine(n_docs=0)
        eng.enable_durability(str(tmp_path))
        rows = torch.from_numpy(RNG.normal(size=(6, D)).astype(np.float32))
        eng.add_docs(rows[:4])
        eng.add_docs(rows[4])                      # one (D,) row
        eng.add_docs(rows[5:].double())            # cast to float32 once
        eng.wal.close()
        eng2, _ = make_engine(n_docs=0)
        assert eng2.recover(str(tmp_path))["replayed"] == 3
        assert torch.equal(eng2.store.db[:6], rows)
        assert torch.equal(eng2.store.db[:6], eng.store.db[:6])

    def test_counters_and_wal_gauge(self, tmp_path):
        eng, _ = durable_engine(tmp_path, n_docs=8)
        eng.delete_docs([1, 2])
        eng.wal.close()
        eng2, _ = make_engine(n_docs=0)
        eng2.recover(str(tmp_path))
        st = eng2.stats.summary()
        assert (st["n_recoveries"], st["n_replayed"]) == (1, 2)
        assert eng2.last_recovery["replayed"] == 2
        text = eng2.metrics.render_prometheus()
        assert "repro_engine_wal_replayed_total 2" in text
        assert 'repro_wal_state{key="last_seq"} 1' in text
        eng2.wal.close()


class TestSubprocessCrash:
    """The durability contract against real process death: a child engine
    acknowledges mutations (fsync'd WAL), gets SIGKILLed mid-churn, and the
    parent must recover every acknowledged doc — no lost acks, no tombstone
    resurrection."""

    CHILD = r"""
import os, sys, numpy as np
sys.path.insert(0, {src!r})
from repro_torch.engine import RetrievalEngine

eng = RetrievalEngine({d}, d_start=4, k0=8, buckets=(1,), capacity=64,
                      block_n=32, device="cpu")
eng.enable_durability({state!r})
rng = np.random.default_rng(5)
ack = open(os.path.join({state!r}, "acked.log"), "a")
os.write(1, b"ready\n")
i = 0
while True:
    vecs = rng.normal(size=(2, {d})).astype(np.float32) + i
    ids = eng.add_docs(vecs)
    if i % 5 == 4:
        eng.delete_docs(ids[:1])
        note = f"del {{ids[0]}}\n"
    else:
        note = ""
    # ack AFTER the engine returned: the WAL record is already fsync'd
    ack.write(f"add {{ids[0]}} {{ids[1]}}\n" + note)
    ack.flush(); os.fsync(ack.fileno())
    i += 1
"""

    @pytest.mark.slow
    def test_sigkill_loses_no_acked_mutation(self, tmp_path):
        state = str(tmp_path)
        code = self.CHILD.format(src=os.path.abspath(SRC), d=D, state=state)
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.PIPE)
        try:
            assert proc.stdout.readline().strip() == b"ready"
            # let it churn, then kill it mid-flight — no warning, no flush
            time.sleep(0.6)
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=WAIT)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()

        acked_adds, acked_dels = set(), set()
        with open(os.path.join(state, "acked.log")) as f:
            for line in f:
                kind, *ids = line.split()
                if kind == "add":
                    acked_adds.update(int(x) for x in ids)
                else:
                    acked_dels.add(int(ids[0]))
        assert len(acked_adds) > 4, "child died before doing real work"

        eng, _ = make_engine(n_docs=0)
        report = eng.recover(state)
        assert report["status"] == "ok"
        live = acked_adds - acked_dels
        for doc_id in sorted(live):
            assert eng.store.is_live(doc_id), \
                f"acked doc {doc_id} lost by recovery"
        for doc_id in sorted(acked_dels):
            assert not eng.store.is_live(doc_id), \
                f"tombstoned doc {doc_id} resurrected"
        # recovered corpus actually serves: every live doc is retrievable
        some = sorted(live)[:4]
        q = np.stack([eng.store.db[i].numpy() for i in some])
        _, idx = eng.search(q)
        np.testing.assert_array_equal(idx[:, 0], some)


# ---------------------------------------------------------------------------
# driver supervision (TestSupervision)
# ---------------------------------------------------------------------------
class TestSupervision:
    def test_supervised_crash_restarts_and_serves(self):
        eng, db = make_engine(fault=FaultToleranceConfig(
            inject="dispatch:crash@once=1", **FAST_FT))
        driver = EngineDriver(eng, max_wait_ms=0.0)
        driver.start(supervised=True)
        sup = Supervisor(driver).start()
        try:
            bad = driver.submit(db[0])
            # the crashed dispatch fails its own chunk...
            with pytest.raises(DriverStopped):
                bad.result(WAIT)
            # ...the supervisor revives the thread and service resumes
            wait_until(lambda: driver.stats.n_restarts >= 1,
                       msg="supervisor restart")
            res = driver.retrieve(db[1], timeout=WAIT)
            assert res.doc_ids[0] == 1
            assert driver.stats.n_driver_crashes == 1
            assert driver.supervisor is sup
        finally:
            sup.stop()
            driver.stop()

    def test_pending_queue_survives_crash(self):
        """Requests queued BEHIND the crashing batch are served by the
        replacement thread — nobody but the crashed chunk pays."""
        eng, db = make_engine(fault=FaultToleranceConfig(
            inject="dispatch:crash@once=1", **FAST_FT))
        driver = EngineDriver(eng, max_wait_ms=5.0, max_queue=64)
        futs = [driver.submit(db[i]) for i in range(5)]
        driver.start(supervised=True)
        sup = Supervisor(driver).start()
        try:
            survivors = [f.result(WAIT).doc_ids[0] for f in futs
                         if f.exception(WAIT) is None]
            assert len(survivors) >= 1            # replacement served them
            assert driver.stats.n_driver_crashes == 1
        finally:
            sup.stop()
            driver.stop()

    def test_hung_thread_detected_and_replaced(self):
        eng, db = make_engine(fault=FaultToleranceConfig(
            inject="dispatch:hang@once=1,s=1.5", **FAST_FT))
        driver = EngineDriver(eng, max_wait_ms=0.0)
        driver.start(supervised=True)
        sup = Supervisor(driver).start()
        try:
            slow = driver.submit(db[0])          # dispatch wedges 1.5s
            time.sleep(0.05)
            quick = driver.submit(db[1])         # queues behind the hang
            res = quick.result(WAIT)             # replacement must serve it
            assert res.doc_ids[0] == 1
            assert driver.stats.n_restarts >= 1
            assert sup.last_cause == "hung"
            # the wedged thread eventually finishes its own dispatch and
            # stands down; its client still gets the (late) answer
            assert slow.result(WAIT).doc_ids[0] == 0
        finally:
            sup.stop()
            driver.stop()

    def test_crash_storm_gives_up_after_max_restarts(self):
        eng, db = make_engine(fault=FaultToleranceConfig(
            inject="dispatch:crash@every=1", max_restarts=2, **FAST_FT))
        driver = EngineDriver(eng, max_wait_ms=0.0, max_queue=64)
        driver.start(supervised=True)
        sup = Supervisor(driver).start()
        try:
            futs = [driver.submit(db[i % len(db)]) for i in range(12)]
            wait_until(lambda: sup.gave_up, msg="supervisor give-up")
            for f in futs:
                with pytest.raises(DriverStopped):
                    f.result(WAIT)
            with pytest.raises(DriverStopped):
                driver.submit(db[0])
            assert driver.stats.n_restarts == 2
            with pytest.raises(SupervisorGaveUp):
                driver.stop()
        finally:
            sup.stop()
        assert sup.summary()["gave_up"] and not sup.summary()["running"]

    def test_unsupervised_crash_stays_fatal(self):
        eng, db = make_engine(fault=FaultToleranceConfig(
            inject="dispatch:crash@once=1"))
        driver = EngineDriver(eng, max_wait_ms=0.0).start()
        fut = driver.submit(db[0])
        with pytest.raises(DriverStopped):
            fut.result(WAIT)
        wait_until(lambda: not driver.running, msg="driver going fatal")
        with pytest.raises(DriverStopped):
            driver.submit(db[1])
        with pytest.raises(BaseException, match="injected crash"):
            driver.stop()

    def test_manual_restart_without_supervisor(self):
        eng, db = make_engine(fault=FaultToleranceConfig(
            inject="dispatch:crash@once=1"))
        driver = EngineDriver(eng, max_wait_ms=0.0)
        driver.start(supervised=True)
        try:
            bad = driver.submit(db[0])
            with pytest.raises(DriverStopped):
                bad.result(WAIT)
            wait_until(lambda: driver.health()["crashed"],
                       msg="crash recorded")
            assert driver.restart()
            assert driver.retrieve(db[2], timeout=WAIT).doc_ids[0] == 2
            assert driver.stats.n_restarts == 1
        finally:
            driver.stop()

    def test_restart_refuses_non_running_driver(self):
        eng, _ = make_engine()
        driver = EngineDriver(eng)
        assert not driver.restart()               # never started
        driver.start()
        driver.stop()
        assert not driver.restart()               # already stopped

    def test_health_snapshot_fields(self):
        eng, db = make_engine()
        with EngineDriver(eng, max_wait_ms=0.0) as driver:
            driver.retrieve(db[0], timeout=WAIT)
            h = driver.health()
        assert h["state"] in ("running", "stopped")
        assert h["thread_alive"] in (True, False)
        assert h["n_pending"] == 0
        assert h["heartbeat_age_s"] >= 0.0
        assert not h["crashed"]


# ---------------------------------------------------------------------------
# index/config compatibility gate (TestIndexCompatibility)
# ---------------------------------------------------------------------------
def _backend_variants():
    return [
        ("flat", "flat", {}),
        ("ivf", "ivf", dict(n_lists=6, n_probe=3, min_index_rows=16,
                            min_rebuild_rows=8)),
        ("ivf_kernel", "ivf", dict(n_lists=6, n_probe=3, min_index_rows=16,
                                   min_rebuild_rows=8, use_kernel=True,
                                   kernel_block_m=16)),
        ("ivf_pq", "ivf", dict(n_lists=6, n_probe=3, min_index_rows=16,
                               min_rebuild_rows=8, use_kernel=True,
                               kernel_block_m=16, stage0_dtype="pq")),
        ("quantized", "quantized", dict(min_rebuild_rows=8)),
        ("quantized_pq", "quantized", dict(min_rebuild_rows=8, codec="pq")),
    ]


def _cpu_engine(d, backend, opts):
    return RetrievalEngine(d, d_start=4, k0=8, buckets=(1,), capacity=64,
                           block_n=32, backend=backend, backend_opts=opts,
                           device="cpu")


class TestIndexCompatibility:
    @pytest.mark.parametrize("variant,backend,opts", _backend_variants())
    def test_load_rejects_wrong_dim(self, tmp_path, variant, backend, opts):
        eng = _cpu_engine(D, backend, opts)
        eng.add_docs(RNG.normal(size=(40, D)).astype(np.float32))
        eng.search(RNG.normal(size=(1, D)).astype(np.float32))
        assert eng.save_index(str(tmp_path)) is not None

        wrong = _cpu_engine(D * 2, backend, opts)
        wrong.add_docs(RNG.normal(size=(40, D * 2)).astype(np.float32))
        with pytest.raises(IndexMismatch, match="d_emb"):
            wrong.load_index(str(tmp_path))

    @pytest.mark.parametrize("variant,backend,opts", _backend_variants())
    def test_load_rejects_wrong_backend_kind(self, tmp_path, variant,
                                             backend, opts):
        eng = _cpu_engine(D, backend, opts)
        eng.add_docs(RNG.normal(size=(40, D)).astype(np.float32))
        eng.search(RNG.normal(size=(1, D)).astype(np.float32))
        eng.save_index(str(tmp_path))

        other_kind = "quantized" if backend != "quantized" else "ivf"
        other_opts = (dict(min_rebuild_rows=8) if other_kind == "quantized"
                      else dict(n_lists=6, n_probe=3, min_index_rows=16,
                                min_rebuild_rows=8))
        other = _cpu_engine(D, other_kind, other_opts)
        other.add_docs(RNG.normal(size=(40, D)).astype(np.float32))
        with pytest.raises(IndexMismatch, match="backend"):
            other.load_index(str(tmp_path))

    def test_round_trip_same_config_still_works(self, tmp_path):
        opts = dict(min_rebuild_rows=8)
        eng = _cpu_engine(D, "quantized", opts)
        db = RNG.normal(size=(40, D)).astype(np.float32)
        eng.add_docs(db)
        eng.search(db[:1])
        eng.save_index(str(tmp_path))
        twin = _cpu_engine(D, "quantized", opts)
        twin.add_docs(db)
        assert twin.load_index(str(tmp_path))
        np.testing.assert_array_equal(
            twin.search(db[:4])[1], eng.search(db[:4])[1])


# ---------------------------------------------------------------------------
# index checkpoint round trips (tests/test_backends.py::TestIndexCheckpoint)
# ---------------------------------------------------------------------------
BD = 32
BACKENDS = ("flat", "ivf", "quantized", "ivf_kernel", "ivf_pq",
            "quantized_pq")


def opts_for(backend):
    return {
        "flat": None,
        "ivf": dict(n_lists=12, n_probe=6, min_index_rows=32,
                    min_rebuild_rows=16),
        "ivf_kernel": dict(n_lists=12, n_probe=6, min_index_rows=32,
                           min_rebuild_rows=16, use_kernel=True,
                           kernel_block_m=16),
        "ivf_pq": dict(n_lists=12, n_probe=6, min_index_rows=32,
                       min_rebuild_rows=16, use_kernel=True,
                       kernel_block_m=16, stage0_dtype="pq"),
        "quantized": dict(min_rebuild_rows=16),
        "quantized_pq": dict(min_rebuild_rows=16, codec="pq"),
    }[backend]


def backend_engine(backend, n_docs=200, seed=7, package="port"):
    kind = backend.split("_")[0] if backend != "flat" else "flat"
    kw = dict(d_start=8, k0=16, buckets=(4,), capacity=64, block_n=64,
              backend=kind, backend_opts=opts_for(backend))
    eng = (RetrievalEngine(BD, device="cpu", **kw) if package == "port"
           else JEngine(BD, **kw))
    db = np.random.default_rng(seed).normal(size=(n_docs, BD)).astype(
        np.float32)
    eng.add_docs(db)
    return eng, db


class TestIndexCheckpoint:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_round_trip_identical_results(self, backend, tmp_path):
        eng, db = backend_engine(backend)
        s1, i1 = eng.search(db[:8])
        eng.save_index(str(tmp_path))

        eng2, _ = backend_engine(backend)            # same corpus, no build
        assert eng2.load_index(str(tmp_path))
        assert eng2.stats.n_rebuilds == 0            # the point of loading
        s2, i2 = eng2.search(db[:8])
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-5)
        # staleness restarts clean: nothing to rebuild right after load
        assert not eng2.backend.needs_rebuild(
            eng2.index_state, eng2.store.stats())

    @pytest.mark.parametrize("backend", ("ivf", "quantized_pq"))
    def test_loaded_state_serves_mutations(self, backend, tmp_path):
        eng, db = backend_engine(backend)
        eng.search(db[:1])
        eng.save_index(str(tmp_path))
        eng2, _ = backend_engine(backend)
        assert eng2.load_index(str(tmp_path))
        new = RNG.normal(size=(3, BD)).astype(np.float32) * 5.0
        ids = eng2.add_docs(new)
        _, got = eng2.search(new)
        np.testing.assert_array_equal(got[:, 0], ids)
        eng2.delete_docs([7])
        _, after = eng2.search(db[7:8])
        assert 7 not in after

    def test_missing_checkpoint_returns_false(self, tmp_path):
        eng, _ = backend_engine("flat")
        assert not eng.load_index(str(tmp_path / "nope"))

    def test_backend_kind_mismatch_raises(self, tmp_path):
        eng, db = backend_engine("ivf")
        eng.search(db[:1])
        eng.save_index(str(tmp_path))
        eng2, _ = backend_engine("quantized")
        with pytest.raises(ValueError, match="backend"):
            eng2.load_index(str(tmp_path))

    def test_codec_mismatch_raises(self, tmp_path):
        eng, db = backend_engine("quantized_pq")
        eng.search(db[:1])
        eng.save_index(str(tmp_path))
        eng2, _ = backend_engine("quantized")
        with pytest.raises(ValueError, match="codec"):
            eng2.load_index(str(tmp_path))

    def test_oversized_index_rejected(self, tmp_path):
        eng, db = backend_engine("ivf")
        eng.search(db[:1])
        eng.save_index(str(tmp_path))
        eng2, _ = backend_engine("ivf", n_docs=20)   # smaller corpus
        with pytest.raises(ValueError, match="re-add the corpus"):
            eng2.load_index(str(tmp_path))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_reference_index_loads_into_port(self, backend, tmp_path):
        """An index checkpoint ``repro`` saved serves in the port with no
        rebuild and the reference's ids."""
        jeng, db = backend_engine(backend, package="repro")
        q = db[:8] + 0.01
        s1, i1 = jeng.search(q)
        jeng.save_index(str(tmp_path))
        peng, _ = backend_engine(backend)
        assert peng.load_index(str(tmp_path))
        s2, i2 = peng.search(q)
        assert peng.stats.n_rebuilds == 0
        np.testing.assert_array_equal(i2, i1)
        np.testing.assert_allclose(s2, s1, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# replication: WALCursor, recover() corners, ReplicaApplier
# (tests/test_replication.py)
# ---------------------------------------------------------------------------
def fresh_engine(capacity=256):
    return RetrievalEngine(D, d_start=8, k0=8, final_k=4, buckets=(1, 2),
                           capacity=capacity, block_n=64, device="cpu")


def make_primary(state_dir, n_docs=6):
    eng = fresh_engine()
    eng.enable_durability(state_dir)
    if n_docs:
        eng.add_docs(RNG.normal(size=(n_docs, D)).astype(np.float32))
    return eng


class TestWALCursor:
    def test_poll_returns_records_in_seq_order_once(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        for i in range(5):
            wal.append("add", {"i": i})
        cur = WALCursor(str(tmp_path))
        recs = cur.poll()
        assert [r.seq for r in recs] == [0, 1, 2, 3, 4]
        assert cur.applied_seq == 4
        assert cur.poll() == []                 # nothing new: no re-read
        wal.append("add", {"i": 5})
        assert [r.seq for r in cur.poll()] == [5]
        wal.close()

    def test_poll_spans_rotation(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        wal.append("add", {})
        wal.rotate()
        wal.append("add", {})
        wal.rotate()
        wal.append("add", {})
        cur = WALCursor(str(tmp_path))
        assert [r.seq for r in cur.poll()] == [0, 1, 2]
        wal.close()

    def test_max_records_resumes_where_it_stopped(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        for _ in range(6):
            wal.append("add", {})
        cur = WALCursor(str(tmp_path))
        assert [r.seq for r in cur.poll(max_records=2)] == [0, 1]
        assert [r.seq for r in cur.poll(max_records=3)] == [2, 3, 4]
        assert [r.seq for r in cur.poll()] == [5]
        wal.close()

    def test_seek_rewinds_and_skips(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        for _ in range(4):
            wal.append("add", {})
        cur = WALCursor(str(tmp_path))
        cur.poll()
        cur.seek(1)
        assert [r.seq for r in cur.poll()] == [2, 3]
        cur.seek(10)                            # ahead of the tail: nothing
        assert cur.poll() == []
        wal.close()

    def test_prune_behind_cursor_is_invisible(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        for _ in range(3):
            wal.append("add", {})
        cur = WALCursor(str(tmp_path))
        assert len(cur.poll()) == 3
        wal.rotate()
        wal.append("add", {})
        assert wal.prune(upto_seq=2) == 1       # the consumed segment
        assert [r.seq for r in cur.poll()] == [3]
        assert cur.poll() == []

        # and pruning between two polls of the SAME segment set
        wal.rotate()
        wal.append("add", {})
        wal.prune(upto_seq=3)
        assert [r.seq for r in cur.poll()] == [4]
        wal.close()

    def test_prune_ahead_of_cursor_raises_gap(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        for _ in range(3):
            wal.append("add", {})
        wal.rotate()
        wal.append("add", {})
        wal.prune(upto_seq=2)                   # drops seqs 0-2
        cur = WALCursor(str(tmp_path))          # wants everything from 0
        with pytest.raises(WALGap):
            cur.poll()
        wal.close()

    def test_torn_newest_tail_returns_clean_prefix(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        for _ in range(3):
            wal.append("add", {"pad": "x" * 64})
        wal.close()
        segs = sorted(os.listdir(tmp_path))
        path = os.path.join(tmp_path, segs[-1])
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)   # tear the last record
        cur = WALCursor(str(tmp_path))
        recs = cur.poll()                       # no raise: writer mid-append
        assert [r.seq for r in recs] == [0, 1]
        assert cur.poll() == []

    def test_last_available_seq_and_lag(self, tmp_path):
        wal = MutationWAL(str(tmp_path), fsync=False)
        cur = WALCursor(str(tmp_path))
        assert cur.last_available_seq() == -1
        assert cur.lag() == 0
        for _ in range(4):
            wal.append("add", {})
        assert cur.last_available_seq() == 3
        assert cur.lag() == 4
        cur.poll()
        assert cur.lag() == 0
        wal.close()

    def test_missing_dir_is_empty_not_error(self, tmp_path):
        cur = WALCursor(str(tmp_path / "nonexistent"))
        assert cur.poll() == []
        assert cur.lag() == 0


class TestLastAvailableSeqTail:
    """The port's cursor parses the newest segment on from where its last
    ``last_available_seq`` stopped (a deep health probe calls it four
    times, and one logged add can be hundreds of MB); the value is always
    the full scan's."""

    @staticmethod
    def full_scan(wal_dir):
        from repro_torch.engine import wal as W

        first, path = W._list_segments(wal_dir)[-1]
        recs, _clean, _torn = W._scan_segment(path)
        return recs[-1].seq if recs else first - 1

    def test_equals_full_scan_through_appends_rotation_and_tears(
            self, tmp_path):
        from repro_torch.engine import wal as W

        d = str(tmp_path)
        cur = WALCursor(d)
        assert cur.last_available_seq() == -1
        wal = MutationWAL(d, fsync=False)
        assert cur.last_available_seq() == self.full_scan(d) == -1
        for i in range(3):
            wal.append("add", {"i": i})
            assert cur.last_available_seq() == self.full_scan(d) == i
        wal.rotate()
        assert cur.last_available_seq() == self.full_scan(d) == 2
        wal.append("add", {"i": 3})
        assert cur.last_available_seq() == self.full_scan(d) == 3
        wal.close()
        path = W._list_segments(d)[-1][1]
        with open(path, "ab") as f:
            f.write(b"\x07" * 11)                  # a writer mid-append
        assert cur.last_available_seq() == self.full_scan(d) == 3
        wal = MutationWAL(d, fsync=False)         # truncates the tear
        wal.append("add", {"i": 4})
        assert cur.last_available_seq() == self.full_scan(d) == 4
        wal.close()
        os.truncate(path, os.path.getsize(path) - 3)   # shrank: from 0
        assert cur.last_available_seq() == self.full_scan(d) == 3

    def test_a_second_call_parses_only_new_bytes(self, tmp_path,
                                                monkeypatch):
        from repro_torch.engine import wal as W

        d = str(tmp_path)
        wal = MutationWAL(d, fsync=False)
        wal.append("add", {"blob": b"\0" * 100_000})
        cur = WALCursor(d)
        assert cur.last_available_seq() == 0
        offsets = []
        real = W._scan_tail

        def counting(path, offset):
            offsets.append(offset)
            return real(path, offset)

        monkeypatch.setattr(W, "_scan_tail", counting)
        assert cur.last_available_seq() == 0
        wal.append("add", {"i": 1})
        assert cur.last_available_seq() == 1
        wal.close()
        assert len(offsets) == 2 and min(offsets) > 100_000


class TestRecoverCorners:
    def test_primary_empty_state_dir(self, tmp_path):
        eng = fresh_engine()
        report = eng.recover(str(tmp_path))
        assert report["snapshot_step"] is None
        assert report["replayed"] == 0
        assert eng.n_docs == 0
        assert isinstance(eng.wal, MutationWAL)  # durability is now armed
        eng.add_docs(RNG.normal(size=(2, D)).astype(np.float32))
        assert eng.wal.last_seq == 0
        eng.wal.close()

    def test_follower_empty_state_dir(self, tmp_path):
        eng = fresh_engine()
        applier = ReplicaApplier(eng, str(tmp_path))
        report = applier.bootstrap()
        assert report["snapshot_step"] is None
        assert applier.applied_seq == -1
        assert applier.ready()                  # nothing to lag behind
        assert eng.wal is None                  # follower never opens a WAL
        assert applier.catch_up() == 0

    def test_primary_snapshot_with_zero_wal_tail(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=5)
        prim.save_snapshot()
        prim.wal.close()
        eng = fresh_engine()
        report = eng.recover(str(tmp_path))
        assert report["snapshot_step"] is not None
        assert report["replayed"] == 0
        assert eng.n_docs == 5

    def test_follower_snapshot_with_zero_wal_tail(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=5)
        prim.save_snapshot()
        foll = fresh_engine()
        applier = ReplicaApplier(foll, str(tmp_path))
        report = applier.bootstrap()
        assert report["snapshot_step"] is not None
        assert foll.n_docs == 5
        assert applier.catch_up() == 0          # nothing past the snapshot
        assert applier.applied_seq == prim.wal.last_seq
        prim.wal.close()

    def test_primary_wal_only(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=4)
        prim.delete_docs([0])
        prim.wal.close()
        eng = fresh_engine()
        report = eng.recover(str(tmp_path))
        assert report["snapshot_step"] is None
        assert report["replayed"] == 2          # one add batch + one delete
        assert eng.n_docs == 3                  # live docs: 4 added - 1
        assert not eng.store.is_live(0)
        eng.wal.close()

    def test_follower_wal_only(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=4)
        prim.delete_docs([0])
        foll = fresh_engine()
        applier = ReplicaApplier(foll, str(tmp_path))
        report = applier.bootstrap()
        assert report["snapshot_step"] is None
        assert applier.catch_up() == 2
        assert foll.n_docs == 3                 # live docs: 4 added - 1
        assert not foll.store.is_live(0)
        assert applier.applied_seq == prim.wal.last_seq
        prim.wal.close()


class TestReplicaApplier:
    def test_catch_up_tracks_primary(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=6)
        foll = fresh_engine()
        applier = ReplicaApplier(foll, str(tmp_path))
        applier.bootstrap()
        applier.catch_up()
        assert foll.n_docs == prim.n_docs
        prim.add_docs(RNG.normal(size=(3, D)).astype(np.float32))
        prim.delete_docs([1])
        assert applier.lag() > 0
        applier.catch_up()
        assert applier.lag() == 0
        assert foll.store.n_active == prim.store.n_active
        assert not foll.store.is_live(1)
        # the follower serves the primary's corpus
        q = prim.store.db[2].numpy()[None]
        _, ids = foll.search(q)
        assert ids[0, 0] == 2
        prim.wal.close()

    def test_wait_for_seq(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=2)
        foll = fresh_engine()
        applier = ReplicaApplier(foll, str(tmp_path))
        applier.bootstrap()
        want = prim.wal.last_seq
        assert not applier.wait_for_seq(want, timeout_s=0.05)
        applier.catch_up()
        assert applier.wait_for_seq(want, timeout_s=0.05)
        assert PrimaryReplication(prim).wait_for_seq(want, timeout_s=0.0)
        prim.wal.close()

    def test_gap_triggers_rebootstrap(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=4)
        foll = fresh_engine()
        applier = ReplicaApplier(foll, str(tmp_path))
        applier.bootstrap()                     # cursor at seq -1 (no snap)
        # primary snapshots, rotates, and prunes the records the follower
        # never saw: tailing must detect the gap and re-bootstrap
        prim.save_snapshot()
        prim.add_docs(RNG.normal(size=(2, D)).astype(np.float32))
        prim.wal.prune(prim.wal.last_seq - 1)
        assert applier.catch_up() == 0          # the re-bootstrap tick
        assert applier.n_bootstraps == 2
        applier.catch_up()
        assert applier.applied_seq == prim.wal.last_seq
        assert foll.n_docs == prim.n_docs
        prim.wal.close()

    def test_fault_sites_are_retried_not_skipped(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=3)
        foll = fresh_engine()
        foll.faults = FaultPlan.parse(
            "wal_ship:error@first=1;replica_apply:error@first=1")
        applier = ReplicaApplier(foll, str(tmp_path))
        applier.bootstrap()
        with pytest.raises(InjectedFault):      # wal_ship fires on poll
            applier.catch_up()
        assert applier.catch_up() == 0          # replica_apply fires
        assert applier.n_apply_errors == 1
        applier.catch_up()                      # clean: the record was NOT
        assert applier.applied_seq == prim.wal.last_seq   # skipped
        assert foll.n_docs == prim.n_docs
        prim.wal.close()

    def test_background_thread_converges(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=4)
        foll = fresh_engine()
        applier = ReplicaApplier(foll, str(tmp_path), poll_s=0.01)
        applier.bootstrap()
        applier.start()
        try:
            prim.add_docs(RNG.normal(size=(2, D)).astype(np.float32))
            wait_until(lambda: applier.applied_seq == prim.wal.last_seq,
                       msg="applier tails the live WAL")
            assert applier.ready()
        finally:
            applier.stop()
            prim.wal.close()
        assert applier.status()["role"] == "follower"

    def test_apply_replicated_refuses_wal_owner(self, tmp_path):
        prim = make_primary(str(tmp_path), n_docs=1)
        with pytest.raises(WALError):
            prim.apply_replicated(object())
        prim.wal.close()


# ---------------------------------------------------------------------------
# profile_stages (tests/test_engine.py::test_profile_stages_covers_schedule)
# ---------------------------------------------------------------------------
def test_profile_stages_covers_schedule():
    eng = RetrievalEngine(32, d_start=8, k0=16, final_k=4, buckets=(1, 4),
                          capacity=64, block_n=64, device="cpu")
    db = np.random.default_rng(5).normal(size=(50, 32)).astype(np.float32)
    eng.add_docs(db)
    prof = eng.profile_stages(db[:2], runs=1)
    assert [p["dim"] for p in prof] == [s.dim for s in eng.sched.stages]
    assert [p["k"] for p in prof] == [s.k for s in eng.sched.stages]
    assert all(p["ms"] >= 0 for p in prof)
    assert [p["stage"] for p in prof] == list(range(len(eng.sched.stages)))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
XKW = dict(d_start=8, k0=16, final_k=4, buckets=(1, 4), capacity=32,
           block_n=64, compact_dead_frac=0.3)


def _engine(package, **kw):
    kw = {**XKW, **kw}
    return (RetrievalEngine(D, device="cpu", **kw) if package == "port"
            else JEngine(D, **kw))


def _mutate(eng, rng, phase):
    """A seeded mutation sequence: adds with tenants and metadata, deletes
    that pass the compaction threshold (compacted at ``maybe_rebuild``),
    more adds; the same calls for either package."""
    if phase == 0:
        eng.add_docs(rng.normal(size=(40, D)).astype(np.float32))
        eng.add_docs(rng.normal(size=(12, D)).astype(np.float32),
                     tenant="acme", metadata=[{"lang": "en" if j % 2 else
                                               "de", "n": j}
                                              for j in range(12)])
        eng.delete_docs([int(x) for x in rng.choice(52, 20, replace=False)])
        eng.maybe_rebuild()                          # forced compaction
        eng.add_docs(rng.normal(size=(6, D)).astype(np.float32),
                     metadata={"lang": "fr"})
    else:
        eng.add_docs(rng.normal(size=(9, D)).astype(np.float32),
                     tenant="beta")
        eng.delete_docs([1, 3, 5])
        eng.add_docs(rng.normal(size=(30, D)).astype(np.float32),
                     tenant="acme", metadata={"lang": "de"})


def _write_state(package, state_dir, seed=13):
    eng = _engine(package)
    eng.enable_durability(str(state_dir))
    rng = np.random.default_rng(seed)
    _mutate(eng, rng, 0)
    assert eng.stats.n_compactions == 1
    eng.search(rng.normal(size=(2, D)).astype(np.float32))
    eng.save_snapshot()
    _mutate(eng, rng, 1)
    eng.wal.close()
    return eng


def _counters(eng):
    st = eng.store
    return (st.size, st.n_active, st.capacity, st.generation,
            st.total_added, st.total_deleted, st.n_compactions,
            sorted(st.tenants()), eng.stats.n_docs_added,
            eng.stats.n_docs_deleted, eng.stats.n_compactions)


def _assert_same_search(got_eng, want_eng, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(11, D)).astype(np.float32)
    for kw in ({}, {"tenant": "acme"}, {"tenant": "acme",
                                         "filter": {"lang": "de"}}):
        gs, gi = got_eng.search(q, **kw)
        ws, wi = want_eng.search(q, **kw)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
        fin = np.isfinite(ws)
        np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)


class TestAcrossPackages:
    @pytest.mark.parametrize("writer,reader", [("repro", "port"),
                                               ("port", "repro")])
    def test_recovery_both_ways(self, tmp_path, writer, reader):
        live = _write_state(writer, tmp_path)
        eng = _engine(reader)
        report = eng.recover(str(tmp_path))
        assert report["snapshot_step"] is not None
        assert (report["replayed"], report["fallbacks"]) == (3, 0)
        # the reader serves the writer's corpus: same stamps, same results
        twin = _engine(writer)
        twin.recover(str(tmp_path))
        assert _counters(eng)[:8] == _counters(live)[:8] == \
            _counters(twin)[:8]
        _assert_same_search(eng, live, seed=5)
        np.testing.assert_array_equal(np.asarray(eng.store.valid),
                                      np.asarray(live.store.valid))
        eng.wal.close()
        twin.wal.close()

    def test_wal_segments_byte_identical(self, tmp_path):
        def segments(wal_dir):
            return {name: open(os.path.join(wal_dir, name), "rb").read()
                    for name in sorted(os.listdir(wal_dir))}

        logs = {}
        for package in ("port", "repro"):
            state = tmp_path / package
            eng = _engine(package)
            eng.enable_durability(str(state))
            rng = np.random.default_rng(13)
            _mutate(eng, rng, 0)
            before = segments(state / "wal")     # the snapshot prunes it
            eng.save_snapshot()
            _mutate(eng, rng, 1)
            eng.wal.close()
            logs[package] = (before, segments(state / "wal"),
                             eng.wal.last_seq)
        assert logs["port"] == logs["repro"]
        before, after, last_seq = logs["port"]
        assert list(before) == ["wal-000000000000.log"]
        assert list(after) == ["wal-000000000005.log"]
        assert last_seq == 7             # 5 records, the snapshot, 3 more

    def test_port_follower_tails_reference_primary(self, tmp_path):
        prim = _engine("repro")
        prim.enable_durability(str(tmp_path))
        rng = np.random.default_rng(17)
        _mutate(prim, rng, 0)
        prim.save_snapshot()
        foll = _engine("port")
        applier = ReplicaApplier(foll, str(tmp_path))
        assert applier.bootstrap()["snapshot_step"] is not None
        _mutate(prim, rng, 1)
        assert applier.catch_up() == 3
        assert applier.applied_seq == prim.wal.last_seq
        assert _counters(foll)[:8] == _counters(prim)[:8]
        _assert_same_search(foll, prim, seed=6)
        prim.add_docs(rng.normal(size=(4, D)).astype(np.float32))
        prim.delete_docs([0, 2])
        assert applier.lag() == 2
        assert applier.catch_up() == 2 and applier.lag() == 0
        _assert_same_search(foll, prim, seed=7)
        prim.wal.close()
