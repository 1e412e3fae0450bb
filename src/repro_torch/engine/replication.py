"""WAL-shipped replication: a primary engine's mutation log replayed onto
read-only follower engines.

The primary needs no new machinery at all — its ``MutationWAL`` (the
durability log) *is* the replication stream.  Followers share the primary's
state directory (or a mirror of it) and:

1. **bootstrap** — restore the newest checksum-valid snapshot via the same
   ``_restore_newest_snapshot`` path ``recover()`` uses, but *without*
   opening the WAL (a follower must never truncate or extend the primary's
   live segment);
2. **catch up** — tail the WAL directory with a seq-keyed ``WALCursor`` and
   apply each record through ``engine.apply_replicated`` (the normal
   ``_apply_record`` mutation path, so tail injection, capacity doubling,
   and rebuild scheduling behave exactly as on the primary);
3. **report** — ``replica_lag`` (seq delta to the primary's durable tail)
   and an ``applied_seq`` high-water mark, the seq a read-your-writes
   ``min_seq`` wait blocks on.

If the primary's snapshot retention prunes records the follower has not
read yet (``WALGap`` — the follower fell too far behind), the applier
re-bootstraps from the newest snapshot instead of silently skipping
mutations.

``PrimaryReplication`` is the trivial counterpart a primary serves behind:
``applied_seq`` is the WAL's own durable tail, so one uniform object
answers readiness, status and ``min_seq`` waits on every role.

Fault sites: ``wal_ship`` fires before each tail poll, ``replica_apply``
before each record application — both consulted through the follower
engine's own ``FaultPlan`` so chaos tests inject deterministically.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from repro_torch.engine.wal import WALCursor, WALGap

__all__ = ["PrimaryReplication", "ReplicaApplier"]


class PrimaryReplication:
    """The primary's (degenerate) replication surface.

    Every sequence number the primary ever acknowledged is by definition
    already applied locally, so readiness is unconditional and ``min_seq``
    waits resolve instantly — the object exists so a serving layer treats
    primaries and followers uniformly.
    """

    role = "primary"

    def __init__(self, engine):
        if engine.wal is None:
            raise RuntimeError(
                "PrimaryReplication needs durability enabled — call "
                "engine.recover()/enable_durability() first")
        self.engine = engine

    @property
    def applied_seq(self) -> int:
        return self.engine.wal.last_seq

    def lag(self) -> int:
        return 0

    def ready(self) -> bool:
        return True

    def wait_for_seq(self, min_seq: int, timeout_s: float) -> bool:
        # a seq token can only come from an acked mutation, which the
        # primary applied before acking; anything larger is a client bug
        return self.engine.wal.last_seq >= int(min_seq)

    def status(self) -> Dict:
        return {
            "role": self.role,
            "applied_seq": self.applied_seq,
            "replica_lag": 0,
            "ready": True,
        }


class ReplicaApplier:
    """Tails a primary's WAL directory and applies records to a follower.

    ``bootstrap()`` restores the newest valid snapshot (tolerating an empty
    state dir — WAL-only startup) and positions the cursor just past it;
    ``start()`` then polls ``wal/`` every ``poll_s`` on a background thread,
    applying new records under ``engine.lock``.  ``wait_for_seq`` blocks a
    serving thread until the follower has applied at least ``min_seq``
    (read-your-writes), bounded by the caller's deadline.

    Transient apply/poll errors (including injected ``wal_ship`` /
    ``replica_apply`` faults) are counted and retried on the next tick; a
    ``WALGap`` triggers a re-bootstrap from the newest snapshot.
    """

    role = "follower"

    def __init__(self, engine, state_dir: str, *,
                 poll_s: Optional[float] = None,
                 ready_lag_max: Optional[int] = None):
        rcfg = engine.config.replication
        self.engine = engine
        self.state_dir = state_dir
        self.wal_dir = os.path.join(state_dir, "wal")
        self.poll_s = float(rcfg.poll_s if poll_s is None else poll_s)
        self.ready_lag_max = int(rcfg.ready_lag_max if ready_lag_max is None
                                 else ready_lag_max)
        self._cursor = WALCursor(self.wal_dir)
        self._cv = threading.Condition()
        self._applied_seq = -1
        self._bootstrapped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_bootstrap: Optional[Dict] = None
        self.last_error: Optional[str] = None
        self.n_applied = 0
        self.n_bootstraps = 0
        self.n_poll_errors = 0
        self.n_apply_errors = 0

    # -- lifecycle -----------------------------------------------------------
    def bootstrap(self) -> Dict:
        """Restore the newest valid snapshot and position the WAL cursor.

        An empty state dir is fine (the follower starts from nothing and
        replays the whole WAL); so is WAL-only startup (no snapshot yet).
        Returns a report like ``recover()``'s, kept as ``last_bootstrap``.
        """
        t0 = time.perf_counter()
        report: Dict = {"status": "ok", "snapshot_step": None,
                        "fallbacks": 0, "duration_ms": 0.0}
        with self.engine.lock:
            if self.engine.wal is not None:
                raise RuntimeError(
                    "follower engine has its own WAL open — followers "
                    "replicate the primary's log, they do not write one")
            wal_seq = self.engine._restore_newest_snapshot(
                self.state_dir, report)
            with self._cv:
                self._cursor.seek(wal_seq)
                self._applied_seq = wal_seq
                self._bootstrapped = True
                self._cv.notify_all()
        report["duration_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_bootstrap = report
        self.n_bootstraps += 1
        return report

    def start(self) -> None:
        """Start the background tailing thread (bootstraps first if the
        caller has not)."""
        if not self._bootstrapped:
            self.bootstrap()
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="replica-applier", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.catch_up()
            except Exception as e:             # keep tailing: transient
                self.last_error = f"{type(e).__name__}: {e}"
                self.n_poll_errors += 1
            self._stop.wait(self.poll_s)

    # -- applying ------------------------------------------------------------
    def catch_up(self, max_records: Optional[int] = None) -> int:
        """Poll the WAL tail once and apply what arrived; returns the
        number of records applied.  Called by the background thread every
        ``poll_s``, or directly for deterministic tests."""
        try:
            self.engine.faults.check("wal_ship")
            records = self._cursor.poll(max_records)
        except WALGap:
            # pruned past our position: the snapshot we need is newer than
            # our cursor — re-bootstrap and continue from there
            self.bootstrap()
            return 0
        applied = 0
        for rec in records:
            try:
                self.engine.faults.check("replica_apply")
                self.engine.apply_replicated(rec)
            except Exception as e:
                # rewind so the record is re-applied next tick — an
                # injected/transient failure must not skip a mutation
                self.last_error = f"{type(e).__name__}: {e}"
                self.n_apply_errors += 1
                self._cursor.seek(rec.seq - 1)
                break
            applied += 1
            self.n_applied += 1
            with self._cv:
                self._applied_seq = rec.seq
                self._cv.notify_all()
        return applied

    # -- read side -----------------------------------------------------------
    @property
    def applied_seq(self) -> int:
        return self._applied_seq

    def lag(self) -> int:
        """Durable records on the primary not yet applied here."""
        return max(0, self._cursor.last_available_seq() - self._applied_seq)

    def ready(self) -> bool:
        """Bootstrapped and caught up to within ``ready_lag_max``."""
        return self._bootstrapped and self.lag() <= self.ready_lag_max

    def wait_for_seq(self, min_seq: int, timeout_s: float) -> bool:
        """Block until ``applied_seq >= min_seq`` (read-your-writes); False
        on timeout."""
        min_seq = int(min_seq)
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cv:
            while self._applied_seq < min_seq:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    def status(self) -> Dict:
        return {
            "role": self.role,
            "applied_seq": self._applied_seq,
            "replica_lag": self.lag(),
            "ready": self.ready(),
            "bootstrapped": self._bootstrapped,
            "n_applied": self.n_applied,
            "n_bootstraps": self.n_bootstraps,
            "n_poll_errors": self.n_poll_errors,
            "n_apply_errors": self.n_apply_errors,
            "last_error": self.last_error,
            "last_bootstrap": self.last_bootstrap,
        }
