"""Driver-thread supervision: heartbeat watchdog + capped-backoff restarts.

The `repro_torch.engine.driver.EngineDriver` thread is a single point of failure:
if it dies (an escaped exception) or wedges (a hung device call, a
pathological dispatch), every client blocks and the queue grows until
backpressure freezes the front-end.  The ``Supervisor`` closes that hole:

* **Detection** — the driver stamps a heartbeat each loop iteration.  A
  thread that is not alive while the driver is RUNNING is *dead*; one that
  is alive but has both a stale heartbeat AND a pending request waiting
  longer than ``heartbeat_timeout_s`` is *hung* (the double condition keeps
  an idle driver — stale heartbeat, empty queue — from tripping it).
* **Restart** — ``driver.restart()`` spawns a replacement thread under a
  new epoch; a hung-but-alive old thread notices the stale epoch at its
  next safe point and stands down.  Pending requests survive the swap.
* **Backoff** — consecutive restarts back off exponentially
  (``backoff_initial_s * 2**n``, capped at ``backoff_max_s``); a stretch of
  healthy uptime resets the streak.  Past ``max_restarts`` consecutive
  failures the supervisor gives up: ``driver.kill`` fails everything
  pending and the crash loop surfaces instead of spinning forever.

Wiring: ``Supervisor(driver).start()`` after ``driver.start(
supervised=True)``.  Restart counters live in ``driver.stats``
(``repro_driver_restarts_total``); ``summary()`` reports the watchdog's
state.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from repro_torch.engine.config import FaultToleranceConfig

_RUNNING = "running"


class SupervisorGaveUp(RuntimeError):
    """The driver kept dying past ``max_restarts`` consecutive restarts —
    the supervisor stopped reviving it and failed pending requests."""


class Supervisor:
    """Watchdog thread restarting a dead/hung ``EngineDriver``."""

    def __init__(self, driver, *,
                 config: Optional[FaultToleranceConfig] = None,
                 poll_s: Optional[float] = None):
        self.driver = driver
        self.cfg = config if config is not None \
            else driver.engine.config.fault
        # poll a few times per timeout window so detection latency is a
        # fraction of the threshold, not a multiple of it
        self.poll_s = (poll_s if poll_s is not None
                       else max(0.01, self.cfg.heartbeat_timeout_s / 4))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.consecutive = 0
        self.gave_up = False
        self.last_cause: Optional[str] = None
        self._healthy_since: Optional[float] = None
        driver.supervisor = self
        self._c_restarts = driver.engine.metrics.counter(
            "repro_supervisor_restarts_total",
            "Driver restarts by the supervisor, by cause",
            labels=("cause",))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Supervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._thread = threading.Thread(
            target=self._run, name="driver-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- watchdog loop ------------------------------------------------------
    def _verdict(self, h: Dict) -> Optional[str]:
        """None = healthy; otherwise the failure cause ('dead'/'hung')."""
        if not h["thread_alive"]:
            return "dead"
        t = self.cfg.heartbeat_timeout_s
        if (h["n_pending"] > 0 and h["oldest_wait_s"] > t
                and h["heartbeat_age_s"] > t):
            return "hung"
        return None

    def _run(self) -> None:
        d = self.driver
        clock = d._clock
        while not self._stop.wait(self.poll_s):
            h = d.health()
            if h["state"] != _RUNNING:
                if h["state"] == "stopped":
                    return                 # clean shutdown: nothing to do
                continue                   # new/stopping: not ours yet
            cause = self._verdict(h)
            if cause is None:
                now = clock()
                if self._healthy_since is None:
                    self._healthy_since = now
                elif (self.consecutive
                      and now - self._healthy_since
                      > 2 * self.cfg.heartbeat_timeout_s):
                    self.consecutive = 0   # earned a clean slate
                continue
            self._healthy_since = None
            self.last_cause = cause
            if self.consecutive >= self.cfg.max_restarts:
                self.gave_up = True
                d.kill(SupervisorGaveUp(
                    f"driver failed ({cause}) {self.consecutive + 1} "
                    f"consecutive times; giving up after "
                    f"{self.cfg.max_restarts} restarts"))
                return
            backoff = min(
                self.cfg.backoff_initial_s * (2 ** self.consecutive),
                self.cfg.backoff_max_s)
            if self._stop.wait(backoff):
                return
            if d.restart():
                self.consecutive += 1
                self._c_restarts.inc(cause=cause)

    def summary(self) -> Dict:
        return {
            "attached": True,
            "running": (self._thread is not None
                        and self._thread.is_alive()),
            "consecutive_failures": self.consecutive,
            "gave_up": self.gave_up,
            "last_cause": self.last_cause,
            "heartbeat_timeout_s": self.cfg.heartbeat_timeout_s,
            "max_restarts": self.cfg.max_restarts,
        }
