"""Deterministic fault injection for the serving stack's chaos tests.

A ``FaultPlan`` is a parsed set of rules, each bound to a *named site* the
engine/driver consult at the failure-prone moments:

    dispatch    — driver batch execution (before ``engine.lock``)
    rebuild     — index (re)build, sync or background
    wal_write   — WAL append on the mutation path
    ckpt_save   — snapshot/index save
    ckpt_load   — snapshot/index load during recovery
    wal_ship    — replication: follower polling the primary's WAL tail
    replica_apply — replication: follower applying one shipped record

Spec grammar (``FaultToleranceConfig.inject`` / ``--inject``)::

    site:action[@key=value[,key=value...]][;site:action...]

Actions:
    error   — raise ``InjectedFault`` (an ordinary Exception: exercised
              error paths, batch failure, rebuild retry)
    crash   — raise ``InjectedCrash`` (a BaseException that escapes
              ``except Exception`` handlers — simulates the driver thread
              dying mid-loop; the supervisor's restart path)
    hang    — sleep ``s`` seconds (default 30): a wedged thread for the
              heartbeat watchdog to detect
    exit    — ``os._exit(code)`` (default 17): hard process death for the
              subprocess chaos tests
    poison  — raise ``PoisonError`` iff a query in the batch carries the
              marker value in component 0 (``v=``): content-determined, so
              batch bisection isolates exactly the offender

Firing qualifiers (count-based rules are exact; ``p=`` draws from a
per-rule RNG seeded by ``(seed, site, action)`` so a given plan replays
identically):
    once=K  — fire on exactly the Kth check of the site (1-based)
    first=K — fire on the first K checks
    every=K — fire on every Kth check
    p=F     — fire with probability F per check

The plan keeps per-site call and fire counters (``summary()``) so tests and
the chaos benchmark can assert exactly what fired.  ``FaultPlan.parse("")``
yields an inert plan — the production configuration; its ``check`` is two
dict lookups.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence

SITES = ("dispatch", "rebuild", "wal_write", "ckpt_save", "ckpt_load",
         "wal_ship", "replica_apply")
ACTIONS = ("error", "crash", "hang", "exit", "poison")


class InjectedFault(RuntimeError):
    """An injected ordinary failure (the ``error`` action)."""


class PoisonError(InjectedFault):
    """An injected per-request failure: the batch contains a poison query
    (the ``poison`` action).  Content-determined — re-dispatching any
    subset containing the marker fails again, so bisection converges on
    exactly the poisoned request."""


class InjectedCrash(BaseException):
    """An injected catastrophic failure.  Deliberately NOT an Exception:
    it sails through ``except Exception`` recovery code exactly like a
    genuine interpreter-level death would, killing the driver thread."""


class FaultRule:
    """One parsed ``site:action@...`` clause."""

    __slots__ = ("site", "action", "once", "first", "every", "p",
                 "hang_s", "marker", "code", "_rng")

    def __init__(self, site: str, action: str, *, once: int = 0,
                 first: int = 0, every: int = 0, p: float = 0.0,
                 hang_s: float = 30.0, marker: Optional[float] = None,
                 code: int = 17, seed: int = 0):
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; sites: {SITES}")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; actions: {ACTIONS}")
        if action == "poison" and site != "dispatch":
            raise ValueError("poison rules only apply to the dispatch site")
        if action == "poison" and marker is None:
            raise ValueError("poison rules need a marker value (v=...)")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must lie in [0, 1], got {p}")
        if action != "poison" and once <= 0 and first <= 0 \
                and every <= 0 and p <= 0.0:
            raise ValueError(
                f"rule {site}:{action} never fires; give it once=/first=/"
                f"every=/p=")
        self.site, self.action = site, action
        self.once, self.first, self.every, self.p = once, first, every, p
        self.hang_s, self.marker, self.code = hang_s, marker, code
        self._rng = random.Random(f"{seed}:{site}:{action}")

    def fires(self, n_call: int) -> bool:
        """Does this rule fire on the ``n_call``-th (1-based) site check?"""
        if self.once and n_call == self.once:
            return True
        if self.first and n_call <= self.first:
            return True
        if self.every and n_call % self.every == 0:
            return True
        if self.p and self._rng.random() < self.p:
            return True
        return False


def _parse_clause(clause: str, seed: int) -> FaultRule:
    head, _, tail = clause.partition("@")
    site, _, action = head.partition(":")
    kw: Dict = {}
    if tail:
        for pair in tail.split(","):
            key, _, val = pair.partition("=")
            key, val = key.strip(), val.strip()
            if key in ("once", "first", "every", "code"):
                kw[key] = int(val)
            elif key == "p":
                kw["p"] = float(val)
            elif key == "s":
                kw["hang_s"] = float(val)
            elif key == "v":
                kw["marker"] = float(val)
            else:
                raise ValueError(
                    f"unknown fault qualifier {key!r} in {clause!r}")
    return FaultRule(site.strip(), action.strip(), seed=seed, **kw)


class FaultPlan:
    """A seeded, thread-safe set of fault rules the serving stack consults.

    ``check(site, queries=...)`` is called at each named site; it raises /
    hangs / exits according to the matching rules.  With no rules for the
    site it is nearly free, so production engines carry an empty plan
    rather than branching around the calls.
    """

    def __init__(self, rules: Sequence[FaultRule] = (), *, seed: int = 0):
        self.seed = int(seed)
        self._rules: Dict[str, List[FaultRule]] = {}
        for r in rules:
            self._rules.setdefault(r.site, []).append(r)
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    @classmethod
    def parse(cls, spec: Optional[str], *, seed: int = 0) -> "FaultPlan":
        spec = (spec or "").strip()
        if not spec:
            return cls((), seed=seed)
        rules = [_parse_clause(c.strip(), seed)
                 for c in spec.split(";") if c.strip()]
        return cls(rules, seed=seed)

    @property
    def empty(self) -> bool:
        return not self._rules

    def check(self, site: str, *, queries=None) -> None:
        """Consult the plan at ``site``; raises/hangs/exits when a rule
        fires.  ``queries`` (a sequence of (D,) vectors) is only read by
        poison rules."""
        rules = self._rules.get(site)
        if not rules:
            return
        with self._lock:
            n = self.calls.get(site, 0) + 1
            self.calls[site] = n
            todo = []
            for r in rules:
                if r.action == "poison":
                    if queries is not None and any(
                            abs(float(q[0]) - r.marker) < 1e-6
                            for q in queries):
                        todo.append(r)
                elif r.fires(n):
                    todo.append(r)
            for r in todo:
                key = f"{site}:{r.action}"
                self.fired[key] = self.fired.get(key, 0) + 1
        for r in todo:
            if r.action == "error":
                raise InjectedFault(f"injected error at {site} (call {n})")
            if r.action == "poison":
                raise PoisonError(
                    f"injected poison in batch at {site} "
                    f"(marker {r.marker})")
            if r.action == "hang":
                time.sleep(r.hang_s)
            elif r.action == "exit":
                os._exit(r.code)
            elif r.action == "crash":
                raise InjectedCrash(
                    f"injected crash at {site} (call {n})")

    def summary(self) -> Dict:
        with self._lock:
            return {"calls": dict(self.calls), "fired": dict(self.fired)}


NULL_PLAN = FaultPlan()
