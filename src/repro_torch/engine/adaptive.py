"""Load-adaptive search policy: degrade recall, not availability.

The paper's trade — dimensionality (and probe/pool width) for speed at a
chosen accuracy — becomes a control loop here instead of a constant.
:class:`AdaptivePolicy` maps the driver's measured queue pressure (depth
and queue-wait p95, both already collected by the driver's telemetry) onto a
small integer *pressure level*; each level carries a
:class:`SearchOverrides` bundle of the knobs that are safe to move per
dispatch without recompiling:

* ``n_probe_frac`` — fraction of the IVF probe count to visit,
* ``oversample_frac`` — fraction of the PQ ADC oversample pool,
* ``sched`` — a degraded progressive schedule entered at a *smaller*
  ``d_start`` rung (cheaper full-corpus stage-0 scan, same final width).

Escalation is immediate (pressure is load-shedding, waiting makes the
queue worse); recovery is hysteretic — one level down only after the
queue has stayed calm for a continuous dwell (``hysteresis_s``), so the
policy doesn't flap around a threshold.  Every transition is counted and
mirrored into the obs registry at scrape time, same discipline as
``EngineStats``: plain ints are the source of truth, mutated only on the
driver thread; readers see them via ``summary()`` / ``/v1/stats`` or the
published Prometheus series.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional

from ..obs import NULL_INSTRUMENT

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (engine pkg)
    from ..core.schedule import ProgressiveSchedule
    from ..obs import MetricsRegistry
    from .config import AdaptiveConfig


@dataclass(frozen=True)
class SearchOverrides:
    """Per-dispatch search-knob overrides for one pressure level.

    Frozen and hashable on purpose: instances ride the engine's dispatch
    shape keys (one cached compiled program per (bucket, overrides)
    pair, pre-warmed by ``engine.warmup()``) and are passed to backends
    as an opaque ``overrides=`` kwarg — backends never import this
    module, they just read the attributes they can honour.
    """

    level: int = 0
    n_probe_frac: float = 1.0
    oversample_frac: float = 1.0
    sched: Optional["ProgressiveSchedule"] = None


class AdaptivePolicy:
    """Hysteretic queue-pressure → degradation-level controller.

    Single-writer: ``update()`` runs only on the driver thread (under the
    driver cv, next to where depth/wait are measured).  ``level`` is a
    plain int read lock-free by the submit path and the HTTP layer — a
    stale read is harmless (one request served at the neighbouring
    level).
    """

    def __init__(self, cfg: "AdaptiveConfig") -> None:
        self.cfg = cfg
        self.level = 0
        self.n_escalations = 0
        self.n_recoveries = 0
        self._calm_since: Optional[float] = None
        self._c_transitions = NULL_INSTRUMENT
        self._g_level = NULL_INSTRUMENT

    # -- thresholds ---------------------------------------------------
    def _entry_depth(self, level: int) -> float:
        return self.cfg.depth_high * self.cfg.escalate_factor ** (level - 1)

    def _entry_wait(self, level: int) -> Optional[float]:
        if self.cfg.wait_high_ms is None:
            return None
        return self.cfg.wait_high_ms * self.cfg.escalate_factor ** (level - 1)

    def target_level(self, depth: int, wait_p95_ms: Optional[float]) -> int:
        """Deepest level whose entry threshold the current pressure
        clears (depth OR wait — either signal alone escalates)."""
        target = 0
        for lvl in range(1, self.cfg.levels + 1):
            over = depth >= self._entry_depth(lvl)
            w = self._entry_wait(lvl)
            if not over and w is not None and wait_p95_ms is not None:
                over = wait_p95_ms >= w
            if over:
                target = lvl
            else:
                break
        return target

    # -- control loop -------------------------------------------------
    def update(self, depth: int, wait_p95_ms: Optional[float],
               now: float) -> int:
        """One controller step; returns the (possibly new) level.

        Escalate immediately to the deepest justified level; step DOWN
        one level at a time, and only after ``hysteresis_s`` seconds of
        continuous calm (pressure below ``recover_frac`` of the current
        level's entry threshold).  The calm timer resets whenever
        pressure reappears and after every downward step, so a recovery
        from level N to 0 takes N full dwells — deliberate damping.
        """
        target = self.target_level(depth, wait_p95_ms)
        if target > self.level:
            self.n_escalations += target - self.level
            self.level = target
            self._calm_since = None
            return self.level
        if self.level == 0:
            self._calm_since = None
            return 0
        calm = depth < self.cfg.recover_frac * self._entry_depth(self.level)
        w = self._entry_wait(self.level)
        if calm and w is not None and wait_p95_ms is not None:
            calm = wait_p95_ms < self.cfg.recover_frac * w
        if not calm:
            self._calm_since = None
            return self.level
        if self._calm_since is None:
            self._calm_since = now
        if now - self._calm_since >= self.cfg.hysteresis_s:
            self.level -= 1
            self.n_recoveries += 1
            self._calm_since = None  # next step down needs its own dwell
        return self.level

    # -- observability ------------------------------------------------
    def bind(self, registry: "MetricsRegistry") -> None:
        self._c_transitions = registry.counter(
            "repro_adaptive_transitions_total",
            "Pressure-level transitions (direction=up escalations, "
            "direction=down hysteretic recoveries)",
            labels=("direction",))
        self._g_level = registry.gauge(
            "repro_adaptive_level",
            "Current degradation level (0 = full-quality static config)")
        self.publish()

    def publish(self) -> None:
        """Scrape-time mirror — called from the driver's collector."""
        self._c_transitions.set_total(self.n_escalations, direction="up")
        self._c_transitions.set_total(self.n_recoveries, direction="down")
        self._g_level.set(self.level)

    def summary(self) -> Dict:
        return {
            "enabled": True,
            "level": self.level,
            "levels": self.cfg.levels,
            "n_escalations": self.n_escalations,
            "n_recoveries": self.n_recoveries,
            "depth_high": self.cfg.depth_high,
            "wait_high_ms": self.cfg.wait_high_ms,
            "hysteresis_s": self.cfg.hysteresis_s,
        }
