"""Per-tenant admission control in front of the driver's bounded queue.

The driver's ``max_queue`` bound is global: one greedy tenant can fill it
and starve everyone else behind ``DriverQueueFull``.  ``TenantQuotas`` sits
in front of it and rejects *per tenant* — a tenant at its in-flight cap gets
a fast 429 while other tenants' requests still reach the queue.  Two limits:

* ``max_inflight`` — concurrent searches a tenant may have between submit
  and response (acquired before ``driver.submit``, released when the future
  resolves, success or not).
* ``max_docs`` — live documents a tenant may store (checked against
  ``DocStore.tenant_doc_count`` before an add; deletes free budget).

Both accept per-tenant overrides; ``None`` disables a limit.  The class is
plain thread-safe Python — no asyncio coupling — so the HTTP layer's
executor threads and any direct driver clients can share one instance.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from repro_torch.obs import NULL_INSTRUMENT


class QuotaExceeded(RuntimeError):
    """A tenant hit one of its admission limits (the HTTP layer's 429)."""

    def __init__(self, tenant: Optional[str], limit: str, message: str):
        super().__init__(message)
        self.tenant = tenant
        self.limit = limit                     # "inflight" | "docs"


class TenantQuotas:
    """Thread-safe per-tenant limit bookkeeping.

    Args:
      max_inflight: default concurrent-search cap per tenant
                    (None = unlimited).
      max_docs:     default live-document cap per tenant (None = unlimited).
      overrides:    {tenant: {"max_inflight": n, "max_docs": n}} exceptions
                    to the defaults (a key set to None lifts that limit for
                    that tenant).

    The tenantless pool (``tenant=None``) is the admin/legacy view and is
    never limited — servers that want no anonymous traffic at all enforce
    that with ``require_tenant`` instead.
    """

    def __init__(self, *, max_inflight: Optional[int] = 64,
                 max_docs: Optional[int] = None,
                 overrides: Optional[Dict[str, Dict]] = None):
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1 or None, got {max_inflight}")
        if max_docs is not None and max_docs < 0:
            raise ValueError(
                f"max_docs must be >= 0 or None, got {max_docs}")
        self._max_inflight = max_inflight
        self._max_docs = max_docs
        self._overrides = {t: dict(o) for t, o in (overrides or {}).items()}
        self._inflight: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._c_rejections = NULL_INSTRUMENT

    def bind_registry(self, registry) -> None:
        """Count rejections in a `repro_torch.obs.MetricsRegistry` as
        ``repro_quota_rejections_total{tenant,limit}`` (the registry's
        series cap bounds an unruly tenant universe)."""
        self._c_rejections = registry.counter(
            "repro_quota_rejections_total",
            "Per-tenant admission rejections, by limit hit",
            labels=("tenant", "limit"))

    def _limit(self, tenant: str, name: str, default: Optional[int]):
        return self._overrides.get(tenant, {}).get(name, default)

    # -- in-flight searches --------------------------------------------------
    def acquire(self, tenant: Optional[str]) -> None:
        """Claim one in-flight slot for ``tenant`` or raise ``QuotaExceeded``.

        Every successful call must be paired with ``release`` — use
        try/finally around the submit-and-wait.
        """
        if tenant is None:
            return
        with self._lock:
            cap = self._limit(tenant, "max_inflight", self._max_inflight)
            held = self._inflight.get(tenant, 0)
            if cap is not None and held >= cap:
                self._c_rejections.inc(tenant=tenant, limit="inflight")
                raise QuotaExceeded(
                    tenant, "inflight",
                    f"tenant {tenant!r} already has {held} searches in "
                    f"flight (cap {cap})")
            self._inflight[tenant] = held + 1

    def release(self, tenant: Optional[str]) -> None:
        if tenant is None:
            return
        with self._lock:
            held = self._inflight.get(tenant, 0)
            if held <= 0:
                raise RuntimeError(
                    f"release() without acquire() for tenant {tenant!r}")
            if held == 1:
                self._inflight.pop(tenant)
            else:
                self._inflight[tenant] = held - 1

    # -- document budget -----------------------------------------------------
    def check_docs(self, tenant: Optional[str], current: int,
                   adding: int) -> None:
        """Reject an add that would push ``tenant`` past its document cap."""
        if tenant is None:
            return
        cap = self._limit(tenant, "max_docs", self._max_docs)
        if cap is not None and current + adding > cap:
            self._c_rejections.inc(tenant=tenant, limit="docs")
            raise QuotaExceeded(
                tenant, "docs",
                f"tenant {tenant!r} holds {current} docs; adding {adding} "
                f"would exceed cap {cap}")

    # -- introspection -------------------------------------------------------
    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def snapshot(self) -> Dict:
        """Current limits + per-tenant in-flight counts (for /v1/stats)."""
        with self._lock:
            return {
                "max_inflight": self._max_inflight,
                "max_docs": self._max_docs,
                "overrides": {t: dict(o)
                              for t, o in self._overrides.items()},
                "inflight": dict(self._inflight),
            }
