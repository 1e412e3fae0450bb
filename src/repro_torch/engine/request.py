"""Typed per-request search API: ``SearchRequest`` + the metadata filter spec.

Without it every per-query knob would be frozen at engine construction: ``k`` would be
the engine-global ``final_k`` and ``submit()`` would take only a raw vector.  A
serving front-end needs per-request options — a different ``k``, a tenant
namespace, a metadata filter over a sub-corpus, a client deadline — so this
module defines the one blessed way to express them end-to-end:

    SearchRequest(query, k=5, tenant="acme", filter={"lang": "en"})

is accepted by ``RetrievalEngine.submit()`` / ``.search()`` and
``EngineDriver.submit()`` / ``.retrieve()`` alongside the existing raw-array
form (a raw array is exactly ``SearchRequest(query)``, so every pre-existing
call site keeps working unchanged).

**Filter spec.**  A filter is a dict mapping metadata fields to either a
scalar (equality) or an operator dict, MongoDB-style:

    {"lang": "en"}                            # equality
    {"year": {"$gte": 2020, "$lt": 2025}}     # range
    {"topic": {"$in": [1, 2, 3]}}             # membership
    {"flag": {"$ne": "spam"}}                 # != (missing field matches)
    {"score": {"$exists": True}}              # field presence

Fields are AND-ed.  ``canonical_filter`` validates the spec eagerly (raising
``FilterError`` with a pointed message — the HTTP layer maps it to a 400)
and folds it into a hashable canonical tuple.  That tuple does double duty:

  * it is the *mask key* — together with the tenant it identifies the
    compiled row bitmask, so `DocStore`'s mask cache and the batch-formation
    grouping (requests sharing a mask key ride the same dispatch) both hash
    it instead of re-walking dicts;
  * it survives submission-to-dispatch delays — masks are (re)compiled from
    the key at dispatch time, so rows added after ``submit`` are visible to
    the filtered search exactly as they are to an unfiltered one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# Operators the mask compiler understands (MongoDB-style names).
FILTER_OPS = ("$eq", "$ne", "$in", "$nin", "$gt", "$gte", "$lt", "$lte",
              "$exists")
_SCALAR_TYPES = (str, int, float, bool)
_ORDER_OPS = ("$gt", "$gte", "$lt", "$lte")


class FilterError(ValueError):
    """Malformed metadata-filter spec (client error — HTTP 400)."""


def _check_scalar(field: str, op: str, value: Any) -> Any:
    if value is None or isinstance(value, _SCALAR_TYPES):
        if op in _ORDER_OPS and not isinstance(value, (int, float)):
            raise FilterError(
                f"filter field {field!r}: {op} needs a numeric bound, got "
                f"{value!r}")
        if op in _ORDER_OPS and isinstance(value, bool):
            raise FilterError(
                f"filter field {field!r}: {op} needs a numeric bound, got "
                f"a bool")
        return value
    raise FilterError(
        f"filter field {field!r}: values must be str/int/float/bool/None, "
        f"got {type(value).__name__}")


def canonical_filter(filt: Optional[Dict]) -> Optional[Tuple]:
    """Validate a filter spec and fold it into a hashable canonical tuple.

    Returns None for an empty/absent filter.  The canonical form is
    ``((field, ((op, value), ...)), ...)`` with fields and ops sorted, so
    two specs that mean the same thing hash identically (mask-cache hits,
    shared batches).
    """
    if filt is None:
        return None
    if not isinstance(filt, dict):
        raise FilterError(
            f"filter must be a dict of field -> value/operators, got "
            f"{type(filt).__name__}")
    if not filt:
        return None
    fields = []
    for field, spec in filt.items():
        if not isinstance(field, str) or not field:
            raise FilterError(
                f"filter field names must be non-empty strings, got "
                f"{field!r}")
        if field.startswith("$"):
            raise FilterError(
                f"unsupported top-level operator {field!r}; filters are a "
                f"dict of field -> value/operators")
        if isinstance(spec, dict):
            if not spec:
                raise FilterError(f"filter field {field!r}: empty operator "
                                  f"dict")
            ops = []
            for op, value in spec.items():
                if op not in FILTER_OPS:
                    raise FilterError(
                        f"filter field {field!r}: unknown operator {op!r}; "
                        f"supported: {', '.join(FILTER_OPS)}")
                if op in ("$in", "$nin"):
                    if not isinstance(value, (list, tuple)):
                        raise FilterError(
                            f"filter field {field!r}: {op} needs a list")
                    value = tuple(_check_scalar(field, "$eq", v)
                                  for v in value)
                elif op == "$exists":
                    if not isinstance(value, bool):
                        raise FilterError(
                            f"filter field {field!r}: $exists needs a bool")
                else:
                    value = _check_scalar(field, op, value)
                ops.append((op, value))
            fields.append((field, tuple(sorted(ops))))
        else:
            fields.append(
                (field, (("$eq", _check_scalar(field, "$eq", spec)),)))
    return tuple(sorted(fields))


def filter_to_dict(canon: Optional[Tuple]) -> Optional[Dict]:
    """Canonical tuple back to the client-facing dict form (stats/debug)."""
    if canon is None:
        return None
    out: Dict[str, Any] = {}
    for field, ops in canon:
        if len(ops) == 1 and ops[0][0] == "$eq":
            out[field] = ops[0][1]
        else:
            out[field] = {op: (list(v) if isinstance(v, tuple) else v)
                          for op, v in ops}
    return out


@dataclasses.dataclass
class SearchRequest:
    """One typed retrieval request.

    Attributes:
      query:       the query vector — anything ``np.asarray`` accepts,
                   shaped (D,) or (1, D).
      k:           neighbours to return; None means the engine's configured
                   ``final_k``.  Must not exceed it (the dispatch shape is
                   static — configure the engine with the largest ``k`` it
                   should serve).
      tenant:      namespace the search is confined to.  A named tenant sees
                   exactly the docs added under that tenant (strict
                   isolation — never another tenant's, never the tenantless
                   pool).  None is the unconstrained admin/legacy view over
                   the whole corpus; the HTTP layer refuses it unless the
                   server was configured with ``require_tenant=False``.
      filter:      metadata filter spec (see module docstring); AND-ed with
                   the tenant constraint and the store's validity mask.
      deadline_ms: client latency budget.  The async driver drops requests
                   whose budget expired before dispatch (their futures raise
                   ``DeadlineExceeded``); the synchronous queue path ignores
                   it (the caller paces dispatch there).
    """

    query: Any
    k: Optional[int] = None
    tenant: Optional[str] = None
    filter: Optional[Dict] = None
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.k is not None and int(self.k) < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.tenant is not None and (
                not isinstance(self.tenant, str) or not self.tenant):
            raise ValueError(
                f"tenant must be a non-empty string or None, got "
                f"{self.tenant!r}")
        if self.deadline_ms is not None and float(self.deadline_ms) < 0:
            raise ValueError(
                f"deadline_ms must be >= 0, got {self.deadline_ms}")

    def mask_key(self) -> Optional[Tuple]:
        """Hashable (tenant, canonical-filter) identity of this request's
        row bitmask; None when the request constrains nothing (fast path:
        no mask is compiled or AND-ed at all)."""
        canon = canonical_filter(self.filter)
        if self.tenant is None and canon is None:
            return None
        return (self.tenant, canon)
