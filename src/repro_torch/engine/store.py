"""Mutable corpus storage: capacity-doubling device buffers + validity mask.

The search path wants fixed shapes, but a serving corpus is mutable.  The
classic resolution (dynamic arrays, amortized O(1) append) carries over to
device memory: the store holds a (capacity, D) embedding buffer, the matching
(capacity, n_dims) prefix-norm table, and a (capacity,) bool validity mask,
all on the store's ``device``.  Appends write the tail in place (``copy_``
into a slice); when full, capacity doubles (a new buffer and one copy — a
new dispatch shape per doubling, O(log N) over the corpus lifetime).  Deletes
just clear the validity bit in place: the mask is threaded through stage-0
scoring and candidate rescoring, so a dead row is unreturnable the moment
the bit flips, with no compaction pause.

The buffers are updated in place, so a tensor handed out by ``db`` /
``valid`` / ``sq_prefix`` sees later mutations; the engine only reads them
under its lock.  The prefix-norm table is stored column-major (one
contiguous (capacity,) column per stage dim, the layout the CUDA kernels
read) and ``sq_prefix`` returns its (capacity, n_dims) view.

Doc ids are append-only row positions (never reused), so ids held by callers
— e.g. the RAG pipeline's doc-token table — stay stable across mutations.
The one exception is ``compact()``: when the dead fraction is high the engine
rebuilds the buffers without tombstoned rows, which *remaps* every live id
(the returned old->new map lets callers follow; the engine fires its
``on_remap`` callbacks with it).

**Tenants + metadata.**  Each row optionally carries a tenant
namespace and a flat metadata dict, stored host-side in columnar form
alongside the device buffers: an int32 tenant-id column plus one object
column per metadata field.  ``compile_mask`` compiles a (tenant, filter)
request constraint into a (capacity,) device bool mask — the search path
ANDs it with the validity mask and nothing else changes: one mask AND, zero
new search code in any backend.  Compiled masks are cached by their
canonical key and invalidated by ``mask_epoch`` (bumped on append / growth /
compaction — deletes don't invalidate, the validity AND already hides dead
rows).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.index import prefix_squared_norms
from repro_torch.engine.request import FilterError, canonical_filter
from repro_torch.index_backends.base import StoreStats

Array = torch.Tensor

# Rows added without a tenant land in this namespace id.
NO_TENANT = -1


def _resolve_device(device) -> torch.device:
    """The store's device; a CUDA device must exist (no silent CPU move)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev


class DocStore:
    """Append-only document store with tombstone deletes."""

    def __init__(
        self,
        d_emb: int,
        dims: Sequence[int],
        *,
        capacity: int = 1024,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        if d_emb < 1:
            raise ValueError(f"d_emb must be >= 1, got {d_emb}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.d_emb = int(d_emb)
        self.dims: Tuple[int, ...] = tuple(int(x) for x in dims)
        # an out-of-range dim would gather the wrong prefix-norm column, so
        # validate eagerly here
        if list(self.dims) != sorted(set(self.dims)):
            raise ValueError(f"dims must be ascending/unique, got {self.dims}")
        if self.dims and (self.dims[0] < 1 or self.dims[-1] > self.d_emb):
            raise ValueError(
                f"dims must lie in [1, {self.d_emb}], got {self.dims}"
            )
        self.capacity = int(capacity)
        self.device = _resolve_device(device)
        self.dtype = dtype
        self._db = torch.zeros((self.capacity, self.d_emb), dtype=dtype,
                               device=self.device)
        # column-major prefix norms: row j is the (capacity,) column for
        # dims[j]
        self._sq_t = torch.zeros((len(self.dims), self.capacity),
                                 dtype=torch.float32, device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.bool,
                                  device=self.device)
        self.size = 0          # high-water mark; ids are 0..size-1
        self.n_active = 0      # rows with the validity bit set
        self.n_grows = 0
        self.n_compactions = 0
        self.generation = 0    # bumped on every mutation
        self.total_added = 0   # lifetime appends (monotonic across compaction)
        self.total_deleted = 0  # lifetime tombstones (monotonic)
        # -- tenancy + metadata (host-side, columnar) -----------------------
        self._tenant_col = np.full((self.capacity,), NO_TENANT, np.int32)
        self._tenant_ids: Dict[str, int] = {}       # name -> dense id
        self._tenant_names: List[str] = []          # dense id -> name
        self._tenant_active: Dict[str, int] = {}    # name -> live rows
        self._meta_cols: Dict[str, np.ndarray] = {}  # field -> (capacity,) obj
        # mask cache: canonical (tenant, filter) key -> (epoch, device mask).
        # mask_epoch tracks row-set/shape changes only (append/grow/compact);
        # tombstones are handled by the validity AND at dispatch.
        self.mask_epoch = 0
        self._mask_cache: "OrderedDict[Tuple, Tuple[int, Array]]" = (
            OrderedDict())
        self._mask_cache_cap = 256
        # hit/miss counters under the EngineStats discipline: plain ints
        # are the source of truth, mutated ONLY under engine.lock (every
        # mask_for_key caller — _execute / search — already holds it) and
        # published into the registry at scrape time by the engine's
        # collector, which also takes engine.lock.  Readers outside the
        # lock (e.g. /v1/stats) must go through mask_cache_stats() /
        # the collector — never the raw attributes
        self.mask_cache_hits = 0
        self.mask_cache_misses = 0

    # -- views the search path consumes ------------------------------------
    @property
    def db(self) -> Array:
        return self._db

    @property
    def sq_prefix(self) -> Array:
        """(capacity, n_dims) view; each column is contiguous."""
        return self._sq_t.T

    @property
    def valid(self) -> Array:
        return self._valid

    def __len__(self) -> int:
        return self.n_active

    def stats(self) -> StoreStats:
        """Mutation-counter snapshot (feeds backend ``needs_rebuild``)."""
        return StoreStats(
            size=self.size,
            n_active=self.n_active,
            capacity=self.capacity,
            generation=self.generation,
            total_added=self.total_added,
            total_deleted=self.total_deleted,
        )

    # -- mutation -----------------------------------------------------------
    def _grow_to(self, new_capacity: int) -> None:
        # allocate the doubled buffers and copy the old rows over (the old
        # and new db are both held at the peak)
        extra = new_capacity - self.capacity
        db = torch.zeros((new_capacity, self.d_emb), dtype=self._db.dtype,
                         device=self.device)
        db[:self.capacity].copy_(self._db)
        self._db = db
        sq_t = torch.zeros((len(self.dims), new_capacity),
                           dtype=torch.float32, device=self.device)
        sq_t[:, :self.capacity].copy_(self._sq_t)
        self._sq_t = sq_t
        valid = torch.zeros((new_capacity,), dtype=torch.bool,
                            device=self.device)
        valid[:self.capacity].copy_(self._valid)
        self._valid = valid
        self._tenant_col = np.concatenate(
            [self._tenant_col, np.full((extra,), NO_TENANT, np.int32)])
        for field, col in self._meta_cols.items():
            self._meta_cols[field] = np.concatenate(
                [col, np.full((extra,), None, object)])
        self.capacity = new_capacity
        self.n_grows += 1

    def add(self, vectors, *, tenant: Optional[str] = None,
            metadata=None) -> np.ndarray:
        """Append rows (numpy or tensor); returns their (stable) int64 doc ids.

        ``tenant`` namespaces the new rows (None = the tenantless pool);
        ``metadata`` is one flat dict applied to every row, or a sequence of
        per-row dicts.  Values must be str/int/float/bool/None — the same
        scalar universe the filter spec accepts.
        """
        vectors = torch.as_tensor(vectors, dtype=self._db.dtype,
                                  device=self.device)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        b, d = vectors.shape
        if d != self.d_emb:
            raise ValueError(f"got dim {d}, store holds dim {self.d_emb}")
        metadata = self._check_metadata(metadata, b)
        new_cap = self.capacity
        while self.size + b > new_cap:
            new_cap *= 2
        if new_cap != self.capacity:
            self._grow_to(new_cap)

        start = self.size
        self._db[start:start + b].copy_(vectors)
        self._sq_t[:, start:start + b].copy_(
            prefix_squared_norms(vectors, self.dims).T)
        self._valid[start:start + b] = True
        tid = self.tenant_id(tenant, create=True)
        self._tenant_col[start:start + b] = tid
        if tenant is not None:
            self._tenant_active[tenant] = (
                self._tenant_active.get(tenant, 0) + b)
        if metadata is not None:
            for j, row_meta in enumerate(metadata):
                for field, value in row_meta.items():
                    self._meta_col(field)[start + j] = value
        self.size += b
        self.n_active += b
        self.total_added += b
        self.generation += 1
        self.mask_epoch += 1
        return np.arange(start, start + b, dtype=np.int64)

    def delete(self, ids) -> int:
        """Tombstone rows by id; returns how many were live before the call."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        if ids.min() < 0 or ids.max() >= self.size:
            raise IndexError(
                f"doc ids must be in [0, {self.size}), got "
                f"[{ids.min()}, {ids.max()}]"
            )
        dev_ids = torch.as_tensor(ids, device=self.device)
        was_live = self._valid[dev_ids].cpu().numpy()
        n_live = int(was_live.sum())
        self._valid[dev_ids] = False
        for tid, cnt in zip(*np.unique(
                self._tenant_col[ids[was_live]], return_counts=True)):
            if tid != NO_TENANT:
                name = self._tenant_names[tid]
                self._tenant_active[name] -= int(cnt)
        self.n_active -= n_live
        self.total_deleted += n_live
        self.generation += 1
        return n_live

    def compact(self) -> np.ndarray:
        """Rebuild the buffers without tombstoned rows; REMAPS live doc ids.

        Live rows slide down to the front (order preserved), the buffers
        shrink to the smallest power-of-two capacity that holds them, and
        every previously-issued doc id becomes invalid.  Returns the
        (old_size,) int64 old->new id map, -1 for dead rows — callers that
        hold ids (the engine's unpolled results, the RAG pipeline's
        doc-token table) must apply it.

        Index-backend states built before a compaction reference old ids;
        the engine rebuilds immediately after compacting, never serving a
        pre-compaction state against post-compaction buffers.
        """
        valid_np = self._valid[: self.size].cpu().numpy()
        live = np.nonzero(valid_np)[0]
        n_live = int(live.size)
        id_map = np.full((self.size,), -1, np.int64)
        id_map[live] = np.arange(n_live)

        new_cap = 1
        while new_cap < max(n_live, 1):
            new_cap *= 2
        gather = torch.as_tensor(live, dtype=torch.long, device=self.device)
        db = torch.zeros((new_cap, self.d_emb), dtype=self._db.dtype,
                         device=self.device)
        db[:n_live] = self._db[gather]
        sq_t = torch.zeros((len(self.dims), new_cap), dtype=torch.float32,
                           device=self.device)
        sq_t[:, :n_live] = self._sq_t[:, gather]
        self._db, self._sq_t = db, sq_t
        self._valid = torch.zeros((new_cap,), dtype=torch.bool,
                                  device=self.device)
        self._valid[:n_live] = True
        tenants = np.full((new_cap,), NO_TENANT, np.int32)
        tenants[:n_live] = self._tenant_col[live]
        self._tenant_col = tenants
        for field, col in self._meta_cols.items():
            packed = np.full((new_cap,), None, object)
            packed[:n_live] = col[live]
            self._meta_cols[field] = packed
        self.capacity = new_cap
        self.size = n_live
        self.n_active = n_live
        self.n_compactions += 1
        self.generation += 1
        self.mask_epoch += 1
        return id_map

    def is_live(self, doc_id: int) -> bool:
        if not 0 <= doc_id < self.size:
            return False
        return bool(self._valid[doc_id])

    # -- snapshot / restore (crash recovery) --------------------------------
    def snapshot_state(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Host-side snapshot of the full store state: (arrays, meta).

        ``arrays`` is npz-friendly (db/valid/tenant rows up to ``size``);
        ``meta`` is msgpack-friendly (counters, tenant names, metadata
        columns as plain lists).  Prefix norms are NOT saved — they are a
        pure function of db and are recomputed on restore, which also
        makes a snapshot portable across engines whose ``dims`` differ.
        """
        arrays = {
            "db": self._db[: self.size].cpu().numpy(),
            "valid": self._valid[: self.size].cpu().numpy(),
            "tenant_col": np.asarray(self._tenant_col[: self.size]),
        }
        meta = {
            "d_emb": self.d_emb,
            "capacity": self.capacity,
            "size": self.size,
            "n_active": self.n_active,
            "generation": self.generation,
            "total_added": self.total_added,
            "total_deleted": self.total_deleted,
            "n_compactions": self.n_compactions,
            "tenant_names": list(self._tenant_names),
            "meta_cols": {
                field: list(col[: self.size])
                for field, col in self._meta_cols.items()
            },
        }
        return arrays, meta

    def restore_state(self, arrays: Dict[str, np.ndarray],
                      meta: Dict) -> None:
        """Replace the store's contents with a ``snapshot_state`` capture —
        this package's or the JAX package's (same arrays, same meta).

        Buffers are rebuilt at the smallest power-of-two capacity >= the
        snapshot size (never below the configured capacity), prefix norms
        are recomputed, and the mask cache is invalidated.
        """
        if int(meta["d_emb"]) != self.d_emb:
            raise ValueError(
                f"snapshot holds d_emb={meta['d_emb']}, store expects "
                f"{self.d_emb}")
        db = np.asarray(arrays["db"])
        valid = np.asarray(arrays["valid"], bool)
        tenant_col = np.asarray(arrays["tenant_col"], np.int32)
        size = int(meta["size"])
        if db.shape != (size, self.d_emb) or valid.shape != (size,) \
                or tenant_col.shape != (size,):
            raise ValueError(
                f"snapshot arrays inconsistent with size={size}: "
                f"db {db.shape}, valid {valid.shape}, "
                f"tenant_col {tenant_col.shape}")
        # adopt the snapshot's capacity when it fits (keeps compiled-shape
        # reuse and saved index states consistent across the restart);
        # otherwise grow a doubling at a time as add() would
        new_cap = max(self.capacity, int(meta.get("capacity", 0)))
        while new_cap < max(size, 1):
            new_cap *= 2
        self._db = torch.zeros((new_cap, self.d_emb), dtype=self._db.dtype,
                               device=self.device)
        self._db[:size].copy_(torch.from_numpy(
            np.require(db, np.float32, ("C", "W"))).to(self._db.dtype))
        self._sq_t = torch.zeros((len(self.dims), new_cap),
                                 dtype=torch.float32, device=self.device)
        self._sq_t[:, :size].copy_(
            prefix_squared_norms(self._db[:size], self.dims).T)
        self._valid = torch.zeros((new_cap,), dtype=torch.bool,
                                  device=self.device)
        self._valid[:size].copy_(torch.from_numpy(np.array(valid)))
        self.capacity = new_cap
        self.size = size
        self.n_active = int(valid.sum())
        if self.n_active != int(meta["n_active"]):
            raise ValueError(
                f"snapshot n_active={meta['n_active']} disagrees with its "
                f"validity mask ({self.n_active} live rows)")
        self.generation = int(meta["generation"])
        self.total_added = int(meta["total_added"])
        self.total_deleted = int(meta["total_deleted"])
        self.n_compactions = int(meta.get("n_compactions", 0))
        col = np.full((new_cap,), NO_TENANT, np.int32)
        col[:size] = tenant_col
        self._tenant_col = col
        self._tenant_names = [str(t) for t in meta.get("tenant_names", [])]
        self._tenant_ids = {t: i for i, t in enumerate(self._tenant_names)}
        self._tenant_active = {}
        live_tids = tenant_col[valid]
        for tid, cnt in zip(*np.unique(live_tids, return_counts=True)):
            if tid != NO_TENANT:
                self._tenant_active[self._tenant_names[tid]] = int(cnt)
        self._meta_cols = {}
        for field, values in meta.get("meta_cols", {}).items():
            packed = np.full((new_cap,), None, object)
            packed[:size] = values
            self._meta_cols[field] = packed
        self.mask_epoch += 1
        self._mask_cache.clear()

    # -- tenancy + metadata --------------------------------------------------
    @staticmethod
    def _check_metadata(metadata, batch: int):
        """Normalize add()'s metadata arg to a per-row list of dicts."""
        if metadata is None:
            return None
        if isinstance(metadata, dict):
            metadata = [metadata] * batch
        metadata = list(metadata)
        if len(metadata) != batch:
            raise ValueError(
                f"metadata holds {len(metadata)} rows for {batch} vectors")
        for row_meta in metadata:
            if row_meta is None:
                continue
            if not isinstance(row_meta, dict):
                raise FilterError(
                    f"metadata rows must be dicts, got "
                    f"{type(row_meta).__name__}")
            for field, value in row_meta.items():
                if not isinstance(field, str) or not field:
                    raise FilterError(
                        f"metadata field names must be non-empty strings, "
                        f"got {field!r}")
                if value is not None and not isinstance(
                        value, (str, int, float, bool)):
                    raise FilterError(
                        f"metadata field {field!r}: values must be "
                        f"str/int/float/bool/None, got "
                        f"{type(value).__name__}")
        return [m or {} for m in metadata]

    def _meta_col(self, field: str) -> np.ndarray:
        col = self._meta_cols.get(field)
        if col is None:
            col = np.full((self.capacity,), None, object)
            self._meta_cols[field] = col
        return col

    def tenant_id(self, tenant: Optional[str], *,
                  create: bool = False) -> int:
        """Dense id for a tenant name (NO_TENANT for None; -2 for a name
        that was never used and ``create=False`` — matches no row)."""
        if tenant is None:
            return NO_TENANT
        tid = self._tenant_ids.get(tenant)
        if tid is None:
            if not create:
                return -2
            tid = len(self._tenant_names)
            self._tenant_ids[tenant] = tid
            self._tenant_names.append(tenant)
        return tid

    def tenant_of(self, doc_id: int) -> Optional[str]:
        """Tenant name of one row (None for the tenantless pool)."""
        if not 0 <= doc_id < self.size:
            raise IndexError(f"doc id {doc_id} out of range [0, {self.size})")
        tid = int(self._tenant_col[doc_id])
        return None if tid == NO_TENANT else self._tenant_names[tid]

    def tenant_doc_count(self, tenant: str) -> int:
        """Live rows currently held by ``tenant`` (quota accounting)."""
        return self._tenant_active.get(tenant, 0)

    def tenants(self) -> Dict[str, int]:
        """Snapshot of {tenant: live rows} for every tenant ever seen."""
        return dict(self._tenant_active)

    def metadata_of(self, doc_id: int) -> Dict:
        """The metadata fields set on one row (empty dict when none)."""
        if not 0 <= doc_id < self.size:
            raise IndexError(f"doc id {doc_id} out of range [0, {self.size})")
        out = {}
        for field, col in self._meta_cols.items():
            if col[doc_id] is not None:
                out[field] = col[doc_id]
        return out

    # -- filter-mask compiler ------------------------------------------------
    def compile_mask(self, tenant: Optional[str] = None,
                     filt=None) -> Optional[Tuple]:
        """Validate a (tenant, filter) constraint; returns its mask key.

        The key is hashable — batch formation groups requests by it — and
        ``mask_for_key`` turns it into the (capacity,) device bool mask at
        dispatch time.  None means "no constraint" (nothing is compiled and
        the dispatch skips the AND entirely).
        """
        canon = canonical_filter(filt)
        if tenant is None and canon is None:
            return None
        return (tenant, canon)

    def mask_for_key(self, key: Optional[Tuple]) -> Optional[Array]:
        """(capacity,) device bool mask for a ``compile_mask`` key.

        Cached per key and recompiled when ``mask_epoch`` moved (rows were
        appended, buffers grew, or a compaction reshuffled them) — so a mask
        compiled at submit time can never be stale or mis-shaped by the time
        its batch dispatches.  Tombstones don't invalidate: the dispatch
        ANDs the live validity mask on top.
        """
        if key is None:
            return None
        hit = self._mask_cache.get(key)
        if hit is not None and hit[0] == self.mask_epoch:
            self.mask_cache_hits += 1
            self._mask_cache.move_to_end(key)
            return hit[1]
        self.mask_cache_misses += 1
        tenant, canon = key
        mask = np.ones((self.size,), bool)
        if tenant is not None:
            mask &= self._tenant_col[:self.size] == self.tenant_id(tenant)
        if canon is not None:
            for field, ops in canon:
                col = self._meta_cols.get(field)
                for op, value in ops:
                    mask &= self._field_mask(col, op, value)
        dev = torch.zeros((self.capacity,), dtype=torch.bool,
                          device=self.device)
        dev[:self.size].copy_(torch.from_numpy(mask))
        self._mask_cache[key] = (self.mask_epoch, dev)
        self._mask_cache.move_to_end(key)
        while len(self._mask_cache) > self._mask_cache_cap:
            self._mask_cache.popitem(last=False)
        return dev

    def mask_cache_stats(self) -> Dict[str, int]:
        """Snapshot of the mask-cache counters.  Call under ``engine.lock``
        (the counters mutate there); the dict itself is then safe to hand
        to any thread."""
        return {
            "hits": self.mask_cache_hits,
            "misses": self.mask_cache_misses,
            "entries": len(self._mask_cache),
            "epoch": self.mask_epoch,
        }

    def _field_mask(self, col: Optional[np.ndarray], op: str,
                    value) -> np.ndarray:
        """(size,) bool mask for one (field op value) term.

        Missing-field semantics follow MongoDB: a row without the field
        matches ``$ne`` / ``$nin`` / ``$exists: False`` and nothing else.
        """
        n = self.size
        if col is None:                      # field never set on any row
            if op in ("$ne", "$nin"):
                return np.ones((n,), bool)
            if op == "$exists":
                return np.full((n,), not value)
            return np.zeros((n,), bool)
        vals = col[:n]
        present = np.array([v is not None for v in vals], bool)
        if op == "$exists":
            return present if value else ~present
        if op in ("$eq", "$ne"):
            eq = np.array([v is not None and v == value for v in vals], bool)
            return eq if op == "$eq" else ~eq
        if op in ("$in", "$nin"):
            allowed = set(value)
            isin = np.array(
                [v is not None and v in allowed for v in vals], bool)
            return isin if op == "$in" else ~isin
        cmp = {"$gt": lambda v: v > value, "$gte": lambda v: v >= value,
               "$lt": lambda v: v < value, "$lte": lambda v: v <= value}[op]
        return np.array(
            [v is not None and not isinstance(v, (str, bool)) and cmp(v)
             for v in vals], bool)
