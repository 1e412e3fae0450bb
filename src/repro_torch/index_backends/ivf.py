"""IVF-progressive backend: k-means coarse quantizer in front of the schedule.

Stage 0 stops scanning the whole buffer: queries probe the ``n_probe``
nearest centroids and only the probed lists' members are scored, then the
normal progressive rescore ladder runs on the survivors.  Two build-time
decisions drive the cost/recall profile:

* **Probe space** (``probe_dim``) — centroids are clustered, assigned, and
  probed in the *same* truncated space, so a query equal to a document
  ranks that document's cell exactly where the assignment did.
* **Balanced assignment** (``balance_factor``) — the member table is dense
  (its width is the longest list), so lists are capacity-bounded at
  ``balance_factor`` times the mean occupancy (see
  `repro_torch.core.ivf.balanced_assign`).

**Stage-0 kernel** (``use_kernel``): the probe+scan hot path runs the IVF
scan kernel `repro_torch.kernels.ivf_scan` — probed lists' member rows
are read from list-major slabs packed at build time and the stage-0 top-k
is kept on chip — instead of gathering a candidate table and rescoring it.
``'auto'`` picks the kernel route when the backend's device is CUDA and
the gather-and-rescore route (``ivf_progressive_search_sched``) otherwise;
``True`` takes the kernel route on either device (the plain scan on the
CPU — the parity-tested configuration); ``False`` the sched route.
``stage0_dtype='int8'`` stores the member slabs as per-dimension int8 codes
(`repro_torch.core.quant`'s grid) and ``'pq'`` as product-quantization
codes scanned by ADC lookup (`repro_torch.kernels.pq_scan`); both exist
only on the kernel route.

Staleness: appended rows are **absorbed incrementally** at engine safe
points (``absorb_appends``): each new row goes to its nearest centroid's
list while that list has spare slots (``append_spare`` reserved per list at
build time); only rows whose list is full ride the tail window.  Churn past
``rebuild_frac`` of the built corpus still triggers a full re-cluster, and
deletes only degrade list occupancy (the validity mask keeps them
unreturnable).  A rebuild drops tombstoned rows from the lists entirely.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import truncated as T
from repro_torch.core.index import lookup_prefix
from repro_torch.core.ivf import (
    balanced_assign,
    ivf_progressive_search_kernel,
    ivf_progressive_search_kernel_plain,
    ivf_progressive_search_sched,
    ivf_progressive_search_sched_plain,
    kmeans,
    pack_lists,
)
from repro_torch.core.progressive import (
    progressive_search,
    progressive_search_plain,
    rescore_ladder,
)
from repro_torch.index_backends.base import (
    ChurnRebuildBackend,
    IndexState,
    StoreStats,
    register_backend,
)

Array = torch.Tensor


@register_backend
class IVFProgressiveBackend(ChurnRebuildBackend):
    """Coarse-quantized candidate generation + progressive rescore."""

    name = "ivf"

    def __init__(
        self,
        sched,
        *,
        metric: str = "l2",
        block_n: int = 65536,
        device="cuda",
        n_lists: Optional[int] = None,
        n_probe: int = 12,
        probe_dim: Optional[int] = None,
        balance_factor: Optional[float] = 2.0,
        assign_m: int = 8,
        kmeans_iters: int = 10,
        train_rows: int = 131072,
        assign_block: int = 65536,
        rebuild_frac: float = 0.25,
        min_rebuild_rows: int = 64,
        tail_window: int = 512,
        min_index_rows: int = 64,
        append_spare: int = 8,
        use_kernel="auto",
        stage0_dtype: str = "float32",
        kernel_block_m: int = 128,
        kernel_merge: str = "sort",
        pq_m: Optional[int] = None,
        pq_codes: int = 256,
        pq_iters: int = 10,
        pq_oversample: int = 4,
        seed: int = 0,
    ):
        """Args beyond the shared engine config:

        n_lists:        coarse-quantizer cells (None: ~n_live / 64, capped
                        at 4096, snapped down to a power of two).
        n_probe:        cells scanned per query.
        probe_dim:      clustering/probing dimensionality (None: the
                        schedule's max dim).
        balance_factor: per-list capacity as a multiple of mean occupancy
                        (None: unbounded nearest-centroid assignment).
        assign_m:       centroid choices per row for balanced assignment.
        kmeans_iters / train_rows: k-means iterations and its bounded
                        training sample of live rows.
        assign_block:   rows scored per tile when assigning.
        rebuild_frac / min_rebuild_rows / tail_window: see
                        ``ChurnRebuildBackend``.
        min_index_rows: below this live-row count, skip clustering and
                        serve the flat path (state flag).
        append_spare:   free slots reserved per list for
                        ``absorb_appends`` (0 disables absorption).
        use_kernel:     'auto' | True | False — stage 0 through the IVF
                        scan kernel ('auto': on a CUDA device; True: on
                        either device, the plain scan on the CPU; False:
                        the gather-and-rescore route).
        stage0_dtype:   'float32' | 'int8' | 'pq' member slabs (int8 and
                        pq need the kernel route).
        kernel_block_m: member slabs are padded to a multiple of it (the
                        JAX package's kernel step; kept so packs carry over
                        between the packages with one layout).
        kernel_merge:   the JAX package's in-kernel merge strategy; the
                        CUDA kernels have one selection, so it is accepted
                        for configuration compatibility and not read.
        pq_m / pq_codes / pq_iters: 'pq' codebook shape and training.
        pq_oversample:  'pq' only: stage-0 survivor pool widens to
                        ``pq_oversample × k0``.
        seed:           seeds the training samples, k-means and codebooks.
        """
        super().__init__(
            sched, metric=metric, block_n=block_n, device=device,
            rebuild_frac=rebuild_frac, min_rebuild_rows=min_rebuild_rows,
            tail_window=tail_window,
        )
        self.n_lists = n_lists
        self.n_probe = int(n_probe)
        self.probe_dim = probe_dim
        self.balance_factor = balance_factor
        self.assign_m = int(assign_m)
        self.kmeans_iters = int(kmeans_iters)
        self.train_rows = int(train_rows)
        self.assign_block = int(assign_block)
        self.min_index_rows = int(min_index_rows)
        self.append_spare = int(append_spare)
        if use_kernel not in ("auto", True, False):
            raise ValueError(
                f"use_kernel must be 'auto'|True|False, got {use_kernel!r}")
        if stage0_dtype not in ("float32", "int8", "pq"):
            raise ValueError(
                f"stage0_dtype must be float32|int8|pq, got {stage0_dtype!r}")
        if use_kernel is True and metric != "l2":
            raise ValueError(
                "the IVF scan kernel scores L2 only; use metric='l2' or "
                "use_kernel='auto'/False")
        self.use_kernel = use_kernel
        self.stage0_dtype = stage0_dtype
        self.kernel_block_m = int(kernel_block_m)
        self.kernel_merge = kernel_merge
        self.pq_codes = int(pq_codes)
        self.pq_iters = int(pq_iters)
        self.pq_oversample = max(1, int(pq_oversample))
        s0_dim = sched.stages[0].dim
        if stage0_dtype == "pq":
            from repro_torch.core.pq import auto_pq_m
            self.pq_m = int(pq_m) if pq_m else auto_pq_m(s0_dim)
            if s0_dim % self.pq_m:
                raise ValueError(
                    f"pq_m={self.pq_m} does not divide the stage-0 dim "
                    f"{s0_dim}")
        else:
            self.pq_m = pq_m
        self.seed = int(seed)
        if stage0_dtype in ("int8", "pq") and not self._kernel_enabled():
            # coded member slabs only exist on the kernel route; silently
            # serving the float32 gather route instead would report a
            # traffic win that never happens
            raise ValueError(
                f"stage0_dtype={stage0_dtype!r} packs member slabs for the "
                f"IVF scan kernel, which is disabled here (use_kernel="
                f"{use_kernel!r} on device {self.device.type!r}); pass "
                "use_kernel=True or stage0_dtype='float32'")

    def _kernel_enabled(self) -> bool:
        if self.use_kernel is False or self.metric != "l2":
            return False
        if self.use_kernel is True:
            return True
        return self.device.type == "cuda"

    # -- build --------------------------------------------------------------
    def build(
        self,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> IndexState:
        live = (torch.nonzero(valid[: stats.size]).flatten().cpu().numpy()
                if stats.size else np.zeros((0,), np.int64))
        n_live = int(live.size)
        if n_live < self.min_index_rows:
            return IndexState.from_stats(
                self.name, stats,
                shape_key=(self.name, "flat-fallback"),
                data={"flat": True, "tail_cap": self._tail_cap(n_live)},
            )

        # auto n_lists snaps DOWN to a power of two: small corpus churn then
        # reproduces the same cell count (and thus the same shapes) across
        # rebuilds
        auto = min(max(1, n_live // 64), 4096)
        n_lists = self.n_lists or 1 << (auto.bit_length() - 1)
        n_lists = min(n_lists, n_live)
        d_probe = self.probe_dim or self.sched.d_max
        live_t = torch.as_tensor(live, device=db.device)

        def live_rows(sel) -> Array:
            # gather only what a step needs: never a copy of every live row
            return db[live_t[sel], :d_probe].to(torch.float32)

        # Train the quantizer on a bounded sample (the same numpy draw as
        # the JAX package); the assignment below covers every row.
        rng = np.random.default_rng(self.seed)
        if n_live > self.train_rows:
            sample = np.sort(rng.choice(n_live, self.train_rows,
                                        replace=False))
            train = live_rows(torch.as_tensor(sample, device=db.device))
        else:
            train = live_rows(slice(None))
        cents = kmeans(train, n_lists, n_iter=self.kmeans_iters,
                       seed=self.seed)
        del train
        # centroid norms are probe-time constants: cache them in the state
        cent_sq = (cents * cents).sum(dim=-1)

        m = min(self.assign_m, n_lists)
        # rank cells with the serving metric so assignment and probing
        # agree on what "nearest cell" means; tile over rows so the
        # (rows, n_lists) score matrix stays O(assign_block * n_lists)
        score_fn = T._METRICS[self.metric]
        best, choice_parts = [], []
        for lo in range(0, n_live, self.assign_block):
            s = score_fn(live_rows(slice(lo, lo + self.assign_block)), cents,
                         cent_sq)
            top_s, top_c = torch.sort(s, dim=1, stable=True)
            best.append(top_s[:, 0])
            choice_parts.append(top_c[:, :m])
        neg0 = (-torch.cat(best)).cpu().numpy()
        choices = torch.cat(choice_parts).cpu().numpy()
        if self.balance_factor is None or n_lists == 1:
            assign = choices[:, 0]
        else:
            cap = max(1, int(math.ceil(
                self.balance_factor * n_live / n_lists)))
            order = np.argsort(-neg0)               # confident rows first
            assign = balanced_assign(choices, order, n_lists, cap)

        # dense -1-padded table of *global* doc ids; append_spare slots stay
        # free for incremental absorption, width rounded up to a power of two
        table = pack_lists(assign, n_lists, ids=live,
                           spare=self.append_spare, round_pow2=True)
        max_len = table.shape[1]
        list_fill = np.bincount(assign, minlength=n_lists).astype(np.int64)
        tail_cap = self._tail_cap(n_live)
        lists = torch.as_tensor(table, device=db.device)

        kernel_on = self._kernel_enabled()
        pack = None
        if kernel_on:
            from repro_torch.kernels.ivf_scan import pack_ivf_lists
            s0_dim = self.sched.stages[0].dim
            codebooks = None
            if self.stage0_dtype == "pq":
                # ADC codebooks are fit on live rows at the stage-0 dim, on
                # the same bounded sample budget as the coarse quantizer
                from repro_torch.core.pq import train_pq
                tr = live
                if tr.size > self.train_rows:
                    tr = np.sort(rng.choice(tr, self.train_rows,
                                            replace=False))
                codebooks = train_pq(
                    db[torch.as_tensor(tr, device=db.device), :s0_dim],
                    m=self.pq_m, n_codes=self.pq_codes,
                    n_iter=self.pq_iters, seed=self.seed + 1)
            pack = pack_ivf_lists(
                db, lists, dim=s0_dim,
                db_sq_at_dim=lookup_prefix(sq_prefix, self.dims, s0_dim),
                dtype=self.stage0_dtype, block_m=self.kernel_block_m,
                pq_codebooks=codebooks,
            )
        return IndexState.from_stats(
            self.name, stats,
            shape_key=(self.name, n_lists, max_len, tail_cap,
                       kernel_on, self.stage0_dtype),
            data={
                "centroids": cents,                 # (n_lists, d_probe) f32
                "cent_sq": cent_sq,                 # (n_lists,) f32 cached
                "lists": lists,                     # (n_lists, max_len) i32
                "list_fill": list_fill,             # (n_lists,) host counts
                "absorb_upto": stats.size,          # rows examined so far
                "tail_pending": np.zeros((0,), np.int32),
                "pack": pack,                       # kernel member slabs
                "n_lists": n_lists,
                "max_len": max_len,
                "tail_cap": tail_cap,
            },
        )

    # -- incremental maintenance -------------------------------------------
    def _tail_load(self, state: IndexState, stats: StoreStats) -> int:
        if state.data.get("flat"):
            return super()._tail_load(state, stats)
        return (len(state.data["tail_pending"])
                + (stats.size - state.data["absorb_upto"]))

    def _alive(self, valid: Array, ids: np.ndarray) -> np.ndarray:
        return valid[torch.as_tensor(ids, device=valid.device).long()] \
            .cpu().numpy()

    def absorb_appends(
        self,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> None:
        """Assign appended rows to their nearest centroid's spare slots.

        Runs between rebuilds at engine safe points: each row in
        ``[absorb_upto, n_total)`` joins its nearest list if that list has a
        free slot, otherwise it stays in the tail window (``tail_pending``).
        Mutates ``state.data`` in place (the list table and the pack's slabs
        are written in place); every shape is preserved.
        """
        if state.data.get("flat") or self.append_spare == 0:
            # append_spare=0: appended rows ride the tail window until the
            # next rebuild
            return
        n_total = stats.size
        upto = state.data["absorb_upto"]
        if n_total <= upto:
            # no new rows — deletes may have freed tail-window capacity;
            # re-check liveness only when something was deleted since the
            # last prune (this branch runs on every dispatch)
            pending = state.data["tail_pending"]
            if (pending.size
                    and state.data.get("pruned_at_deleted")
                    != stats.total_deleted):
                state.data["tail_pending"] = pending[self._alive(valid,
                                                                 pending)]
                state.data["pruned_at_deleted"] = stats.total_deleted
            return
        new_ids = np.arange(upto, n_total, dtype=np.int64)
        cents = state.data["centroids"]
        d_probe = cents.shape[1]
        score_fn = T._METRICS[self.metric]
        rows = db[torch.as_tensor(new_ids, device=db.device), :d_probe] \
            .to(torch.float32)
        nearest = torch.argmin(
            score_fn(rows, cents, state.data["cent_sq"]), dim=1).cpu().numpy()

        lists = state.data["lists"]
        pack = state.data["pack"]
        fill = state.data["list_fill"]
        max_len = state.data["max_len"]
        acc_ids, acc_lists, acc_slots, rejected = [], [], [], []
        for rid, lst in zip(new_ids, nearest):
            lst = int(lst)
            if fill[lst] < max_len:
                acc_ids.append(rid)
                acc_lists.append(lst)
                acc_slots.append(int(fill[lst]))
                fill[lst] += 1
            else:
                rejected.append(rid)
        if acc_ids:
            # in-place writes: absorbing a few rows never copies the table
            dev = lists.device
            lists[torch.as_tensor(acc_lists, device=dev),
                  torch.as_tensor(acc_slots, device=dev)] = \
                torch.as_tensor(acc_ids, dtype=torch.int32, device=dev)
            if pack is not None:
                from repro_torch.kernels.ivf_scan import update_pack
                dests = (np.asarray(acc_lists, np.int64) * pack["max_len"]
                         + np.asarray(acc_slots, np.int64))
                pack = update_pack(pack, db, np.asarray(acc_ids, np.int32),
                                   dests)
        pending = np.concatenate(
            [state.data["tail_pending"],
             np.asarray(rejected, np.int32)]).astype(np.int32)
        if pending.size:
            # tombstoned pending rows would hold window capacity forever;
            # the validity mask already makes them unreturnable
            pending = pending[self._alive(valid, pending)]
        state.data.update(
            lists=lists, pack=pack, list_fill=fill,
            absorb_upto=n_total, tail_pending=pending,
            pruned_at_deleted=stats.total_deleted,
        )

    def _tail_ids(self, state: IndexState, n_total: int) -> np.ndarray:
        """Static-shape (tail_cap,) window: pending + not-yet-absorbed ids."""
        cap = state.data["tail_cap"]
        out = np.full((cap,), -1, np.int32)
        ids = np.concatenate([
            state.data["tail_pending"],
            np.arange(state.data["absorb_upto"], n_total, dtype=np.int32),
        ])[:cap]
        out[: ids.size] = ids
        return out

    # -- search -------------------------------------------------------------
    def _route(self, q, state, db, valid, sq_prefix, n_total, overrides,
               plain, stage0_only=False):
        """Dispatch one search to the route the state was built for:
        flat fallback, kernel route (the state holds a pack) or sched
        route.  Returns (scores, candidates, stages the ladder still
        needs when ``stage0_only``)."""
        # adaptive degradation knobs: probe fewer lists, shrink the PQ
        # oversample pool, and — where the stage-0 dim isn't baked into
        # packed slabs — enter the ladder at a lower d_start rung
        sched, n_probe, pq_os = self._apply_overrides(state, overrides)
        if state.data.get("flat"):
            fn = progressive_search_plain if plain else progressive_search
            kw = {} if plain else {"stage0_only": stage0_only}
            scores, ids = fn(q, db, sched, sq_prefix=sq_prefix,
                             index_dims=self.dims, valid=valid,
                             block_n=min(self.block_n, db.shape[0]),
                             metric=self.metric, **kw)
            return scores, ids, sched.stages[1:]
        tail = torch.as_tensor(self._tail_ids(state, n_total),
                               device=db.device)
        kw = dict(valid=valid, sq_prefix=sq_prefix, index_dims=self.dims,
                  extra_cand=tail, metric=self.metric,
                  cent_sq=state.data["cent_sq"])
        if not plain:
            kw["stage0_only"] = stage0_only
        cents, lists = state.data["centroids"], state.data["lists"]
        if state.data["pack"] is not None:
            fn = (ivf_progressive_search_kernel_plain if plain
                  else ivf_progressive_search_kernel)
            scores, ids = fn(q, db, cents, lists, self.sched,
                             n_probe=n_probe, pack=state.data["pack"],
                             pq_oversample=pq_os, **kw)
            return scores, ids, self.sched.stages[1:]
        fn = (ivf_progressive_search_sched_plain if plain
              else ivf_progressive_search_sched)
        scores, ids = fn(q, db, cents, lists, sched, n_probe=n_probe, **kw)
        # the sched route has no stage-0 scores: ALL stages rescore
        return scores, ids, sched.stages

    def search(
        self,
        q: Array,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        n_total: int,
        k: int,
        overrides=None,
    ) -> Tuple[Array, Array]:
        scores, ids, _ = self._route(q, state, db, valid, sq_prefix, n_total,
                                     overrides, plain=False)
        return scores[:, :k], ids[:, :k]

    def search_plain(
        self,
        q: Array,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        n_total: int,
        k: int,
    ) -> Tuple[Array, Array]:
        scores, ids, _ = self._route(q, state, db, valid, sq_prefix, n_total,
                                     None, plain=True)
        return scores[:, :k], ids[:, :k]

    def _apply_overrides(self, state: IndexState, overrides):
        """Resolve (sched, n_probe, pq_oversample) for one dispatch.

        ``overrides.sched`` only applies where the stage-0 dim is not
        frozen into a build artifact (the flat fallback and the sched
        route); packed member slabs pin their stage-0 dim at build time, so
        the kernel route degrades via n_probe/oversample alone.
        """
        pq_os = self.pq_oversample if self.stage0_dtype == "pq" else 1
        if state.data.get("flat"):
            n_probe = self.n_probe
        else:
            n_probe = min(self.n_probe, state.data["n_lists"])
        if overrides is None:
            return self.sched, n_probe, pq_os
        sched = self.sched if overrides.sched is None else overrides.sched
        if not state.data.get("flat"):
            n_probe = min(
                max(1, int(round(self.n_probe * overrides.n_probe_frac))),
                state.data["n_lists"])
        if pq_os > 1:
            pq_os = max(1, int(round(pq_os * overrides.oversample_frac)))
        return sched, n_probe, pq_os

    def search_fenced(
        self,
        q: Array,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        n_total: int,
        k: int,
        fence,
        overrides=None,
    ) -> Tuple[Array, Array]:
        scores, cand, stages = self._route(q, state, db, valid, sq_prefix,
                                           n_total, overrides, plain=False,
                                           stage0_only=True)
        fence(cand if scores is None else (scores, cand))
        scores, ids = rescore_ladder(
            q, db, cand, stages, sq_prefix=sq_prefix, index_dims=self.dims,
            valid=valid, metric=self.metric, scores=scores)
        return scores[:, :k], ids[:, :k]

    def gauges(self, state: IndexState, stats: StoreStats):
        out = super().gauges(state, stats)
        if state.data.get("flat"):
            return out
        n_lists = state.data["n_lists"]
        max_len = state.data["max_len"]
        fill = state.data["list_fill"]
        out.update({
            "n_lists": float(n_lists),
            "list_fill_frac": (float(fill.sum()) / (n_lists * max_len)
                               if n_lists * max_len else 0.0),
            "append_spare_used": float(
                max(0, int(fill.sum()) - state.built_active)),
            "tail_pending": float(len(state.data["tail_pending"])),
            "absorbed_rows": float(
                state.data["absorb_upto"] - state.built_size),
        })
        return out

    # -- persistence ----------------------------------------------------------
    def _rebind_loaded(self, data, *, db, valid, sq_prefix=None) -> None:
        """Fit a loaded state to this backend's route: a state saved with
        member slabs serves through the kernel route only where this
        backend takes it, and a float32 state saved without slabs (built on
        the gather route) is packed here from the store's rows.  int8 and
        pq slabs need the grid the build fitted, so they cannot be packed
        at load."""
        if data.get("flat"):
            return
        if not self._kernel_enabled():
            data["pack"] = None
            return
        if data.get("pack") is not None:
            if data["pack"]["dtype"] != self.stage0_dtype:
                raise ValueError(
                    f"checkpointed IVF state has {data['pack']['dtype']!r} "
                    f"member slabs; this backend is configured for "
                    f"stage0_dtype={self.stage0_dtype!r}")
            return
        if self.stage0_dtype != "float32":
            raise ValueError(
                f"checkpointed IVF state has no member slabs (it was built "
                f"on the gather route); stage0_dtype={self.stage0_dtype!r} "
                f"slabs need the grid fitted at build time — rebuild, or "
                f"save the state from a backend built with use_kernel=True")
        from repro_torch.kernels.ivf_scan import pack_ivf_lists
        s0_dim = self.sched.stages[0].dim
        data["pack"] = pack_ivf_lists(
            db, data["lists"], dim=s0_dim,
            db_sq_at_dim=lookup_prefix(sq_prefix, self.dims, s0_dim),
            block_m=self.kernel_block_m)

    def describe(self) -> str:
        return (
            f"IVFProgressiveBackend(n_lists={self.n_lists or 'auto'}, "
            f"n_probe={self.n_probe}, rebuild_frac={self.rebuild_frac}, "
            f"metric={self.metric}, use_kernel={self.use_kernel}, "
            f"stage0_dtype={self.stage0_dtype})"
        )
