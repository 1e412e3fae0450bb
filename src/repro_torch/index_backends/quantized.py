"""Quantized-progressive backend: coded stage-0 scan, full-precision rescore.

The stage-0 scan still touches every row, but reads a compressed sketch —
the paper's "cheap sketch" idea applied to precision instead of (and
composed with) dimensionality.  Two codecs share the backend:

* ``codec='int8'`` — per-dimension symmetric int8 codes: 1 byte/dim
  (`repro_torch.core.quant`; stage 0 is a plain-PyTorch blocked product).
* ``codec='pq'``  — product-quantization codes: ``pq_m`` uint8 codes/row
  against per-subspace k-means codebooks, scored by ADC lookup tables
  (`repro_torch.core.pq`).  On the kernel route (``use_kernel``) the scan
  is the PQ scan kernel (`repro_torch.kernels.pq_scan`): the per-query
  (M, C) table sits in shared memory while the code rows stream through.

**Churn-aware maintenance.**  The grid the code block is coded on (int8
scale / PQ codebooks) is *frozen* between rebuilds: rows appended later
are encoded against it at engine safe points (``absorb_appends``) and
written into the code block in place, so append-heavy workloads stop
forcing early rebuilds — only rows past the block's capacity ride the tail
window.  Grids are refit at the next rebuild.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import (
    build_quantized_index,
    int8_encode,
    pad_pow2,
    quant_rest_stages,
    quantized_progressive_search,
    quantized_progressive_search_plain,
    scatter_rows,
    scatter_rows2,
)
from repro_torch.core.progressive import rescore_ladder
from repro_torch.index_backends.base import (
    ChurnRebuildBackend,
    IndexState,
    StoreStats,
    register_backend,
)

Array = torch.Tensor


@register_backend
class QuantizedProgressiveBackend(ChurnRebuildBackend):
    """Coded stage-0 block scan + exact progressive rescore."""

    name = "quantized"

    def __init__(
        self,
        sched,
        *,
        metric: str = "l2",
        block_n: int = 65536,
        device="cuda",
        rebuild_frac: float = 0.25,
        min_rebuild_rows: int = 64,
        tail_window: int = 512,
        codec: str = "int8",
        pq_m: Optional[int] = None,
        pq_codes: int = 256,
        pq_iters: int = 10,
        pq_train_rows: int = 65536,
        pq_oversample: int = 4,
        encode_appends: bool = True,
        use_kernel="auto",
        kernel_block_m: int = 128,
        kernel_merge: str = "sort",
        seed: int = 0,
    ):
        """Args beyond the shared churn config:

        codec:          'int8' (per-dim symmetric codes) | 'pq' (product
                        quantization: pq_m uint8 codes/row + ADC tables).
        pq_m / pq_codes / pq_iters / pq_train_rows: 'pq' codebook shape
                        and training (on a bounded sample of live rows).
        pq_oversample:  'pq' only: stage-0 survivor pool widens to
                        ``pq_oversample × k0``.
        encode_appends: encode appended rows against the frozen grid at
                        engine safe points instead of riding the tail
                        window.
        use_kernel:     'pq' only: 'auto' | True | False — stage 0 through
                        the PQ scan kernel ('auto': on a CUDA device; True:
                        on either device, the plain scan on the CPU; False:
                        the plain-PyTorch ADC scan).  The int8 stage 0 is a
                        plain product on every route.
        kernel_block_m / kernel_merge: the JAX package's kernel step and
                        merge strategy; accepted for configuration
                        compatibility and not read.
        seed:           seeds the codebooks' training sample and init.
        """
        super().__init__(
            sched, metric=metric, block_n=block_n, device=device,
            rebuild_frac=rebuild_frac, min_rebuild_rows=min_rebuild_rows,
            tail_window=tail_window,
        )
        if metric != "l2":
            raise ValueError(
                "QuantizedProgressiveBackend supports metric='l2' only "
                "(coded stage-0 scores are rank-equivalent L2 distances)"
            )
        if codec not in ("int8", "pq"):
            raise ValueError(f"codec must be int8|pq, got {codec!r}")
        if use_kernel not in ("auto", True, False):
            raise ValueError(
                f"use_kernel must be 'auto'|True|False, got {use_kernel!r}")
        if use_kernel is True and codec != "pq":
            raise ValueError(
                "use_kernel applies to codec='pq' (the PQ scan kernel); "
                "the int8 stage 0 is a plain product")
        self.codec = codec
        self.pq_codes = int(pq_codes)
        self.pq_iters = int(pq_iters)
        self.pq_train_rows = int(pq_train_rows)
        self.pq_oversample = max(1, int(pq_oversample))
        self.encode_appends = bool(encode_appends)
        self.use_kernel = use_kernel
        self.kernel_block_m = int(kernel_block_m)
        self.kernel_merge = kernel_merge
        self.seed = int(seed)
        s0_dim = sched.stages[0].dim
        if codec == "pq":
            from repro_torch.core.pq import auto_pq_m
            self.pq_m = int(pq_m) if pq_m else auto_pq_m(s0_dim)
            if s0_dim % self.pq_m:
                raise ValueError(
                    f"pq_m={self.pq_m} does not divide the stage-0 dim "
                    f"{s0_dim}")
        else:
            self.pq_m = pq_m

    def _kernel_enabled(self) -> bool:
        if self.codec != "pq" or self.use_kernel is False:
            return False
        if self.use_kernel is True:
            return True
        return self.device.type == "cuda"

    # -- build ---------------------------------------------------------------
    def build(
        self,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> IndexState:
        # Code the whole buffer (shape = capacity); the grid is fit on live
        # rows only, and dead/unpopulated rows are masked at search.
        if self.codec == "pq":
            from repro_torch.core.pq import build_pq_index
            idx = build_pq_index(
                db, self.sched, m=self.pq_m, n_codes=self.pq_codes,
                n_iter=self.pq_iters, train_rows=self.pq_train_rows,
                valid=valid, seed=self.seed)
            n_coded = int(idx["codes"].shape[0])
        else:
            idx = build_quantized_index(db, self.sched, valid=valid)
            n_coded = int(idx["db0_q"].shape[0])
        tail_cap = self._tail_cap(stats.n_active)
        return IndexState.from_stats(
            self.name, stats,
            shape_key=(self.name, self.codec, n_coded, tail_cap,
                       self._kernel_enabled()),
            data={
                "idx": idx,
                "tail_cap": tail_cap,
                "codec": self.codec,
                # rows [0, coded_upto) carry codes on the state's frozen
                # grid: the built prefix, extended in place by
                # absorb_appends up to the block's capacity
                "coded_upto": min(stats.size, n_coded),
                "n_coded": n_coded,
            },
        )

    # -- incremental maintenance ----------------------------------------------
    def _tail_load(self, state: IndexState, stats: StoreStats) -> int:
        return stats.size - state.data["coded_upto"]

    def absorb_appends(
        self,
        state: IndexState,
        db: Array,
        valid: Array,
        *,
        sq_prefix: Optional[Array] = None,
        stats: StoreStats,
    ) -> None:
        """Encode appended rows against the state's frozen grid, in place.

        Rows in ``[coded_upto, n_total)`` that still fit the code block are
        encoded with the build-time scale/codebooks and written into it;
        rows past the block's capacity (the store grew) ride the tail
        window until the next rebuild.  Every shape is preserved.
        """
        if not self.encode_appends:
            return
        upto = state.data["coded_upto"]
        n_new = min(stats.size, state.data["n_coded"]) - upto
        if n_new <= 0:
            return
        ids = torch.as_tensor(
            pad_pow2(np.arange(upto, upto + n_new, dtype=np.int64)),
            device=db.device)
        idx = state.data["idx"]
        if self.codec == "pq":
            from repro_torch.core.pq import pq_encode
            ds = idx["codebooks"].shape[0] * idx["codebooks"].shape[2]
            scatter_rows(idx["codes"], ids,
                         pq_encode(db[ids, :ds], idx["codebooks"]))
        else:
            ds = idx["db0_q"].shape[1]
            new, new_sq = int8_encode(db[ids, :ds], idx["scale0"])
            scatter_rows2(idx["db0_q"], idx["sq0"], ids, new, new_sq)
        state.data["coded_upto"] = upto + n_new

    def _tail_ids(self, state: IndexState, n_total: int) -> np.ndarray:
        """Static-shape (tail_cap,) window over rows past the coded prefix."""
        cap = state.data["tail_cap"]
        out = np.full((cap,), -1, np.int32)
        upto = state.data["coded_upto"]
        n_tail = min(max(n_total - upto, 0), cap)
        if n_tail:
            out[:n_tail] = np.arange(upto, upto + n_tail, dtype=np.int32)
        return out

    # -- search ---------------------------------------------------------------
    def _stage(self, q, state, db, valid, n_total, overrides, plain,
               stage0_only=False):
        """One search through the codec's route; ``plain`` selects the
        kernels' plain versions.  Returns (scores, ids-or-candidates, tail)."""
        from repro_torch.core import pq as P

        idx = state.data["idx"]
        tail = torch.as_tensor(self._tail_ids(state, n_total),
                               device=db.device)
        kw = dict(
            metric=self.metric,
            db=db,                       # rescore against the LIVE buffer
            valid=valid,
            # rows past the coded prefix have no codes: keep them out of
            # stage-0 ranking, reachable via the tail injection instead
            row_limit=state.data["coded_upto"],
            extra_cand=tail,
        )
        if not plain:
            kw["stage0_only"] = stage0_only
        if self.codec == "pq":
            # adaptive degradation: the codes are built at a fixed dim, so
            # the only per-dispatch lever is the PQ oversample pool
            pq_os = self._oversample(overrides)
            if self._kernel_enabled():
                fn = (P.pq_progressive_search_kernel_plain if plain
                      else P.pq_progressive_search_kernel)
            elif plain:
                fn = P.pq_progressive_search_kernel_plain
            else:
                fn = P.pq_progressive_search
            scores, ids = fn(q, idx, self.sched, oversample=pq_os, **kw)
        else:
            fn = (quantized_progressive_search_plain if plain
                  else quantized_progressive_search)
            scores, ids = fn(q, idx, self.sched, block_n=self.block_n, **kw)
        return scores, ids, tail

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
        scores, ids, _ = self._stage(q, state, db, valid, n_total, overrides,
                                     plain=False)
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
        scores, ids, _ = self._stage(q, state, db, valid, n_total, None,
                                     plain=True)
        return scores[:, :k], ids[:, :k]

    def _oversample(self, overrides) -> int:
        if overrides is None:
            return self.pq_oversample
        return max(1, int(round(
            self.pq_oversample * overrides.oversample_frac)))

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
        scores, cand, tail = self._stage(q, state, db, valid, n_total,
                                         overrides, plain=False,
                                         stage0_only=True)
        fence((scores, cand))
        # the stage-0 outputs already carry the injected tail; finish with
        # the same ladder stages the unfenced route picks
        rest = quant_rest_stages(self.sched, extra_cand=tail, valid=valid)
        scores, ids = rescore_ladder(q, db, cand, rest, valid=valid,
                                     metric=self.metric, scores=scores)
        return scores[:, :k], ids[:, :k]

    def gauges(self, state: IndexState, stats: StoreStats):
        out = super().gauges(state, stats)
        n_coded = state.data["n_coded"]
        out.update({
            "coded_upto": float(state.data["coded_upto"]),
            "coded_frac": (min(stats.size, state.data["coded_upto"])
                           / stats.size if stats.size else 1.0),
            "code_block_rows": float(n_coded),
        })
        return out

    # -- persistence ----------------------------------------------------------
    # the idx's ``db`` entry is the store's own buffer — huge and
    # reconstructable: drop it at save, re-bind the live buffer at load
    _SAVE_SKIP = ("idx/db",)

    def _rebind_loaded(self, data, *, db, valid, sq_prefix=None) -> None:
        if data.get("codec") != self.codec:
            raise ValueError(
                f"checkpointed quantized index uses codec="
                f"{data.get('codec')!r}; this backend is configured for "
                f"{self.codec!r}")
        n_coded = data["n_coded"]
        if db.shape[0] < n_coded:
            raise ValueError(
                f"checkpointed code block covers {n_coded} buffer rows but "
                f"the store's capacity is {db.shape[0]}; the code block is "
                f"capacity-shaped — restore into a store grown to at least "
                f"the saved capacity")
        data["idx"]["db"] = db

    def describe(self) -> str:
        pq = f", pq_m={self.pq_m}" if self.codec == "pq" else ""
        return (
            f"QuantizedProgressiveBackend(codec={self.codec}{pq}, "
            f"rebuild_frac={self.rebuild_frac}, metric={self.metric}, "
            f"use_kernel={self.use_kernel})"
        )
