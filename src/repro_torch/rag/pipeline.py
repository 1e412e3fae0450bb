"""End-to-end RAG serving pipeline: the port of ``src/repro/rag/pipeline.py``.

    query tokens ──embed──> query vector ──RetrievalEngine──> top-k docs
         └───────────────────────── prompt assembly ──> LM decode ──> answer

The embedder is pluggable; the default mean-pools the LM's own token
embeddings.  Retrieval runs through `repro_torch.engine.RetrievalEngine`
(shape-bucketed batches over a mutable corpus on the card), and
``add_docs`` / ``delete_docs`` keep the host token table and the engine's
rows in step.  ``start_driver()`` puts an async ``EngineDriver`` in front
of the engine so that queries from many threads coalesce; ``retrieve`` and
``serve`` then route through it.  Generation is greedy: ``prefill`` over
the assembled prompts into the model's decode cache, whatever its layout,
then ``decode_step`` per new token; attention runs through the flash
kernel on the card (MLA's absorbed decode excepted).

Everything runs on ``device`` ("cuda" unless the caller passes "cpu"): the
LM's weights, the engine's rows and the prompts.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ProgressiveSchedule, make_schedule
from repro_torch.engine import EngineDriver, RetrievalEngine
from repro_torch.models import lm as LM

Tensor = torch.Tensor

#: Token-embedding bytes (float32) one embedder chunk may gather at once.
EMBED_CHUNK_BYTES = 256 << 20


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mean_pool_embedder(lm: LM.LM) -> Callable[[Tensor], Tensor]:
    """Embed token ids by mean-pooling the LM's token-embedding rows.

    Token 0 is padding and is left out of the mean.  The (B, S, D) float32
    gather is built a chunk of documents at a time (at most
    ``EMBED_CHUNK_BYTES``),
    so a large corpus embeds on the card without materialising all of it.
    Returns (B, D) float32 on the LM's device.
    """
    table = lm.embed

    @torch.inference_mode()
    def embed(tokens) -> Tensor:                  # (B, S) -> (B, D)
        tokens = torch.as_tensor(tokens, device=table.device)
        b, s = tokens.shape
        d = table.shape[1]
        out = torch.empty((b, d), dtype=torch.float32, device=table.device)
        step = max(1, EMBED_CHUNK_BYTES // max(1, s * d * 4))
        for lo in range(0, b, step):
            t = tokens[lo:lo + step].long()
            e = table[t].to(torch.float32)
            mask = (t > 0)[..., None].to(torch.float32)
            out[lo:lo + step] = (e * mask).sum(1) / torch.clamp(
                mask.sum(1), min=1.0)
        return out

    return embed


class RAGPipeline:
    """Retrieval-augmented generation over a mutable document corpus."""

    def __init__(
        self,
        lm: LM.LM,
        doc_embeddings,                 # (N, D_emb)
        doc_tokens,                     # (N, doc_len) int — corpus text
        *,
        schedule: Optional[ProgressiveSchedule] = None,
        embedder: Optional[Callable] = None,
        d_start: int = 32,
        k0: int = 32,
        buckets: Optional[Sequence[int]] = None,
        backend: Optional[str] = None,
        backend_opts: Optional[Dict] = None,
        engine: Optional[RetrievalEngine] = None,
        device="cuda",
    ):
        self.lm = lm
        self.cfg = lm.cfg
        self.device = torch.device(device)
        if lm.embed.device.type != self.device.type:
            raise ValueError(f"the LM lives on {lm.embed.device}, the "
                             f"pipeline on {self.device}")
        # Host-side token table with capacity doubling, mirroring DocStore's
        # growth so streaming add_docs stays amortized O(1) per append.
        self._tokens = np.asarray(_host(doc_tokens), np.int32)
        # np.asarray may alias the caller's buffer; in-place writes wait
        # until growth/compaction copies it
        self._tokens_owned = False
        self._n_tokens = self._tokens.shape[0]
        db = torch.as_tensor(doc_embeddings, dtype=torch.float32,
                             device=self.device)
        d_emb = db.shape[1]
        self.sched = schedule or make_schedule(min(d_start, d_emb), d_emb, k0)
        if engine is not None:
            if engine.store.size != 0:
                # doc ids double as doc_tokens row numbers; a pre-populated
                # engine would offset every id and silently fetch wrong text
                raise ValueError(
                    f"caller-supplied engine must be empty, holds "
                    f"{engine.store.size} docs")
            if engine.store.d_emb != d_emb:
                raise ValueError(
                    f"engine dim {engine.store.d_emb} != embedding dim {d_emb}")
            if engine.device.type != self.device.type:
                raise ValueError(f"engine on {engine.device}, pipeline on "
                                 f"{self.device}")
            # the engine's own schedule/buckets are what retrieve() runs —
            # reject conflicting explicit args rather than silently ignoring
            if schedule is not None and schedule != engine.sched:
                raise ValueError(
                    "explicit schedule conflicts with supplied engine's "
                    "schedule; pass one or the other")
            if buckets is not None and tuple(buckets) != engine.policy.sizes:
                raise ValueError(
                    f"explicit buckets {tuple(buckets)} conflict with "
                    f"supplied engine's {engine.policy.sizes}")
            if backend is not None or backend_opts is not None:
                raise ValueError(
                    "explicit backend/backend_opts conflict with the "
                    "supplied engine's backend; pass one or the other")
            self.sched = engine.sched
            self.engine = engine
        else:
            self.engine = RetrievalEngine(
                d_emb, schedule=self.sched,
                capacity=max(1, db.shape[0]),
                buckets=buckets if buckets is not None
                else (1, 2, 4, 8, 16, 32),
                backend=backend or "flat",
                backend_opts=backend_opts,
                device=self.device)
        # Compaction remaps engine doc ids; follow with the token table so
        # ids keep doubling as token-row numbers.
        self.engine.on_remap.append(self._apply_remap)
        self.engine.add_docs(db)
        self.embed = embedder or mean_pool_embedder(lm)
        self._driver: Optional[EngineDriver] = None
        # store generation of the last compaction remap (written in
        # _apply_remap under engine.lock): driver-path results dispatched
        # before it hold pre-remap ids that no longer index the token table
        self._last_remap_gen = 0

    # -- async serving driver -------------------------------------------------
    @property
    def driver(self) -> Optional[EngineDriver]:
        """The running ``EngineDriver`` (None while serving synchronously)."""
        return self._driver

    def start_driver(self, *, max_wait_ms: float = 2.0, max_queue: int = 1024,
                     **driver_kw) -> EngineDriver:
        """Put an async batching driver in front of the engine and start it.

        While the driver runs, ``retrieve``/``serve`` submit through it (one
        future per query) instead of calling ``engine.search``.
        """
        if self._driver is not None:
            raise RuntimeError("driver already running; stop_driver() first")
        self._driver = EngineDriver(
            self.engine, max_wait_ms=max_wait_ms, max_queue=max_queue,
            **driver_kw,
        ).start()
        return self._driver

    def stop_driver(self, *, drain: bool = True) -> None:
        """Stop the async driver (drain by default); idempotent."""
        if self._driver is not None:
            driver, self._driver = self._driver, None
            driver.stop(drain=drain)

    # -- corpus mutation ------------------------------------------------------
    @property
    def doc_tokens(self) -> np.ndarray:
        """(N, doc_len) int32 token rows, aligned with engine doc ids."""
        return self._tokens[:self._n_tokens]

    def add_docs(self, doc_embeddings, doc_tokens) -> np.ndarray:
        """Append docs (embeddings + token text); returns their stable ids."""
        embs = torch.as_tensor(doc_embeddings, dtype=torch.float32,
                               device=self.device)
        tokens = np.asarray(_host(doc_tokens), np.int32)
        # Validate before mutating the engine: a partial append would leave
        # searchable ids with no (or the wrong) token text behind them.
        if tokens.shape[0] != embs.shape[0]:
            raise ValueError(
                f"{embs.shape[0]} embeddings but {tokens.shape[0]} token rows")
        if tokens.shape[1] != self._tokens.shape[1]:
            raise ValueError(
                f"doc_tokens width {tokens.shape[1]} != corpus width "
                f"{self._tokens.shape[1]}")
        ids = self.engine.add_docs(embs)
        need = self._n_tokens + tokens.shape[0]
        if need > self._tokens.shape[0]:
            new_cap = max(2 * self._tokens.shape[0], need)
            grown = np.zeros((new_cap, self._tokens.shape[1]), np.int32)
            grown[:self._n_tokens] = self._tokens[:self._n_tokens]
            self._tokens = grown
            self._tokens_owned = True
        self._tokens[self._n_tokens:need] = tokens
        self._n_tokens = need
        return ids

    def delete_docs(self, ids) -> int:
        """Remove docs from retrieval.

        Token rows stay until the engine's next compaction, at which point
        ids are remapped and this pipeline's table follows automatically.
        """
        return self.engine.delete_docs(ids)

    def _apply_remap(self, id_map: np.ndarray) -> None:
        """Engine compaction callback: drop dead token rows, keep alignment.

        ``id_map`` maps old engine row ids to new ones (-1 = tombstoned);
        compaction preserves live-row order, so gathering the surviving
        token rows in old-id order reproduces the new id order exactly.
        """
        if id_map.shape[0] != self._n_tokens:
            raise RuntimeError(
                f"compaction remap covers {id_map.shape[0]} rows but the "
                f"token table holds {self._n_tokens} — corpus out of sync")
        live_old = np.nonzero(id_map >= 0)[0]
        rows = self._tokens[live_old]            # fancy index: a copy
        if not self._tokens_owned:
            # still aliasing the constructor argument: never write through it
            self._tokens = self._tokens.copy()
            self._tokens_owned = True
        self._n_tokens = live_old.size
        self._tokens[: self._n_tokens] = rows
        self._last_remap_gen = self.engine.store.generation

    # -- serving --------------------------------------------------------------
    def retrieve(self, query_tokens) -> Tuple[np.ndarray, np.ndarray]:
        """(B, S) query tokens -> ((B, k) scores, (B, k) doc indices).

        Routes through the async driver when one is running (each query
        becomes a future; the driver coalesces across concurrent callers),
        otherwise through the engine's synchronous bucketed batch API.
        """
        q = _host(self.embed(query_tokens)).astype(np.float32, copy=False)
        driver = self._driver
        if driver is None:
            return self.engine.search(q)
        if q.shape[0] == 0:
            k = self.engine.out_k
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        futures = [driver.submit(v) for v in q]
        results = [f.result() for f in futures]
        scores = np.stack([r.scores for r in results])
        ids = np.stack([r.doc_ids for r in results])
        with self.engine.lock:
            # A compaction can land between a result's dispatch and this
            # gather: such ids predate a remap the futures never saw, and
            # would index the already-reorganized token table wrongly.
            # store_generation detects exactly this; re-retrieve those rows
            # synchronously under the lock, until no row predates the last
            # remap (at most one compaction can fire in here: it clears
            # every tombstone and no other thread can delete meanwhile).
            gens = [r.store_generation for r in results]
            while True:
                cur = self.engine.store.generation
                stale = [j for j, g in enumerate(gens)
                         if g < self._last_remap_gen and g < cur]
                if not stale:
                    break
                scores[stale], ids[stale] = self.engine.search(q[stale])
                for j in stale:
                    gens[j] = self.engine.store.generation
        return scores, ids

    def assemble_prompts(self, query_tokens, doc_idx) -> Tensor:
        """Prepend the top-1 retrieved document to each query.

        A -1 index (nothing retrievable, e.g. fully-deleted corpus) prepends
        padding tokens instead of any document's text — deleted docs must not
        leak into prompts through the sentinel.  Returns (B, doc_len + S)
        int64 on the pipeline's device.
        """
        top1 = np.asarray(_host(doc_idx))[:, 0]
        doc_len = self._tokens.shape[1]
        if self._n_tokens == 0:
            docs = np.zeros((top1.shape[0], doc_len), np.int32)
        else:
            docs = self.doc_tokens[np.maximum(top1, 0)]    # (B, doc_len)
            docs = np.where((top1 >= 0)[:, None], docs, 0)
        prompts = np.concatenate(
            [docs, np.asarray(_host(query_tokens), np.int32)], axis=1)
        return torch.from_numpy(prompts.astype(np.int64)).to(self.device)

    @torch.inference_mode()
    def generate(self, query_tokens, doc_idx, *, max_new_tokens: int = 8
                 ) -> Tensor:
        """Greedy-decode answers given already-retrieved doc indices.

        Returns (B, max_new_tokens) int64 on the pipeline's device."""
        prompts = self.assemble_prompts(query_tokens, doc_idx)
        b, s = prompts.shape
        total = s + max_new_tokens

        logits, cache = LM.prefill(self.lm, prompts, decode_len=total)
        toks = torch.argmax(logits, dim=-1)[:, None]

        out = [toks]
        for i in range(max_new_tokens - 1):
            logits, cache = LM.decode_step(self.lm, cache, toks, s + i)
            toks = torch.argmax(logits, dim=-1)[:, None]
            out.append(toks)
        return torch.cat(out, dim=1)

    def serve(self, query_tokens, *, max_new_tokens: int = 8) -> Dict:
        """Full pipeline for a batch of requests; greedy decode."""
        scores, idx = self.retrieve(query_tokens)
        return {
            "retrieved": idx,
            "retrieval_scores": scores,
            "generated": self.generate(
                query_tokens, idx, max_new_tokens=max_new_tokens),
        }
