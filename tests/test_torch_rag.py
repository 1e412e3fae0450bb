"""The port's RAG pipeline against the JAX package's, on the CPU.

Both pipelines get the same corpus (seeded numpy token rows), the same LM
weights (the JAX package's ``init_lm`` pytree carried through
``load_jax_params``) and the same queries; retrieval runs the flat engine
on ``device="cpu"`` (the kernels' plain versions) and generation the LM.

Tolerance: retrieved ids equal, scores and embeddings ``rtol=atol=2e-4``
(float32 sums in another order), generated token ids equal.  Then the
pipeline's own contract: token rows follow a compaction remap, the driver
route returns what the synchronous route returns, and a -1 sentinel
prepends padding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.configs.mistral_nemo_12b import SMOKE_CONFIG as J_SMOKE
from repro.models import lm as JLM
from repro.rag import RAGPipeline as JRAGPipeline
from repro.rag.pipeline import mean_pool_embedder as j_embedder

from repro_torch.configs.mistral_nemo_12b import SMOKE_CONFIG
from repro_torch.engine import RetrievalEngine
from repro_torch.models import lm as TLM
from repro_torch.rag import RAGPipeline, mean_pool_embedder, pipeline

TOL = 2e-4
N_DOCS, DOC_LEN, Q_LEN = 40, 12, 6


@pytest.fixture(scope="module")
def world():
    params = JLM.init_lm(jax.random.PRNGKey(0), J_SMOKE)
    lm = TLM.load_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params),
        SMOKE_CONFIG, device="cpu")
    rng = np.random.default_rng(0)
    docs = rng.integers(1, SMOKE_CONFIG.vocab, (N_DOCS, DOC_LEN)).astype(np.int32)
    docs[3, 8:] = 0                                    # padded doc text
    return params, lm, docs


def _pipes(world, **kw):
    params, lm, docs = world
    jdb = j_embedder(params, J_SMOKE)(jnp.asarray(docs))
    jpipe = JRAGPipeline(params, J_SMOKE, jdb, jnp.asarray(docs), **kw)
    tdb = mean_pool_embedder(lm)(docs)
    tpipe = RAGPipeline(lm, tdb, docs, device="cpu", **kw)
    return jpipe, tpipe


def _queries(docs, seed=1):
    """Query rows whose mean-pooled vector lies near a known doc: the doc's
    first Q_LEN tokens."""
    rng = np.random.default_rng(seed)
    src = rng.choice(N_DOCS, 5, replace=False)
    return src, docs[src, :Q_LEN]


class TestParity:
    def test_mean_pool_embedder(self, world, monkeypatch):
        params, lm, docs = world
        want = j_embedder(params, J_SMOKE)(jnp.asarray(docs))
        # chunks of 7 documents: the last chunk is a partial one
        monkeypatch.setattr(pipeline, "EMBED_CHUNK_BYTES", 7 * DOC_LEN * 128 * 4)
        got = mean_pool_embedder(lm)(docs)
        assert got.shape == (N_DOCS, 128) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("d_start,k0", [(32, 32), (16, 8)])
    def test_serve_matches_reference(self, world, d_start, k0):
        jpipe, tpipe = _pipes(world, d_start=d_start, k0=k0)
        _, q = _queries(world[2])
        want = jpipe.serve(jnp.asarray(q), max_new_tokens=5)
        got = tpipe.serve(q, max_new_tokens=5)
        np.testing.assert_array_equal(got["retrieved"], want["retrieved"])
        np.testing.assert_allclose(got["retrieval_scores"],
                                   want["retrieval_scores"],
                                   rtol=TOL, atol=TOL)
        assert got["generated"].shape == (5, 5)
        np.testing.assert_array_equal(got["generated"].numpy(),
                                      np.asarray(want["generated"]))

    def test_copies_retrieve_their_source(self, world):
        _, tpipe = _pipes(world)
        docs = world[2]
        _, idx = tpipe.retrieve(docs[[0, 5, 17, 39]])
        np.testing.assert_array_equal(idx[:, 0], [0, 5, 17, 39])

    def test_add_and_delete_through_compaction(self, world):
        """Mutations on both pipelines, a compaction remap on both: token
        tables, retrieval and generation stay equal."""
        params, lm, docs = world
        jpipe, tpipe = _pipes(world, d_start=16, k0=8)
        rng = np.random.default_rng(3)
        extra = rng.integers(1, SMOKE_CONFIG.vocab, (60, DOC_LEN)).astype(np.int32)
        jpipe.add_docs(j_embedder(params, J_SMOKE)(jnp.asarray(extra)),
                       jnp.asarray(extra))
        ids = tpipe.add_docs(mean_pool_embedder(lm)(extra), extra)
        np.testing.assert_array_equal(ids, np.arange(N_DOCS, N_DOCS + 60))
        assert tpipe._tokens.shape[0] >= 100 and tpipe._tokens_owned
        dead = np.arange(0, 100, 2)
        for p in (jpipe, tpipe):
            assert p.delete_docs(dead) == 50
            assert p.engine.maybe_rebuild(force=True)
        assert tpipe.engine.stats.n_compactions == 1
        np.testing.assert_array_equal(tpipe.doc_tokens, jpipe.doc_tokens)
        np.testing.assert_array_equal(
            tpipe.doc_tokens, np.concatenate([docs, extra])[1::2])
        q = np.concatenate([docs, extra])[[1, 7, 55, 99], :Q_LEN]
        want = jpipe.serve(jnp.asarray(q), max_new_tokens=3)
        got = tpipe.serve(q, max_new_tokens=3)
        np.testing.assert_array_equal(got["retrieved"], want["retrieved"])
        np.testing.assert_array_equal(got["generated"].numpy(),
                                      np.asarray(want["generated"]))


@pytest.fixture
def small(world):
    _, lm, docs = world
    return RAGPipeline(lm, mean_pool_embedder(lm)(docs[:6]), docs[:6],
                       d_start=4, k0=4, device="cpu"), docs[:6]


class TestPipelineContract:
    def test_add_docs_validates_before_mutating(self, small):
        pipe, toks = small
        db = pipe.embed(toks)
        with pytest.raises(ValueError):        # count mismatch
            pipe.add_docs(db[:2], toks[:1])
        with pytest.raises(ValueError):        # width mismatch
            pipe.add_docs(db[:1], np.zeros((1, 9), np.int32))
        assert pipe.engine.store.size == 6

    def test_sentinel_prepends_padding_not_doc0(self, small):
        pipe, toks = small
        prompts = pipe.assemble_prompts(toks[:2], np.asarray([[-1], [3]]))
        assert prompts.shape == (2, 2 * DOC_LEN)
        assert (prompts[0, :DOC_LEN] == 0).all()
        np.testing.assert_array_equal(prompts[1, :DOC_LEN].numpy(), toks[3])

    def test_zero_doc_corpus_serves(self, small):
        pipe, toks = small
        pipe.delete_docs(list(range(6)))
        out = pipe.serve(toks[:1], max_new_tokens=2)
        assert out["retrieved"][0, 0] == -1
        assert out["generated"].shape == (1, 2)

    def test_driver_path_matches_sync_path(self, small):
        pipe, toks = small
        _, sync_ids = pipe.retrieve(toks[:3])
        pipe.start_driver(max_wait_ms=0.5)
        try:
            _, driver_ids = pipe.retrieve(toks[:3])
            np.testing.assert_array_equal(driver_ids, sync_ids)
        finally:
            pipe.stop_driver()
        _, after = pipe.retrieve(toks[:3])
        np.testing.assert_array_equal(after, sync_ids)

    def test_driver_results_refreshed_when_compaction_races_delivery(
            self, small):
        """A compaction between a driver dispatch and the gather must not
        leak pre-remap ids: retrieve() re-searches the stale rows."""
        pipe, toks = small
        eng = pipe.engine
        pipe.start_driver(max_wait_ms=0.5)
        try:
            orig, fired = eng.execute_batch, []

            def tampered(reqs):
                out = orig(reqs)
                if not fired:
                    fired.append(True)
                    eng.delete_docs([3, 4, 5])   # dead_frac 0.5 >= 0.3
                    eng.maybe_rebuild(force=True)
                return out

            eng.execute_batch = tampered
            try:
                _, ids = pipe.retrieve(toks[:3])
            finally:
                eng.execute_batch = orig
            assert eng.stats.n_compactions == 1
            assert (ids < pipe.doc_tokens.shape[0]).all()
            _, expected = pipe.retrieve(toks[:3])
            np.testing.assert_array_equal(ids, expected)
        finally:
            pipe.stop_driver()

    def test_conflicting_engine_args_rejected(self, small):
        pipe, toks = small
        db = pipe.embed(toks)
        eng = RetrievalEngine(db.shape[1], d_start=4, k0=4, capacity=8,
                              device="cpu")
        with pytest.raises(ValueError):
            RAGPipeline(pipe.lm, db, toks, engine=eng, buckets=(64,),
                        device="cpu")
        eng.add_docs(db[:1])
        with pytest.raises(ValueError, match="must be empty"):
            RAGPipeline(pipe.lm, db, toks, engine=eng, device="cpu")

    def test_closed_loop_launcher(self, capsys):
        from repro_torch.launch import serve
        import sys
        argv = sys.argv
        sys.argv = ["serve", "--docs", "60", "--requests", "10", "--batch",
                    "5", "--new-tokens", "2", "--clients", "2",
                    "--device", "cpu"]
        try:
            serve.main()
        finally:
            sys.argv = argv
        out = capsys.readouterr().out
        assert "hit-rate=100.0%" in out and "[decode]" in out
