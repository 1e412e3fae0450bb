"""The port's serving engine against the JAX package's engine on the same docs.

Both engines get the same seeded numpy corpus, mutations and queries; the
port runs on ``device="cpu"`` (the plain search path).  Also: the state a
``repro`` store snapshots restores into the port, the package never imports
JAX or ``repro``, and the default device is CUDA (which raises here).

Tolerance: scores ``rtol=1e-5, atol=1e-4`` — the float32 dot products are
summed in another order by XLA and by torch.  Ids are compared up to ties:
where two ids differ, their scores must agree within the tolerance.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

from repro.engine import DocStore as JDocStore
from repro.engine import RetrievalEngine as JEngine
from repro_torch.engine import (DocStore, EngineDriver, ResultEvicted,
                                RetrievalEngine, SearchRequest)

RTOL, ATOL = 1e-5, 1e-4
D = 32
KW = dict(d_start=8, k0=16, final_k=4, buckets=(1, 4), capacity=64,
          block_n=64)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def assert_topk_close(got, want):
    """Scores close, sentinels identical, ids equal up to near-ties."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    np.testing.assert_array_equal(gi == -1, wi == -1)
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    differ = gi != wi
    assert np.allclose(gs[differ], ws[differ], rtol=RTOL, atol=ATOL), \
        "ids differ where scores are not tied"


@pytest.fixture(scope="module")
def pair():
    """(port engine, JAX engine, docs) holding the same corpus."""
    rng = np.random.default_rng(21)
    docs = rng.normal(size=(200, D)).astype(np.float32)
    ep = RetrievalEngine(D, device="cpu", **KW)
    ej = JEngine(D, **KW)
    for eng in (ep, ej):
        eng.add_docs(docs[:120])
        eng.add_docs(docs[120:160], tenant="acme",
                     metadata=[{"lang": "en" if j % 2 else "de"}
                               for j in range(40)])
        eng.add_docs(docs[160:], metadata={"lang": "en"})
    return ep, ej, docs


def _queries(docs, n, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, docs.shape[0], n)
    return docs[rows] + 0.3 * rng.normal(size=(n, D)).astype(np.float32)


class TestEngineParity:
    def test_search_matches(self, pair):
        ep, ej, docs = pair
        q = _queries(docs, 9, 1)
        assert_topk_close(ep.search(q), ej.search(q))
        s, i = ep.search(q)
        assert s.dtype == np.float32 and i.dtype == np.int32
        assert ep.store.capacity == ej.store.capacity == 256

    def test_tenant_and_filter_match(self, pair):
        ep, ej, docs = pair
        q = _queries(docs, 4, 2)
        for kw in ({"tenant": "acme"}, {"filter": {"lang": "en"}},
                   {"tenant": "acme", "filter": {"lang": "de"}}):
            got, want = ep.search(q, **kw), ej.search(q, **kw)
            assert_topk_close(got, want)
            ids = got[1][got[1] >= 0]
            if "tenant" in kw:
                assert ((ids >= 120) & (ids < 160)).all()

    def test_submit_step_poll_matches_search(self, pair):
        ep, ej, docs = pair
        q = _queries(docs, 5, 3)
        rids = [ep.submit(SearchRequest(v, k=3)) for v in q]
        jrids = [ej.submit(v) for v in q]
        assert ep.run_until_idle() == 5 and ej.run_until_idle() == 5
        for rid, jrid, v in zip(rids, jrids, q):
            res, jres = ep.poll(rid), ej.poll(jrid)
            assert res.doc_ids.shape == (3,)
            assert_topk_close((res.scores, res.doc_ids),
                              (jres.scores[:3], jres.doc_ids[:3]))
            assert res.stats.bucket in (1, 4)
        with pytest.raises(ResultEvicted):       # results pop once
            ep.poll(rids[0])
        st = ep.stats.summary()
        assert st["n_completed"] >= 5 and st["n_batches"] >= 2

    def test_driver_matches_search(self, pair):
        ep, _, docs = pair
        q = _queries(docs, 12, 4)
        want = ep.search(q)
        driver = EngineDriver(ep, max_wait_ms=1.0).start()
        try:
            futs = [driver.submit(v) for v in q]
            res = [f.result(timeout=30) for f in futs]
        finally:
            driver.stop()
        assert_topk_close((np.stack([r.scores for r in res]),
                           np.stack([r.doc_ids for r in res])), want)

    def test_deletes_match_and_never_return(self, pair):
        ep, ej, docs = pair
        q = docs[:6] + 0.01
        gone = np.array([0, 1, 2, 3, 4, 5, 130, 170])
        assert ep.delete_docs(gone) == ej.delete_docs(gone) == 8
        got, want = ep.search(q), ej.search(q)
        assert_topk_close(got, want)
        assert not np.isin(got[1], gone).any()
        assert ep.n_docs == ej.n_docs == 192


class TestEmptyAndSentinels:
    def test_empty_corpus_sentinels(self):
        ep = RetrievalEngine(16, d_start=4, k0=4, final_k=2, buckets=(1,),
                             capacity=8, device="cpu")
        ej = JEngine(16, d_start=4, k0=4, final_k=2, buckets=(1,), capacity=8)
        q = np.ones((1, 16), np.float32)
        s, i = ep.search(q)
        assert (i == -1).all() and np.isposinf(s).all()
        assert_topk_close((s, i), ej.search(q))

    def test_all_deleted(self):
        ep = RetrievalEngine(16, d_start=4, k0=4, final_k=2, buckets=(1,),
                             capacity=8, device="cpu")
        ids = ep.add_docs(np.eye(16, dtype=np.float32)[:5])
        ep.delete_docs(ids)
        s, i = ep.search(np.ones(16, np.float32))
        assert (i == -1).all() and np.isposinf(s).all()

    def test_growth_doubles_and_keeps_ids(self):
        ep = RetrievalEngine(16, d_start=4, k0=4, final_k=1, buckets=(1,),
                             capacity=4, device="cpu")
        rows = np.random.default_rng(5).normal(size=(11, 16)).astype(np.float32)
        assert ep.add_docs(rows[:3]).tolist() == [0, 1, 2]
        assert ep.add_docs(torch.from_numpy(rows[3:])).tolist() == list(range(3, 11))
        assert ep.store.capacity == 16
        _, i = ep.search(rows)
        assert i[:, 0].tolist() == list(range(11))


class TestRestoreFromJaxSnapshot:
    def test_restore_state_gives_same_results(self):
        rng = np.random.default_rng(31)
        docs = rng.normal(size=(90, D)).astype(np.float32)
        dims = (8, 16, 32)
        js = JDocStore(D, dims, capacity=32)
        js.add(docs[:60], tenant="t0", metadata={"kind": "a"})
        js.add(docs[60:])
        js.delete([3, 61, 62])
        arrays, meta = js.snapshot_state()

        ps = DocStore(D, dims, capacity=16, device="cpu")
        ps.restore_state(arrays, meta)
        assert (ps.size, ps.n_active, ps.capacity, ps.generation) == \
            (js.size, js.n_active, js.capacity, js.generation)
        assert ps.tenants() == js.tenants()
        np.testing.assert_allclose(ps.sq_prefix.numpy(),
                                   np.asarray(js.sq_prefix),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ps.valid.numpy(), np.asarray(js.valid))
        assert ps.mask_for_key(ps.compile_mask("t0")).numpy().tolist() == \
            np.asarray(js.mask_for_key(js.compile_mask("t0"))).tolist()

        ep = RetrievalEngine(D, device="cpu", **KW)
        ej = JEngine(D, **KW)
        ep.store.restore_state(arrays, meta)
        ej.store.restore_state(arrays, meta)
        q = docs[::9] + 0.05
        got, want = ep.search(q), ej.search(q)
        assert_topk_close(got, want)
        assert not np.isin(got[1], [3, 61, 62]).any()
        # and back: the port's snapshot carries the same arrays and meta
        arrays2, meta2 = ps.snapshot_state()
        assert meta2 == meta
        for key in arrays:
            np.testing.assert_array_equal(arrays2[key], arrays[key])


class TestPackageRules:
    def test_import_loads_neither_jax_nor_repro(self):
        # every module must import first, on its own (no import cycle), and
        # none may pull in JAX, the JAX package or msgpack (the checkpoint
        # and WAL files go through the package's own codec, so the card's
        # machine needs none of them)
        code = (
            "import sys, pkgutil, importlib, repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    repro_torch.__path__, 'repro_torch.')]\n"
            "assert len(names) > 20, names\n"
            "for name in names:\n"
            "    for mod in [m for m in sys.modules if m.startswith('repro_torch')]:\n"
            "        del sys.modules[mod]\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'repro', 'msgpack')]\n"
            "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(SRC))
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       timeout=120)

    def test_sources_never_import_jax_or_repro(self):
        for path in (SRC / "repro_torch").rglob("*.py"):
            for line in path.read_text().splitlines():
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), path
                assert not (s.startswith(("from repro.", "from repro ",
                                          "import repro."))
                            or s in ("import repro",)), path

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            eng = RetrievalEngine(8, d_start=4, k0=2, capacity=4)
            assert eng.store.db.is_cuda
            return
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RetrievalEngine(8, d_start=4, k0=2, capacity=4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DocStore(8, (4, 8))

    def test_unported_backends_raise(self):
        # every backend of the JAX package is served; a name neither
        # package runs is refused with the list of those it does
        from repro_torch.index_backends import backend_names
        assert set(backend_names()) >= {"flat", "ivf", "quantized"}
        with pytest.raises(ValueError, match="unknown index backend"):
            RetrievalEngine(16, d_start=4, k0=4, backend="hnsw", device="cpu")


# -- the backend contract (mirrors tests/test_backends.py) -------------------

RNG = np.random.default_rng(11)
_IVF = dict(n_lists=12, n_probe=6, min_index_rows=32, min_rebuild_rows=16)
_KERNEL = dict(_IVF, use_kernel=True, kernel_block_m=16)
VARIANTS = {
    "ivf": ("ivf", _IVF),                        # CPU 'auto': the sched route
    "ivf_kernel": ("ivf", _KERNEL),              # the scan's plain version
    "ivf_int8": ("ivf", dict(_KERNEL, stage0_dtype="int8")),
    "ivf_pq": ("ivf", dict(_KERNEL, stage0_dtype="pq")),
    "quantized": ("quantized", dict(min_rebuild_rows=16)),
    "quantized_pq": ("quantized", dict(min_rebuild_rows=16, codec="pq")),
}


def make_engine(variant, n_docs=200, seed=7, backend_opts=None, **kw):
    name, opts = VARIANTS[variant]
    kw = {**dict(d_start=8, k0=16, buckets=(4,), capacity=64, block_n=64),
          **kw}
    eng = RetrievalEngine(D, backend=name,
                          backend_opts=backend_opts or dict(opts),
                          device="cpu", **kw)
    db = np.random.default_rng(seed).normal(size=(n_docs, D)).astype(np.float32)
    eng.add_docs(db)
    return eng, db


@pytest.mark.parametrize("variant", sorted(VARIANTS))
class TestBackendContract:
    """Every IVF and quantized variant passes the JAX package's engine
    contract on ``device="cpu"``: deleted ids never come back, appended rows
    are reachable at once, and the rebuild / absorb lifecycle holds."""

    def test_exact_query_self_retrieval(self, variant):
        eng, db = make_engine(variant)
        _, idx = eng.search(db[:8])
        np.testing.assert_array_equal(idx[:, 0], np.arange(8))

    def test_deleted_doc_never_returned(self, variant):
        eng, db = make_engine(variant)
        _, before = eng.search(db[17:18])
        assert before[0, 0] == 17
        eng.delete_docs([17])
        _, after = eng.search(db[17:18])
        assert 17 not in after
        rid = eng.submit(db[17])
        eng.run_until_idle()
        assert 17 not in eng.poll(rid).doc_ids

    def test_added_doc_visible_without_rebuild(self, variant):
        eng, db = make_engine(variant)
        eng.search(db[:1])                       # the initial build
        n_rebuilds = eng.stats.n_rebuilds
        new = RNG.normal(size=(1, D)).astype(np.float32) * 5.0
        [nid] = eng.add_docs(new)
        _, idx = eng.search(new)
        assert idx[0, 0] == nid
        assert eng.stats.n_rebuilds == n_rebuilds

    def test_delete_survives_rebuild(self, variant):
        eng, db = make_engine(variant)
        eng.delete_docs([5])
        _, idx = eng.search(db[5:6])
        assert 5 not in idx
        assert eng.maybe_rebuild(force=True)
        _, idx = eng.search(db[5:6])
        assert 5 not in idx
        assert eng.index_state.built_active == len(db) - 1

    def test_churn_triggers_natural_rebuild(self, variant):
        eng, db = make_engine(variant)
        eng.search(db[:1])
        n_rebuilds = eng.stats.n_rebuilds
        extra = RNG.normal(size=(80, D)).astype(np.float32)
        ids = eng.add_docs(extra)
        _, idx = eng.search(extra[:4])
        np.testing.assert_array_equal(idx[:, 0], ids[:4])
        assert eng.stats.n_rebuilds > n_rebuilds

    def test_fully_deleted_corpus_returns_sentinel(self, variant):
        eng, db = make_engine(variant, n_docs=40)
        eng.delete_docs(np.arange(40))
        scores, idx = eng.search(db[:2])
        assert (idx == -1).all() and np.isposinf(scores).all()

    def test_tail_overflow_forces_rebuild_even_when_off(self, variant):
        opts = dict(VARIANTS[variant][1], min_rebuild_rows=4,
                    rebuild_frac=0.01)
        if variant.startswith("ivf"):
            opts["append_spare"] = 0
        else:
            opts["encode_appends"] = False
        eng, db = make_engine(variant, backend_opts=opts, rebuild_mode="off")
        eng.search(db[:1])
        n_rebuilds = eng.stats.n_rebuilds
        extra = RNG.normal(size=(12, D)).astype(np.float32)  # > tail_cap=4
        ids = eng.add_docs(extra)
        _, idx = eng.search(extra)
        np.testing.assert_array_equal(idx[:, 0], ids)
        assert eng.stats.n_rebuilds > n_rebuilds

    def test_appends_absorbed_between_rebuilds(self, variant):
        # a few appends are absorbed into the index (spare list slots /
        # codes on the frozen grid), stay reachable and trigger no rebuild;
        # an absorbed row that is deleted never comes back
        eng, db = make_engine(variant, capacity=256)
        eng.search(db[:1])
        n_rebuilds = eng.stats.n_rebuilds
        new = RNG.normal(size=(6, D)).astype(np.float32) * 4.0
        ids = eng.add_docs(new)
        _, idx = eng.search(new)
        np.testing.assert_array_equal(idx[:, 0], ids)
        state = eng.index_state
        g = eng.backend.gauges(state, eng.store.stats())
        if variant.startswith("ivf"):
            assert g["absorbed_rows"] == 6
            assert np.isin(ids, state.data["lists"].numpy()).sum() \
                + g["tail_pending"] == 6
        else:
            assert g["coded_upto"] == len(db) + 6 and g["tail_load"] == 0
        assert eng.stats.n_rebuilds == n_rebuilds
        eng.delete_docs(ids[:2])
        _, idx = eng.search(new)
        assert not np.isin(idx, ids[:2]).any()
        np.testing.assert_array_equal(idx[2:, 0], ids[2:])

    def test_post_compaction_search_correct(self, variant):
        eng, db = make_engine(variant, n_docs=120, compact_dead_frac=0.3)
        eng.search(db[:1])
        eng.delete_docs(np.arange(0, 120, 2))    # half the corpus
        _, idx = eng.search(db[1:7:2])           # odd (surviving) docs
        assert eng.stats.n_compactions == 1
        np.testing.assert_array_equal(idx[:, 0], [0, 1, 2])

    def test_background_build_adopts_state(self, variant):
        opts = dict(VARIANTS[variant][1], min_rebuild_rows=8,
                    rebuild_frac=0.05)
        eng, db = make_engine(variant, backend_opts=opts,
                              rebuild_mode="background")
        eng.search(db[:1])
        n_before = eng.stats.n_rebuilds
        extra = RNG.normal(size=(16, D)).astype(np.float32)
        ids = eng.add_docs(extra)
        _, idx = eng.search(extra[:4])           # old state + tail / absorb
        np.testing.assert_array_equal(idx[:, 0], ids[:4])
        deadline = time.perf_counter() + 30
        while eng.stats.n_rebuilds == n_before \
                and time.perf_counter() < deadline:
            eng.maybe_rebuild()                  # adopt when ready
            time.sleep(0.02)
        assert eng.stats.n_rebuilds > n_before
        _, idx = eng.search(extra[:4])
        np.testing.assert_array_equal(idx[:, 0], ids[:4])

    def test_warmup_covers_adaptive_levels(self, variant):
        from repro_torch.engine import AdaptiveConfig, EngineConfig
        from repro_torch.engine.config import IVFConfig, QuantizedConfig
        name, opts = VARIANTS[variant]
        block = (IVFConfig if name == "ivf" else QuantizedConfig)(**opts)
        eng = RetrievalEngine(config=EngineConfig(
            d_emb=D, d_start=16, k0=16, buckets=(1, 4), capacity=256,
            block_n=64, backend=block,
            adaptive=AdaptiveConfig(enabled=True, levels=2, min_d_start=8)),
            device="cpu")
        db = RNG.normal(size=(150, D)).astype(np.float32)
        eng.add_docs(db)
        eng.warmup()
        assert len(eng._level_overrides) == 2
        for lvl in (0, 1, 2):
            ov = eng._level_overrides.get(lvl)
            s, i, _ = eng._dispatch(db[:4], overrides=ov)
            np.testing.assert_array_equal(np.asarray(i)[:, 0], np.arange(4))
            assert np.isfinite(np.asarray(s)).all()
