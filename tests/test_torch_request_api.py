"""The port's typed request/config API, mirrored from the JAX package's
``tests/test_request_api.py``: `SearchRequest` normalization and
per-request options, filter canonicalization, `EngineConfig` validation +
serialization + back-compat shims, the three-way ``poll`` semantics
(pending, unknown, evicted), and the store's epoch-checked mask cache.
Engines run on ``device="cpu"`` (the plain search path).
"""

import argparse
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.engine import (
    DeadlineExceeded,
    EngineConfig,
    EngineDriver,
    FilterError,
    FlatConfig,
    ResultEvicted,
    RetrievalEngine,
    SearchRequest,
    UnknownRequest,
    backend_config,
    canonical_filter,
)
from repro_torch.engine.config import IVFConfig, QuantizedConfig


def cpu_engine(*args, **kw):
    """A ``RetrievalEngine`` on the CPU (the port's default device is CUDA)."""
    return RetrievalEngine(*args, device="cpu", **kw)


D = 24
RNG = np.random.default_rng(9)


def make_engine(**kw):
    kw.setdefault("d_start", 8)
    kw.setdefault("k0", 8)
    kw.setdefault("final_k", 4)
    kw.setdefault("buckets", (2,))
    kw.setdefault("capacity", 32)
    kw.setdefault("block_n", 32)
    eng = cpu_engine(D, **kw)
    db = RNG.normal(size=(20, D)).astype(np.float32)
    eng.add_docs(db)
    return eng, db


class TestCanonicalFilter:
    def test_none_and_empty_are_none(self):
        assert canonical_filter(None) is None
        assert canonical_filter({}) is None

    def test_shorthand_equals_explicit_eq(self):
        assert canonical_filter({"f": 3}) == canonical_filter(
            {"f": {"$eq": 3}})

    def test_order_insensitive(self):
        a = canonical_filter({"a": 1, "b": {"$gte": 2, "$lt": 9}})
        b = canonical_filter({"b": {"$lt": 9, "$gte": 2}, "a": 1})
        assert a == b and hash(a) == hash(b)

    def test_unknown_op_raises(self):
        with pytest.raises(FilterError, match=r"\$regex"):
            canonical_filter({"f": {"$regex": ".*"}})

    def test_non_scalar_value_raises(self):
        with pytest.raises(FilterError):
            canonical_filter({"f": {"$eq": [1, 2]}})

    def test_in_requires_sequence(self):
        with pytest.raises(FilterError):
            canonical_filter({"f": {"$in": 3}})


class TestSearchRequest:
    def test_raw_array_equals_search_request(self):
        eng, db = make_engine()
        r1 = eng.submit(db[5])
        r2 = eng.submit(SearchRequest(db[5]))
        eng.run_until_idle()
        a, b = eng.poll(r1), eng.poll(r2)
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.scores, b.scores)

    def test_per_request_k_slices_results(self):
        eng, db = make_engine()
        rid = eng.submit(SearchRequest(db[2], k=2))
        eng.run_until_idle()
        res = eng.poll(rid)
        assert res.doc_ids.shape == (2,) and res.scores.shape == (2,)
        assert res.doc_ids[0] == 2

    def test_k_out_of_range_rejected(self):
        eng, db = make_engine()                   # out_k == final_k == 4
        with pytest.raises(ValueError, match="k=9"):
            eng.submit(SearchRequest(db[0], k=9))
        with pytest.raises(ValueError, match="k"):
            eng.submit(SearchRequest(db[0], k=0))

    def test_mask_key_identity(self):
        r = SearchRequest(np.zeros(4), tenant="t",
                          filter={"a": 1, "b": {"$lt": 2}})
        same = SearchRequest(np.ones(4), tenant="t",
                             filter={"b": {"$lt": 2}, "a": {"$eq": 1}})
        assert r.mask_key() == same.mask_key()
        assert SearchRequest(np.zeros(4)).mask_key() is None

    def test_tenant_scoped_submit(self):
        eng, db = make_engine()
        extra = RNG.normal(size=(4, D)).astype(np.float32)
        ids = eng.add_docs(extra, tenant="mine")
        rid = eng.submit(SearchRequest(extra[0], tenant="mine"))
        eng.run_until_idle()
        res = eng.poll(rid)
        got = set(int(i) for i in res.doc_ids if i >= 0)
        assert got and got <= set(ids.tolist())

    def test_mixed_mask_keys_split_into_homogeneous_batches(self):
        """One step() never mixes constraint groups; every request still
        completes with its own constraint applied (FIFO, no starvation)."""
        eng, db = make_engine()
        a_ids = eng.add_docs(RNG.normal(size=(3, D)).astype(np.float32),
                             tenant="a")
        rids = [eng.submit(db[0]),
                eng.submit(SearchRequest(db[0], tenant="a")),
                eng.submit(db[1]),
                eng.submit(SearchRequest(db[1], tenant="a"))]
        eng.run_until_idle()
        plain0 = eng.poll(rids[0])
        scoped0 = eng.poll(rids[1])
        assert plain0.doc_ids[0] == 0
        assert set(int(i) for i in scoped0.doc_ids
                   if i >= 0) <= set(a_ids.tolist())
        assert eng.poll(rids[2]).doc_ids[0] == 1
        assert eng.stats.n_batches >= 2


class TestPollSemantics:
    def test_unknown_id_raises(self):
        eng, _ = make_engine()
        with pytest.raises(UnknownRequest):
            eng.poll(999)

    def test_pending_returns_none(self):
        eng, db = make_engine()
        rid = eng.submit(db[0])
        assert eng.poll(rid) is None              # queued, batch not run

    def test_double_poll_raises_evicted(self):
        eng, db = make_engine()
        rid = eng.submit(db[0])
        eng.run_until_idle()
        assert eng.poll(rid) is not None
        with pytest.raises(ResultEvicted):
            eng.poll(rid)

    def test_overflow_eviction_raises_evicted(self):
        eng, db = make_engine(max_unpolled=2)
        rids = [eng.submit(db[i]) for i in range(4)]
        eng.run_until_idle()
        with pytest.raises(ResultEvicted):
            eng.poll(rids[0])                     # oldest: evicted past cap
        assert eng.poll(rids[3]) is not None      # newest survives


class TestDriverRequests:
    def test_search_request_through_driver(self):
        eng, db = make_engine()
        ids = eng.add_docs(RNG.normal(size=(3, D)).astype(np.float32),
                           tenant="drv")
        with EngineDriver(eng, max_wait_ms=0.0) as driver:
            res = driver.retrieve(
                SearchRequest(db[0], k=1), timeout=30.0)
            assert res.doc_ids.shape == (1,) and res.doc_ids[0] == 0
            scoped = driver.retrieve(
                SearchRequest(db[0], tenant="drv"), timeout=30.0)
            got = set(int(i) for i in scoped.doc_ids if i >= 0)
            assert got and got <= set(ids.tolist())

    def test_expired_deadline_fails_future(self):
        eng, db = make_engine()
        with EngineDriver(eng, max_wait_ms=0.0) as driver:
            fut = driver.submit(SearchRequest(db[0], deadline_ms=1e-4))
            with pytest.raises(DeadlineExceeded):
                fut.result(30.0)
            assert driver.stats.n_expired == 1
            # the driver keeps serving after shedding
            assert driver.retrieve(db[0], timeout=30.0).doc_ids[0] == 0


class TestMaskCache:
    def test_cache_hit_until_epoch_bump(self):
        eng, _ = make_engine()
        eng.add_docs(RNG.normal(size=(2, D)).astype(np.float32), tenant="c")
        key = eng.store.compile_mask("c", None)
        m1 = eng.store.mask_for_key(key)
        assert eng.store.mask_for_key(key) is m1  # cached, same epoch
        eng.add_docs(RNG.normal(size=(1, D)).astype(np.float32), tenant="c")
        m2 = eng.store.mask_for_key(key)
        assert m2 is not m1                       # append invalidated it
        assert int(m2.sum()) == 3

    def test_mask_tracks_capacity_growth(self):
        eng, _ = make_engine(capacity=32)
        key = eng.store.compile_mask("g", None)
        assert eng.store.mask_for_key(key).shape == (32,)
        eng.add_docs(RNG.normal(size=(40, D)).astype(np.float32),
                     tenant="g")                  # forces buffer doubling
        mask = eng.store.mask_for_key(key)
        assert mask.shape == (eng.store.capacity,)
        assert int(mask.sum()) == 40

    def test_delete_does_not_invalidate(self):
        # tombstones are covered by the validity AND at dispatch; the mask
        # cache must NOT churn on every delete
        eng, _ = make_engine()
        ids = eng.add_docs(RNG.normal(size=(3, D)).astype(np.float32),
                           tenant="d")
        key = eng.store.compile_mask("d", None)
        m1 = eng.store.mask_for_key(key)
        eng.delete_docs(ids[:1])
        assert eng.store.mask_for_key(key) is m1


class TestEngineConfig:
    def test_round_trip(self):
        cfg = EngineConfig(
            d_emb=64, d_start=16, k0=16, final_k=4, buckets=(1, 4),
            capacity=128, backend=IVFConfig(n_lists=8, n_probe=4))
        again = EngineConfig.from_dict(cfg.to_dict())
        assert again == cfg

    def test_validation_eager(self):
        with pytest.raises(ValueError, match="d_start"):
            EngineConfig(d_emb=8, d_start=16)
        with pytest.raises(ValueError, match="buckets"):
            EngineConfig(d_emb=8, d_start=8, buckets=(4, 2))
        with pytest.raises(ValueError, match="metric"):
            EngineConfig(d_emb=8, d_start=8, metric="dot")
        with pytest.raises(ValueError, match="stage0_dtype"):
            IVFConfig(stage0_dtype="fp4")
        with pytest.raises(ValueError, match="codec"):
            QuantizedConfig(codec="gzip")

    def test_backend_config_rejects_unknowns(self):
        with pytest.raises(ValueError, match="unknown index backend"):
            backend_config("hnsw")
        with pytest.raises(ValueError, match="option"):
            backend_config("ivf", {"n_lists": 4, "bogus_knob": 1})

    def test_config_path_equals_legacy_path(self):
        cfg = EngineConfig(d_emb=D, d_start=8, k0=8, final_k=4,
                           buckets=(2,), capacity=32, block_n=32,
                           backend=FlatConfig())
        via_config = cpu_engine(config=cfg)
        via_legacy, _ = make_engine()
        assert via_config.config == via_legacy.config

    def test_legacy_backend_opts_still_work(self):
        eng = cpu_engine(D, d_start=8, k0=8, buckets=(2,), capacity=32,
                              backend="ivf",
                              backend_opts={"n_lists": 4, "n_probe": 2})
        assert isinstance(eng.config.backend, IVFConfig)
        assert eng.config.backend.n_lists == 4

    def test_legacy_bad_option_rejected_eagerly(self):
        with pytest.raises(ValueError, match="option"):
            cpu_engine(D, backend="ivf",
                            backend_opts={"n_listz": 4})

    def test_config_conflicts_rejected(self):
        cfg = EngineConfig(d_emb=D, d_start=8)
        with pytest.raises(ValueError, match="conflicts"):
            cpu_engine(config=cfg, k0=16)
        with pytest.raises(ValueError, match="conflicts"):
            cpu_engine(64, config=cfg)

    def test_from_flags(self):
        ap = argparse.ArgumentParser()
        EngineConfig.add_flags(ap)
        args = ap.parse_args(["--backend", "quantized", "--codec", "pq",
                              "--final-k", "4", "--buckets", "1,2"])
        cfg = EngineConfig.from_flags(args, d_emb=64, capacity=256)
        assert isinstance(cfg.backend, QuantizedConfig)
        assert cfg.backend.codec == "pq"
        assert cfg.final_k == 4 and cfg.buckets == (1, 2)
        assert cfg.capacity == 256

    def test_engine_reports_config(self):
        eng, _ = make_engine()
        d = eng.config.to_dict()
        assert d["d_emb"] == D and d["backend"]["backend"] == "flat"
        # frozen: the reported config can't be mutated out from under the
        # engine
        with pytest.raises(dataclasses.FrozenInstanceError):
            eng.config.d_emb = 1
