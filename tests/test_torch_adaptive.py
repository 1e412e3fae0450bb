"""The port's adaptive degradation policy and query-result cache, mirrored
from the JAX package's ``tests/test_adaptive.py`` and held against it.

Covers: the AdaptivePolicy control loop on a fake clock, QueryCache
semantics (exact/near hits, LRU, structural invalidation), per-dispatch
SearchOverrides through every backend variant, the bit-for-bit guarantee
that an adaptive-enabled engine at level 0 matches the static path, the
driver integration (cache in front of the queue, level-keyed entries); the
policy and the cache against the JAX package's on the same seeded
operation sequences (equal levels, hits, ids and counters); and the
deterministic twin of ``tests/test_adaptive_properties.py``: a cached
result is never served across a ``store_generation`` / ``mask_epoch`` /
rebuild bump, for every backend variant.  Engines run on ``device="cpu"``
(the plain search path).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.engine import AdaptivePolicy as JAdaptivePolicy
from repro.engine import QueryCache as JQueryCache
from repro.engine.config import AdaptiveConfig as JAdaptiveConfig
from repro_torch.engine import (
    AdaptiveConfig,
    AdaptivePolicy,
    CacheConfig,
    EngineDriver,
    QueryCache,
    RetrievalEngine,
    SearchRequest,
)
from repro_torch.engine.adaptive import SearchOverrides

RNG = np.random.default_rng(23)
D = 32
BACKENDS = ("flat", "ivf", "quantized", "ivf_kernel", "ivf_pq",
            "quantized_pq")


def opts_for(backend, **extra):
    base = {
        "flat": {},
        "ivf": dict(n_lists=12, n_probe=6, min_index_rows=32,
                    min_rebuild_rows=16),
        "ivf_kernel": dict(n_lists=12, n_probe=6, min_index_rows=32,
                           min_rebuild_rows=16, use_kernel=True,
                           kernel_block_m=16),
        "ivf_pq": dict(n_lists=12, n_probe=6, min_index_rows=32,
                       min_rebuild_rows=16, use_kernel=True,
                       kernel_block_m=16, stage0_dtype="pq"),
        "quantized": dict(min_rebuild_rows=16),
        "quantized_pq": dict(min_rebuild_rows=16, codec="pq"),
    }[backend]
    return {**base, **extra} or None


def engine_backend(backend):
    if backend.startswith("ivf"):
        return "ivf"
    if backend.startswith("quantized"):
        return "quantized"
    return backend


def make_engine(backend, n_docs=96, seed=7, **kw):
    opts = kw.pop("backend_opts", opts_for(backend))
    kw.setdefault("d_start", 8)
    kw.setdefault("k0", 16)
    kw.setdefault("buckets", (4,))
    kw.setdefault("capacity", 64)
    kw.setdefault("block_n", 64)
    eng = RetrievalEngine(D, backend=engine_backend(backend),
                          backend_opts=opts, device="cpu", **kw)
    db = np.random.default_rng(seed).normal(
        size=(n_docs, D)).astype(np.float32)
    eng.add_docs(db)
    return eng, db


ADAPTIVE = AdaptiveConfig(enabled=True, levels=2, min_d_start=4)


# ---------------------------------------------------------------------------
# AdaptivePolicy control loop (pure, fake clock)
# ---------------------------------------------------------------------------

def _policy(**kw):
    kw.setdefault("enabled", True)
    kw.setdefault("levels", 3)
    kw.setdefault("depth_high", 10)
    kw.setdefault("wait_high_ms", 50.0)
    kw.setdefault("escalate_factor", 2.0)
    kw.setdefault("recover_frac", 0.5)
    kw.setdefault("hysteresis_s", 1.0)
    return AdaptivePolicy(AdaptiveConfig(**kw))


class TestAdaptivePolicy:
    def test_target_level_depth_ladder(self):
        p = _policy()
        assert p.target_level(0, None) == 0
        assert p.target_level(9, None) == 0
        assert p.target_level(10, None) == 1
        assert p.target_level(20, None) == 2
        assert p.target_level(40, None) == 3
        assert p.target_level(10_000, None) == 3  # clamped at cfg.levels

    def test_wait_signal_alone_escalates(self):
        p = _policy()
        assert p.target_level(0, 49.0) == 0
        assert p.target_level(0, 50.0) == 1
        assert p.target_level(0, 100.0) == 2
        assert p.update(0, 60.0, now=0.0) == 1
        assert p.n_escalations == 1

    def test_depth_only_config_ignores_wait(self):
        p = _policy(wait_high_ms=None)
        assert p.target_level(0, 10_000.0) == 0

    def test_escalation_is_immediate_and_multi_level(self):
        p = _policy()
        assert p.update(40, None, now=0.0) == 3
        assert p.n_escalations == 3
        assert p.n_recoveries == 0

    def test_recovery_needs_continuous_dwell(self):
        p = _policy()
        p.update(40, None, now=0.0)
        # calm (depth < 0.5 * entry_depth(3)=20) starts the timer...
        assert p.update(5, None, now=1.0) == 3
        # ...but pressure resets it (30 >= 20 is not calm at level 3)
        assert p.update(30, None, now=1.5) == 3
        assert p.update(5, None, now=2.0) == 3
        assert p.update(5, None, now=2.9) == 3   # dwell 0.9 < 1.0
        assert p.update(5, None, now=3.0) == 2   # one level, not to 0
        assert p.n_recoveries == 1
        # each further step needs its own full dwell (timer resets on
        # every downward step: recovering from level N takes N dwells)
        assert p.update(0, None, now=3.5) == 2
        assert p.update(0, None, now=4.5) == 1
        assert p.update(0, None, now=5.0) == 1   # new dwell only started
        assert p.update(0, None, now=6.0) == 0
        assert p.n_recoveries == 3
        # at level 0 nothing to recover
        assert p.update(0, None, now=9.0) == 0

    def test_wait_pressure_blocks_recovery(self):
        p = _policy()
        p.update(20, None, now=0.0)
        assert p.level == 2
        # depth calm but wait p95 still above recover_frac * entry wait
        p.update(0, 90.0, now=1.0)
        p.update(0, 90.0, now=5.0)
        assert p.level == 2

    def test_summary_and_publish_use_plain_ints(self):
        from repro_torch.obs import MetricsRegistry, parse_prometheus
        p = _policy()
        reg = MetricsRegistry()
        p.bind(reg)
        p.update(20, None, now=0.0)
        p.update(0, None, now=1.0)
        p.update(0, None, now=2.5)
        s = p.summary()
        assert s["level"] == 1 and s["n_escalations"] == 2
        assert s["n_recoveries"] == 1
        p.publish()
        m = parse_prometheus(reg.render_prometheus())
        assert m["repro_adaptive_transitions_total"][(("direction", "up"),)] == 2
        assert m["repro_adaptive_transitions_total"][(("direction", "down"),)] == 1
        assert m["repro_adaptive_level"][()] == 1


# ---------------------------------------------------------------------------
# QueryCache unit semantics
# ---------------------------------------------------------------------------

S0 = (1, 1, 0)


class TestQueryCache:
    def _q(self, seed=0):
        return np.random.default_rng(seed).normal(size=D).astype(np.float32)

    def test_exact_hit_round_trip(self):
        c = QueryCache(D, capacity=4)
        q = self._q()
        assert c.lookup(q, 3, None, 0, S0) is None
        c.insert(q, np.arange(3, dtype=np.float32), np.array([7, 8, 9]),
                 None, 0, S0)
        s, i, kind = c.lookup(q, 3, None, 0, S0)
        assert kind == "exact"
        np.testing.assert_array_equal(i, [7, 8, 9])
        np.testing.assert_array_equal(s, [0.0, 1.0, 2.0])
        assert c.hits_exact == 1 and c.misses == 1

    def test_wider_k_request_misses_narrow_entry(self):
        c = QueryCache(D, capacity=4)
        q = self._q()
        c.insert(q, np.zeros(5, np.float32), np.arange(5), None, 0, S0)
        assert c.lookup(q, 8, None, 0, S0) is None          # entry.k=5 < 8
        s, i, _ = c.lookup(q, 2, None, 0, S0)               # slice down fine
        assert i.shape == (2,)

    def test_mask_and_level_keys_never_alias(self):
        c = QueryCache(D, capacity=4)
        q = self._q()
        c.insert(q, np.zeros(1, np.float32), np.array([3]), None, 0, S0)
        assert c.lookup(q, 1, ("tenant", "t1"), 0, S0) is None
        assert c.lookup(q, 1, None, 1, S0) is None
        assert c.lookup(q, 1, None, 0, S0) is not None

    def test_stamp_change_flushes_everything(self):
        c = QueryCache(D, capacity=4)
        c.insert(self._q(0), np.zeros(1, np.float32), np.array([1]),
                 None, 0, S0)
        c.insert(self._q(1), np.zeros(1, np.float32), np.array([2]),
                 None, 0, S0)
        # any component moving (generation / mask_epoch / rebuilds) flushes
        assert c.lookup(self._q(0), 1, None, 0, (2, 1, 0)) is None
        assert c.lookup(self._q(1), 1, None, 0, (2, 1, 0)) is None
        assert c.invalidations == 1
        assert c.summary()["size"] == 0

    def test_lru_eviction_and_slot_reuse(self):
        c = QueryCache(D, capacity=2)
        q0, q1, q2 = self._q(0), self._q(1), self._q(2)
        one = np.zeros(1, np.float32)
        c.insert(q0, one, np.array([0]), None, 0, S0)
        c.insert(q1, one, np.array([1]), None, 0, S0)
        c.lookup(q0, 1, None, 0, S0)            # refresh q0
        c.insert(q2, one, np.array([2]), None, 0, S0)   # evicts q1 (LRU)
        assert c.lookup(q1, 1, None, 0, S0) is None
        assert c.lookup(q0, 1, None, 0, S0) is not None
        assert c.lookup(q2, 1, None, 0, S0) is not None
        assert c.summary()["size"] == 2
        # updating an existing key reuses its slot, no capacity leak
        c.insert(q2, one, np.array([9]), None, 0, S0)
        assert c.summary()["size"] == 2
        _, i, _ = c.lookup(q2, 1, None, 0, S0)
        assert i[0] == 9

    def test_near_duplicate_hit_within_eps(self):
        c = QueryCache(D, capacity=4, near_eps=1e-2)
        q = self._q()
        c.insert(q, np.zeros(1, np.float32), np.array([5]), None, 0, S0)
        near = q.copy()
        near[0] += 1e-3                          # d^2 = 1e-6 < 1e-2
        s, i, kind = c.lookup(near, 1, None, 0, S0)
        assert kind == "near" and i[0] == 5
        far = q + 1.0
        assert c.lookup(far, 1, None, 0, S0) is None
        assert c.hits_near == 1

    def test_near_scan_respects_mask_and_level(self):
        c = QueryCache(D, capacity=4, near_eps=1e-2)
        q = self._q()
        c.insert(q, np.zeros(1, np.float32), np.array([5]),
                 ("tenant", "a"), 1, S0)
        near = q.copy()
        near[0] += 1e-3
        assert c.lookup(near, 1, None, 1, S0) is None
        assert c.lookup(near, 1, ("tenant", "a"), 0, S0) is None
        assert c.lookup(near, 1, ("tenant", "a"), 1, S0) is not None

    def test_capacity_validated(self):
        with pytest.raises(ValueError):
            QueryCache(D, capacity=0)


# ---------------------------------------------------------------------------
# Config plumbing
# ---------------------------------------------------------------------------

class TestConfig:
    def test_validation(self):
        with pytest.raises(ValueError):
            AdaptiveConfig(levels=0)
        with pytest.raises(ValueError):
            AdaptiveConfig(recover_frac=0.0)
        with pytest.raises(ValueError):
            AdaptiveConfig(n_probe_scale=1.5)
        with pytest.raises(ValueError):
            CacheConfig(capacity=0)
        with pytest.raises(ValueError):
            CacheConfig(near_eps=-1.0)

    def test_from_dict_rejects_unknown_fields(self):
        with pytest.raises(ValueError):
            AdaptiveConfig.from_dict({"enabled": True, "bogus": 1})
        with pytest.raises(ValueError):
            CacheConfig.from_dict({"capcity": 8})

    def test_engine_config_round_trip(self):
        from repro_torch.engine import EngineConfig
        cfg = EngineConfig(
            d_emb=D,
            adaptive=AdaptiveConfig(enabled=True, levels=3, depth_high=7),
            cache=CacheConfig(enabled=True, capacity=16, near_eps=0.5),
        )
        back = EngineConfig.from_dict(cfg.to_dict())
        assert back.adaptive == cfg.adaptive
        assert back.cache == cfg.cache

    def test_cli_flags(self):
        import argparse
        from repro_torch.engine import EngineConfig
        ap = argparse.ArgumentParser()
        EngineConfig.add_flags(ap)
        args = ap.parse_args([
            "--adaptive", "--adaptive-levels", "3",
            "--adaptive-depth-high", "9", "--adaptive-wait-high-ms", "0",
            "--qcache", "--qcache-capacity", "64", "--qcache-near-eps",
            "0.25",
        ])
        cfg = EngineConfig.from_flags(args, d_emb=D)
        assert cfg.adaptive.enabled and cfg.adaptive.levels == 3
        assert cfg.adaptive.depth_high == 9
        assert cfg.adaptive.wait_high_ms is None     # 0 => depth-only
        assert cfg.cache.enabled and cfg.cache.capacity == 64
        assert cfg.cache.near_eps == 0.25


# ---------------------------------------------------------------------------
# Per-dispatch overrides through every backend variant
# ---------------------------------------------------------------------------

class TestOverridesDispatch:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_levels_dispatch_and_stamp(self, backend):
        eng, db = make_engine(backend, adaptive=ADAPTIVE)
        n = db.shape[0]
        qs = RNG.normal(size=(3, D)).astype(np.float32)
        for lvl in (0, 1, 2, 5):
            ov = eng.overrides_for_level(lvl)
            if lvl == 0:
                assert ov is None
            else:
                assert isinstance(ov, SearchOverrides)
                assert ov.level == min(lvl, ADAPTIVE.levels)
            reqs = [eng.check_request(SearchRequest(q)) for q in qs]
            for r in eng.execute_batch(reqs, overrides=ov):
                assert r.degraded_level == (0 if ov is None else ov.level)
                assert r.doc_ids.shape == (1,)
                assert 0 <= int(r.doc_ids[0]) < n
        gen, epoch, rebuilds = eng.cache_stamp()
        assert gen >= 1 and epoch >= 1 and rebuilds >= 0

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_level_zero_bit_for_bit_vs_static(self, backend):
        """Acceptance (c) in miniature: adaptive wiring enabled but idle
        must reproduce the static engine's top-k ids exactly."""
        static, _ = make_engine(backend)
        adaptive, _ = make_engine(backend, adaptive=ADAPTIVE)
        qs = RNG.normal(size=(8, D)).astype(np.float32)
        s_a, i_a = static.search(qs)
        s_b, i_b = adaptive.search(qs)
        np.testing.assert_array_equal(i_a, i_b)
        np.testing.assert_array_equal(s_a, s_b)

    def test_degraded_schedule_enters_lower_and_dims_superset(self):
        eng, _ = make_engine("flat", adaptive=ADAPTIVE)
        ov1, ov2 = eng.overrides_for_level(1), eng.overrides_for_level(2)
        assert ov1.sched is not None and ov1.sched.d_start < eng.sched.d_start
        assert ov2.sched.d_start <= ov1.sched.d_start
        assert ov1.sched.d_start >= ADAPTIVE.min_d_start
        # final width untouched; degraded stage dims precomputed everywhere
        assert ov1.sched.final_k == eng.sched.final_k
        assert set(eng.dims) >= {ov1.sched.d_start, ov2.sched.d_start}
        assert eng.backend.dims == eng.dims
        assert eng.store.dims == eng.dims

    def test_degraded_levels_not_slower_shapes(self):
        # n_probe / oversample fractions shrink monotonically with level
        eng, _ = make_engine("ivf", adaptive=ADAPTIVE)
        ov1, ov2 = eng.overrides_for_level(1), eng.overrides_for_level(2)
        assert 0 < ov2.n_probe_frac < ov1.n_probe_frac <= 1.0
        assert 0 < ov2.oversample_frac < ov1.oversample_frac <= 1.0


# ---------------------------------------------------------------------------
# Driver integration: cache in front of the queue, level-keyed entries
# ---------------------------------------------------------------------------

class TestDriverIntegration:
    def test_cache_hit_skips_queue_and_mutation_invalidates(self):
        eng, _ = make_engine("flat", cache=CacheConfig(enabled=True,
                                                       capacity=16))
        q = RNG.normal(size=D).astype(np.float32)
        with EngineDriver(eng, max_wait_ms=0.0) as drv:
            r1 = drv.retrieve(q, timeout=30)
            assert not r1.cached
            r2 = drv.retrieve(q, timeout=30)
            assert r2.cached
            np.testing.assert_array_equal(r1.doc_ids, r2.doc_ids)
            np.testing.assert_array_equal(r1.scores, r2.scores)
            assert r2.store_generation == r1.store_generation
            # cache hits never ride the queue counters
            assert drv.stats.n_submitted == 1
            eng.add_docs(RNG.normal(size=(2, D)).astype(np.float32))
            r3 = drv.retrieve(q, timeout=30)
            assert not r3.cached
            assert r3.store_generation > r1.store_generation
            s = drv.cache.summary()
            assert s["hits_exact"] == 1 and s["invalidations"] == 1

    def test_cache_entries_are_level_keyed(self):
        eng, _ = make_engine("ivf", adaptive=ADAPTIVE,
                             cache=CacheConfig(enabled=True, capacity=16))
        q = RNG.normal(size=D).astype(np.float32)
        with EngineDriver(eng, max_wait_ms=0.0) as drv:
            assert drv.adaptive is not None and drv.cache is not None
            r1 = drv.retrieve(q, timeout=30)
            assert not r1.cached and r1.degraded_level == 0
            # force a degraded level the way the control loop would
            drv.adaptive.level = 1
            r2 = drv.retrieve(q, timeout=30)
            assert not r2.cached           # level 1 is a different key
            assert r2.degraded_level == 1
            r3 = drv.retrieve(q, timeout=30)
            assert r3.cached and r3.degraded_level == 1
            drv.adaptive.level = 0
            r4 = drv.retrieve(q, timeout=30)
            assert r4.cached and r4.degraded_level == 0
            np.testing.assert_array_equal(r4.doc_ids, r1.doc_ids)

    def test_disabled_sections_leave_driver_untouched(self):
        eng, _ = make_engine("flat")
        with EngineDriver(eng, max_wait_ms=0.0) as drv:
            assert drv.adaptive is None and drv.cache is None
            r = drv.retrieve(RNG.normal(size=D).astype(np.float32),
                             timeout=30)
            assert not r.cached and r.degraded_level == 0


# ---------------------------------------------------------------------------
# Parity with the JAX package on the same operation sequences
# ---------------------------------------------------------------------------

class TestParityWithReference:
    POLICY = dict(enabled=True, levels=3, depth_high=10, wait_high_ms=50.0,
                  escalate_factor=2.0, recover_frac=0.5, hysteresis_s=1.0)

    @pytest.mark.parametrize("seed", range(3))
    def test_policy_levels_equal(self, seed):
        rng = np.random.default_rng(seed)
        port = AdaptivePolicy(AdaptiveConfig(**self.POLICY))
        ref = JAdaptivePolicy(JAdaptiveConfig(**self.POLICY))
        now = 0.0
        for _ in range(400):
            depth = int(rng.integers(0, 50))
            wait = None if rng.random() < 0.3 else float(rng.uniform(0, 150))
            now += float(rng.uniform(0.0, 0.6))
            assert port.update(depth, wait, now=now) == \
                ref.update(depth, wait, now=now)
        assert port.summary() == ref.summary()

    @pytest.mark.parametrize("seed", range(3))
    def test_query_cache_serves_equal(self, seed):
        """Inserts and lookups over a small pool of queries (near copies,
        two mask keys, two levels, stamps that move): every lookup gives
        the same kind, ids and scores in both, and the counters agree."""
        rng = np.random.default_rng(100 + seed)
        pool = rng.normal(size=(6, D)).astype(np.float32)
        port = QueryCache(D, capacity=4, near_eps=1e-2)
        ref = JQueryCache(D, capacity=4, near_eps=1e-2)
        stamp = [1, 1, 0]
        for _ in range(300):
            q = pool[rng.integers(0, len(pool))].copy()
            if rng.random() < 0.3:
                q[0] += 1e-3                      # a near duplicate
            mask = (None, ("tenant", "a"))[int(rng.integers(0, 2))]
            level = int(rng.integers(0, 2))
            if rng.random() < 0.05:
                stamp[int(rng.integers(0, 3))] += 1
            k = int(rng.integers(1, 5))
            if rng.random() < 0.4:
                s = rng.normal(size=k).astype(np.float32)
                ids = rng.integers(0, 1000, size=k)
                for c in (port, ref):
                    c.insert(q, s, ids, mask, level, tuple(stamp))
                continue
            a = port.lookup(q, k, mask, level, tuple(stamp))
            b = ref.lookup(q, k, mask, level, tuple(stamp))
            assert (a is None) == (b is None)
            if a is not None:
                assert a[2] == b[2]
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[0], b[0])
        assert port.summary() == ref.summary()


# ---------------------------------------------------------------------------
# A cached serve never outlives a stamp bump (every backend variant)
# ---------------------------------------------------------------------------

class TestCacheNeverStale:
    """The deterministic twin of the JAX package's hypothesis property.

    Seeded add / delete / hot / fresh sequences drive the engine's own
    lifecycle (tombstone compaction, index rebuilds), so every stamp
    component moves.  The invariant: a retrieve served with
    ``cached=True`` implies the stamp has not moved since that entry was
    inserted, and returns the ids the inserting serve returned.  One
    driver serves all of a variant's sequences, and the record of the last
    uncached hot serve carries over from one sequence to the next with it:
    an entry inserted in an earlier sequence may rightly be served in a
    later one.
    """

    HOT = np.random.default_rng(99).normal(size=D).astype(np.float32)
    OPS = ("add", "delete", "hot", "hot", "fresh")

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_mutations_always_invalidate(self, backend):
        rng = np.random.default_rng(sum(map(ord, backend)))
        eng, _ = make_engine(backend, n_docs=48,
                             cache=CacheConfig(enabled=True, capacity=32))
        last_ids = None        # ids of the last uncached hot serve
        last_stamp = None      # the stamp right after that serve
        n_cached = n_moved = 0
        with EngineDriver(eng, max_wait_ms=0.0) as drv:
            for _ in range(8):                    # sequences
                n_ops = int(rng.integers(3, 11))
                for op in rng.choice(self.OPS, size=n_ops):
                    if op == "add":
                        eng.add_docs(rng.normal(size=(2, D))
                                     .astype(np.float32))
                    elif op == "delete":
                        _, ids = eng.search(self.HOT[None, :], k=1)
                        eng.delete_docs([int(ids[0, 0])])
                    elif op == "fresh":
                        drv.retrieve(rng.normal(size=D).astype(np.float32),
                                     timeout=60)
                    else:
                        stamp_before = eng.cache_stamp()
                        r = drv.retrieve(self.HOT, timeout=60)
                        if r.cached:
                            n_cached += 1
                            assert last_stamp is not None, \
                                "cached serve with no uncached serve before it"
                            assert stamp_before == last_stamp, \
                                "cached result served across a stamp bump"
                            np.testing.assert_array_equal(r.doc_ids, last_ids)
                            assert r.store_generation == eng.store.generation
                        else:
                            n_moved += last_stamp is not None \
                                and stamp_before != last_stamp
                            last_ids = r.doc_ids
                            last_stamp = eng.cache_stamp()
        # the sequences exercised both sides of the invariant
        assert n_cached > 0 and n_moved > 0
