"""The port's core search functions against the JAX package's ``repro.core``.

The same seeded numpy inputs go through ``repro.core`` (XLA on the CPU) and
``repro_torch.core`` on ``device="cpu"`` (the plain versions).

Tolerance: scores ``rtol=1e-5, atol=1e-4`` — the float32 dot products are
summed in another order by XLA and by torch.  Ids are compared up to ties:
where two ids differ, their scores must agree within the tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)
import jax.numpy as jnp

from repro import core as J
from repro_torch import core as P

RTOL, ATOL = 1e-5, 1e-4


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


def _inputs(seed, nq=6, n=300, d=64, invalid_frac=0.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    db = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) >= invalid_frac
    return q, db, valid


class TestSchedule:
    @pytest.mark.parametrize("args", [(128, 3584, 64, 10), (8, 64, 16, 1),
                                      (16, 16, 8, 2), (4, 100, 32, 5)])
    def test_same_stages(self, args):
        d0, dm, k0, fk = args
        a = J.make_schedule(d0, dm, k0, final_k=fk)
        b = P.make_schedule(d0, dm, k0, final_k=fk)
        assert [(s.dim, s.k, s.pool) for s in a.stages] == \
            [(s.dim, s.k, s.pool) for s in b.stages]
        assert a.describe() == b.describe()


class TestIndex:
    def test_prefix_norms_match(self):
        _, db, valid = _inputs(0, n=257, d=40)
        dims = (4, 8, 33, 40)
        want = J.build_index(jnp.asarray(db), dims, valid=jnp.asarray(valid))
        got = P.build_index(db, dims, valid=valid, device="cpu")
        np.testing.assert_allclose(got["sq_prefix"].numpy(),
                                   np.asarray(want["sq_prefix"]),
                                   rtol=RTOL, atol=ATOL)
        assert got["dims"].tolist() == list(dims)
        assert got["valid"].numpy().tolist() == valid.tolist()
        np.testing.assert_allclose(
            P.prefix_norm_column(got, 33, dims).numpy(),
            np.asarray(J.prefix_norm_column(want, 33, dims)), rtol=RTOL,
            atol=ATOL)

    def test_bad_dims_rejected(self):
        _, db, _ = _inputs(1, n=10, d=8)
        for dims in ((8, 4), (0, 4), (4, 9)):
            with pytest.raises(ValueError):
                P.build_index(db, dims, device="cpu")
        with pytest.raises(KeyError):
            P.prefix_norm_column(P.build_index(db, (4,), device="cpu"), 8, (4,))


class TestTruncatedSearch:
    @pytest.mark.parametrize("n,block_n", [(300, 64), (257, 100), (64, 64)])
    @pytest.mark.parametrize("with_sq", [True, False])
    @pytest.mark.parametrize("with_valid", [True, False])
    def test_matches_jax(self, n, block_n, with_sq, with_valid):
        q, db, valid = _inputs(n + block_n, n=n, invalid_frac=0.2)
        dim, k = 24, 12
        sq = (db[:, :dim] ** 2).sum(1).astype(np.float32) if with_sq else None
        v = valid if with_valid else None
        want = J.truncated_search(
            jnp.asarray(q), jnp.asarray(db), dim=dim, k=k,
            db_sq_at_dim=None if sq is None else jnp.asarray(sq),
            valid=None if v is None else jnp.asarray(v), block_n=block_n)
        got = P.truncated_search(
            torch.from_numpy(q), torch.from_numpy(db), dim=dim, k=k,
            db_sq_at_dim=None if sq is None else torch.from_numpy(sq),
            valid=None if v is None else torch.from_numpy(v), block_n=block_n)
        assert_topk_close(got, want)
        if with_valid:
            ids = got[1].numpy()
            assert valid[ids[ids >= 0]].all()

    def test_all_invalid_corpus_gives_sentinels(self):
        q, db, _ = _inputs(2, n=150)
        valid = np.zeros(150, bool)
        want = J.truncated_search(jnp.asarray(q), jnp.asarray(db), dim=16, k=5,
                                  valid=jnp.asarray(valid), block_n=64)
        s, i = P.truncated_search(torch.from_numpy(q), torch.from_numpy(db),
                                  dim=16, k=5, valid=torch.from_numpy(valid),
                                  block_n=64)
        assert (i == -1).all() and torch.isposinf(s).all()
        assert_topk_close((s, i), want)

    def test_k_larger_than_corpus(self):
        q, db, valid = _inputs(3, n=20, invalid_frac=0.3)
        want = J.truncated_search(jnp.asarray(q), jnp.asarray(db), dim=16,
                                  k=32, valid=jnp.asarray(valid), block_n=16)
        got = P.truncated_search(torch.from_numpy(q), torch.from_numpy(db),
                                 dim=16, k=32, valid=torch.from_numpy(valid),
                                 block_n=16)
        assert_topk_close(got, want)
        assert (got[1][:, int(valid.sum()):] == -1).all()

    def test_cosine_on_cpu(self):
        q, db, valid = _inputs(4, n=200, invalid_frac=0.1)
        want = J.truncated_search(jnp.asarray(q), jnp.asarray(db), dim=32, k=8,
                                  valid=jnp.asarray(valid), block_n=64,
                                  metric="cosine")
        got = P.truncated_search(torch.from_numpy(q), torch.from_numpy(db),
                                 dim=32, k=8, valid=torch.from_numpy(valid),
                                 block_n=64, metric="cosine")
        assert_topk_close(got, want)

    def test_scores_match_jax(self):
        q, db, _ = _inputs(5, n=50, d=16)
        for fn_j, fn_p in ((J.l2_scores, P.l2_scores),
                           (J.cosine_scores, P.cosine_scores)):
            np.testing.assert_allclose(
                fn_p(torch.from_numpy(q), torch.from_numpy(db)).numpy(),
                np.asarray(fn_j(jnp.asarray(q), jnp.asarray(db))),
                rtol=RTOL, atol=ATOL)

    def test_unknown_metric(self):
        q, db, _ = _inputs(6, n=10, d=8)
        with pytest.raises(ValueError):
            P.truncated_search(torch.from_numpy(q), torch.from_numpy(db),
                               dim=4, k=2, metric="dot")


class TestRescoreCandidates:
    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    @pytest.mark.parametrize("with_sq", [True, False])
    def test_matches_jax(self, metric, with_sq):
        q, db, valid = _inputs(7, n=120, invalid_frac=0.15)
        rng = np.random.default_rng(8)
        cand = np.stack([rng.permutation(120)[:24] for _ in range(6)]).astype(np.int32)
        cand[:, -3:] = -1
        dim, k = 48, 10
        sq = (db[:, :dim] ** 2).sum(1).astype(np.float32) if with_sq else None
        want = J.rescore_candidates(
            jnp.asarray(q), jnp.asarray(db), jnp.asarray(cand), dim=dim, k=k,
            db_sq_at_dim=None if sq is None else jnp.asarray(sq),
            valid=jnp.asarray(valid), metric=metric)
        got = P.rescore_candidates(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(cand),
            dim=dim, k=k, db_sq_at_dim=None if sq is None else torch.from_numpy(sq),
            valid=torch.from_numpy(valid), metric=metric)
        assert_topk_close(got, want)

    def test_only_invalid_candidates_give_minus_one(self):
        q, db, _ = _inputs(9, n=40)
        cand = np.tile(np.arange(8, dtype=np.int32), (6, 1))
        valid = np.ones(40, bool)
        valid[:8] = False
        s, i = P.rescore_candidates(torch.from_numpy(q), torch.from_numpy(db),
                                    torch.from_numpy(cand), dim=16, k=4,
                                    valid=torch.from_numpy(valid))
        assert (i == -1).all() and torch.isposinf(s).all()

    def test_inject_candidates(self):
        cand = np.arange(6, dtype=np.int32).reshape(2, 3)
        extra = np.array([10, -1], np.int32)
        want = np.asarray(J.inject_candidates(jnp.asarray(cand), jnp.asarray(extra)))
        got = P.inject_candidates(torch.from_numpy(cand), torch.from_numpy(extra))
        assert got.numpy().tolist() == want.tolist()
        assert P.inject_candidates(torch.from_numpy(cand), None) is not None


class TestProgressiveSearch:
    @pytest.mark.parametrize("sched_args", [(8, 64, 32, 4), (16, 64, 16, 1),
                                            (64, 64, 8, 8)])
    @pytest.mark.parametrize("with_prefix", [True, False])
    @pytest.mark.parametrize("with_valid", [True, False])
    def test_matches_jax(self, sched_args, with_prefix, with_valid):
        q, db, valid = _inputs(sum(sched_args), n=400, invalid_frac=0.1)
        d0, dm, k0, fk = sched_args
        sj = J.make_schedule(d0, dm, k0, final_k=fk)
        sp = P.make_schedule(d0, dm, k0, final_k=fk)
        dims = J.stage_dims(sj)
        kw_j, kw_p = {}, {}
        if with_prefix:
            kw_j = dict(sq_prefix=J.build_index(jnp.asarray(db), dims)["sq_prefix"],
                        index_dims=dims)
            kw_p = dict(sq_prefix=P.build_index(db, dims, device="cpu")["sq_prefix"],
                        index_dims=dims)
        if with_valid:
            kw_j["valid"] = jnp.asarray(valid)
            kw_p["valid"] = torch.from_numpy(valid)
        want = J.progressive_search(jnp.asarray(q), jnp.asarray(db), sj,
                                    block_n=128, **kw_j)
        got = P.progressive_search(torch.from_numpy(q), torch.from_numpy(db),
                                   sp, block_n=128, **kw_p)
        assert_topk_close(got, want)
        plain = P.progressive_search_plain(torch.from_numpy(q),
                                           torch.from_numpy(db), sp,
                                           block_n=128, **kw_p)
        assert torch.equal(plain[1], got[1])

    def test_stage0_only_then_ladder(self):
        q, db, valid = _inputs(10, n=256)
        sp = P.make_schedule(8, 64, 16, final_k=2)
        qt, dbt, vt = torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(valid)
        s0, c0 = P.progressive_search(qt, dbt, sp, valid=vt, stage0_only=True)
        assert c0.shape == (6, 16)
        s, i = P.rescore_ladder(qt, dbt, c0, sp.stages[1:], valid=vt, scores=s0)
        full = P.progressive_search(qt, dbt, sp, valid=vt)
        assert torch.equal(i, full[1]) and torch.equal(s, full[0])

    def test_all_invalid_corpus(self):
        q, db, _ = _inputs(11, n=100)
        sp = P.make_schedule(8, 64, 16, final_k=3)
        s, i = P.progressive_search(torch.from_numpy(q), torch.from_numpy(db),
                                    sp, valid=torch.zeros(100, dtype=torch.bool))
        assert (i == -1).all() and torch.isposinf(s).all()


class TestMetrics:
    def test_match_jax(self):
        rng = np.random.default_rng(12)
        a = rng.integers(0, 20, size=(30, 5)).astype(np.int32)
        b = rng.integers(0, 20, size=(30, 5)).astype(np.int32)
        gt = rng.integers(0, 20, size=30).astype(np.int32)
        for name in ("top1_accuracy",):
            assert float(getattr(P, name)(torch.from_numpy(a), torch.from_numpy(gt))) == \
                pytest.approx(float(getattr(J, name)(jnp.asarray(a), jnp.asarray(gt))))
        assert float(P.recall_at_k(torch.from_numpy(a), torch.from_numpy(gt), 3)) == \
            pytest.approx(float(J.recall_at_k(jnp.asarray(a), jnp.asarray(gt), 3)))
        assert float(P.overlap_at_k(torch.from_numpy(a), torch.from_numpy(b), 4)) == \
            pytest.approx(float(J.overlap_at_k(jnp.asarray(a), jnp.asarray(b), 4)))
