"""The paper's own pieces in the port against the JAX package, on the CPU:
the synthetic corpora, the paper's config, ``index_for_schedule``, the
pooled progressive search, PCA, the stage-0 function at k = 512 and 1024,
and ``launch/paper_tables.py``.

The same seeded numpy inputs go through both packages.  Tolerances: the
corpora are equal bit for bit (``np.array_equal``: the same numpy draws in
the same order); prefix norms within 1e-5 relative and pooled scores within
1e-4 (float32 sums in another order); ids equal up to near-ties, sentinels
identical; PCA variances within 1e-4 relative and components up to sign
(subspaces for the power iteration) within 1e-4.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.configs import paper_rag as jcfg
from repro.core import index as jindex
from repro.core import make_schedule as jmake_schedule
from repro.core import pca as jpca
from repro.core import progressive as jprog
from repro.core import truncated as jtrunc
from repro.core.metrics import top1_accuracy as jtop1
from repro.kernels.distance_topk import l2_topk as pallas_l2_topk
from repro.rag import corpus as jcorpus

from repro_torch.configs import paper_rag as tcfg
from repro_torch.core import (index_for_schedule, make_schedule,
                              progressive_search_pooled,
                              progressive_search_pooled_plain, stage_dims)
from repro_torch.core import pca as tpca
from repro_torch.core.progressive import pool_of
from repro_torch.kernels import distance_topk
from repro_torch.launch import paper_tables
from repro_torch.rag import corpus as tcorpus

FIELDS = ("db", "queries", "ground_truth", "scales")


def assert_topk_close(got, want, rtol=1e-5, atol=1e-4):
    """Scores close, sentinels identical, ids equal up to near-ties."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    np.testing.assert_array_equal(gi == -1, wi == -1)
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=rtol, atol=atol)
    differ = gi != wi
    assert np.allclose(gs[differ], ws[differ], rtol=rtol, atol=atol), \
        "ids differ where scores are not tied"


class TestCorpus:
    @pytest.mark.parametrize("n,d,q,seed", [(2000, 64, 50, 0),
                                            (5001, 100, 77, 3)])
    def test_make_corpus_equal(self, n, d, q, seed):
        want = jcorpus.make_corpus(n, d, q, seed=seed)
        got = tcorpus.make_corpus(n, d, q, seed=seed)
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f

    @pytest.mark.parametrize("n,d,q,seed", [(1500, 32, 40, 1),
                                            (4000, 72, 64, 9)])
    def test_make_clustered_corpus_equal(self, n, d, q, seed):
        want = jcorpus.make_clustered_corpus(n, d, q, seed=seed)
        got = tcorpus.make_clustered_corpus(n, d, q, seed=seed)
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f

    def test_to_device_copies_in_blocks(self, monkeypatch):
        monkeypatch.setattr(tcorpus, "_COPY_ROWS", 7)
        c = tcorpus.make_corpus(100, 16, 5, seed=2)
        t = tcorpus.to_device(c, "cpu")
        for f in FIELDS:
            assert isinstance(getattr(t, f), torch.Tensor)
            assert np.array_equal(getattr(t, f).numpy(), getattr(c, f)), f
        assert t.ground_truth.dtype == torch.int64


def test_paper_config_fields_equal():
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(tcfg, name)) == \
            dataclasses.asdict(getattr(jcfg, name))
    assert [f.name for f in dataclasses.fields(tcfg.PaperRAGConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.PaperRAGConfig)]


@pytest.mark.parametrize("ds,dm,k0", [(16, 128, 32), (8, 100, 4)])
def test_index_for_schedule(ds, dm, k0):
    db = np.random.default_rng(ds).normal(size=(300, 128)).astype(np.float32)
    db[:, :dm] *= 3.0
    got = index_for_schedule(db, make_schedule(ds, dm, k0))
    want = jindex.index_for_schedule(jnp.asarray(db),
                                     jmake_schedule(ds, dm, k0))
    np.testing.assert_array_equal(got["dims"].numpy(),
                                  np.asarray(want["dims"]))
    np.testing.assert_allclose(got["sq_prefix"].numpy(),
                               np.asarray(want["sq_prefix"]), rtol=1e-5)
    assert got["valid"].all()


class TestPooled:
    @pytest.mark.parametrize("flat,bound", [
        ([5, 3, 5, -1, 9, 3], 8),      # a -1 sorts first; padding at the end
        ([5, 3, 5, 1, 9, 3], 3),       # truncated to bound
        ([2, 2, 2, 2], 4),
    ])
    def test_pool_of_is_jnp_unique(self, flat, bound):
        cand = np.asarray(flat, np.int32).reshape(-1, 2)
        got = pool_of(torch.from_numpy(cand), bound)
        want = jnp.unique(jnp.asarray(cand).reshape(-1), size=bound,
                          fill_value=-1)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("n,live,sched_args", [
        (400, 0.6, (8, 64, 16, 2)),
        # fewer live rows than k0: stage 0 holds -1, pools hold padding
        (80, 0.15, (8, 64, 32, 3)),
        (300, 0.9, (16, 16, 8, 4)),    # single stage: the per-query rescore
    ])
    @pytest.mark.parametrize("with_norms", [True, False])
    def test_matches_reference(self, n, live, sched_args, with_norms):
        ds, dm, k0, final_k = sched_args
        rng = np.random.default_rng(n + ds)
        db = rng.normal(size=(n, 64)).astype(np.float32)
        q = rng.normal(size=(7, 64)).astype(np.float32)
        valid = rng.random(n) < live
        tsched = make_schedule(ds, dm, k0, final_k=final_k)
        jsched = jmake_schedule(ds, dm, k0, final_k=final_k)
        dims = stage_dims(tsched)
        kw_t, kw_j = {}, {}
        if with_norms:
            tidx = index_for_schedule(db, tsched)
            jidx = jindex.index_for_schedule(jnp.asarray(db), jsched)
            kw_t = {"sq_prefix": tidx["sq_prefix"], "index_dims": dims}
            kw_j = {"sq_prefix": jidx["sq_prefix"], "index_dims": dims}
        want = jprog.progressive_search_pooled(
            jnp.asarray(q), jnp.asarray(db), jsched, valid=jnp.asarray(valid),
            **kw_j)
        for fn in (progressive_search_pooled, progressive_search_pooled_plain):
            got = fn(torch.from_numpy(q), torch.from_numpy(db), tsched,
                     valid=torch.from_numpy(valid), **kw_t)
            assert got[1].dtype == torch.int32
            assert_topk_close(got, want, atol=1e-4, rtol=1e-4)
        if live < 0.2:
            _, c0 = jtrunc.truncated_search(jnp.asarray(q), jnp.asarray(db),
                                            dim=ds, k=k0,
                                            valid=jnp.asarray(valid))
            assert (np.asarray(c0) == -1).any()

    def test_ties_keep_pool_order(self):
        """Duplicate rows tie exactly: the lower pool position (lower id)
        comes first, as ``lax.top_k`` orders them."""
        rng = np.random.default_rng(4)
        db = np.repeat(rng.normal(size=(40, 32)).astype(np.float32), 3, 0)
        q = rng.normal(size=(5, 32)).astype(np.float32)
        tsched = make_schedule(8, 32, 12, final_k=6)
        want = jprog.progressive_search_pooled(
            jnp.asarray(q), jnp.asarray(db), jmake_schedule(8, 32, 12,
                                                            final_k=6))
        got = progressive_search_pooled(torch.from_numpy(q),
                                        torch.from_numpy(db), tsched)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


class TestPCA:
    @staticmethod
    def _data(seed=1, n=600, d=48):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((n, d))
                * np.linspace(3.0, 0.1, d)).astype(np.float32)

    def test_fit_pca(self, monkeypatch):
        monkeypatch.setattr(tpca, "_ROWS", 128)      # several row blocks
        x = self._data()
        want = jpca.fit_pca(jnp.asarray(x), 10)
        got = tpca.fit_pca(torch.from_numpy(x), 10)
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   atol=1e-6)
        np.testing.assert_allclose(got.explained_var.numpy(),
                                   np.asarray(want.explained_var), rtol=1e-4)
        dots = (got.components.numpy() * np.asarray(want.components)).sum(0)
        np.testing.assert_allclose(np.abs(dots), 1.0, atol=1e-4)

    def test_fit_pca_power_with_reference_start(self):
        x = self._data(seed=2)
        key = jax.random.PRNGKey(0)
        start = np.array(jax.random.normal(key, (48, 18), jnp.float32))
        want = jpca.fit_pca_power(jnp.asarray(x), 10, n_iter=6, key=key)
        got = tpca.fit_pca_power(torch.from_numpy(x), 10, n_iter=6,
                                 start=torch.from_numpy(start))
        np.testing.assert_allclose(got.explained_var.numpy(),
                                   np.asarray(want.explained_var), rtol=1e-4)
        cw = np.asarray(want.components)
        cg = got.components.numpy()
        np.testing.assert_allclose(cg @ cg.T, cw @ cw.T, atol=1e-4)
        with pytest.raises(ValueError):
            tpca.fit_pca_power(torch.from_numpy(x), 10,
                               start=torch.zeros((48, 5)))
        a = tpca.fit_pca_power(torch.from_numpy(x), 10, n_iter=6,
                               generator=torch.Generator().manual_seed(3))
        np.testing.assert_allclose(a.explained_var.numpy(),
                                   np.asarray(want.explained_var), rtol=1e-3)

    def test_transform_and_state_from_numpy(self):
        x = self._data(seed=3)
        want_state = jpca.fit_pca(jnp.asarray(x), 12)
        state = tpca.pca_state_from_numpy(
            np.asarray(want_state.mean), np.asarray(want_state.components),
            np.asarray(want_state.explained_var))
        assert state.components.dtype == torch.float32
        np.testing.assert_allclose(
            tpca.pca_transform(state, torch.from_numpy(x)).numpy(),
            np.asarray(jpca.pca_transform(want_state, jnp.asarray(x))),
            atol=1e-4)

    def test_rotation_preserves_distances(self):
        x = self._data(seed=4, n=300, d=24)
        state = tpca.fit_rotation(torch.from_numpy(x))
        assert state.components.shape == (24, 24)
        r = tpca.rotate(state, torch.from_numpy(x)).double()
        xd = torch.from_numpy(x).double()
        np.testing.assert_allclose(torch.cdist(r, r).numpy(),
                                   torch.cdist(xd, xd).numpy(), atol=1e-3)
        want = jpca.fit_rotation(jnp.asarray(x))
        np.testing.assert_allclose(state.explained_var.numpy(),
                                   np.asarray(want.explained_var),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("k", [512, 1024])
def test_large_k_stage0_matches_pallas(k):
    """The stage-0 function at the sweep's largest k0 (the CUDA kernel's
    plain version on the CPU) against the Pallas kernel in interpret mode
    (``block_n >= k``) and the XLA truncated search."""
    rng = np.random.default_rng(k)
    n, dim = 2 * k + 37, 16
    q = rng.normal(size=(5, 24)).astype(np.float32)
    db = rng.normal(size=(n, 24)).astype(np.float32)
    want = pallas_l2_topk(jnp.asarray(q[:, :dim]), jnp.asarray(db[:, :dim]),
                          k=k, block_q=8, block_n=k, interpret=True)
    got = distance_topk.l2_topk(torch.from_numpy(q), torch.from_numpy(db),
                                dim=dim, k=k)
    assert_topk_close(got, want)
    valid = rng.random(n) > 0.7                   # fewer live rows than k
    want = jtrunc.truncated_search(jnp.asarray(q), jnp.asarray(db), dim=dim,
                                   k=k, valid=jnp.asarray(valid))
    got = distance_topk.l2_topk_plain(torch.from_numpy(q),
                                      torch.from_numpy(db), dim=dim, k=k,
                                      valid=torch.from_numpy(valid))
    assert_topk_close(got, want)
    assert (got[1].numpy() == -1).any()


def test_paper_tables_cpu_matches_reference(capsys):
    """``launch/paper_tables.py`` on the CPU at a tiny size: its Table II
    and III accuracies are what the JAX package's own functions give on the
    same corpus."""
    n, d, nq = 3000, 256, 48
    paper_tables.main(["--config", "smoke", "--docs", str(n), "--dim",
                       str(d), "--queries", str(nq), "--device", "cpu",
                       "--runs", "1"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert all(r["device"] == "cpu" and "ms" not in r for r in rows)
    c = jcorpus.make_corpus(n, d, nq, seed=0)
    db, q, gt = (jnp.asarray(x) for x in (c.db, c.queries, c.ground_truth))

    def acc(ids):
        # equal hit counts: one query is 100 / nq points, far above 1e-4
        return pytest.approx(float(jtop1(ids, gt)) * 100, abs=1e-4)

    table2 = [r for r in rows if r["table"] == "II"]
    assert [r["dim"] for r in table2] == [16, 32, 64, 128, 256]
    for r in table2:
        want = jtrunc.truncated_search(q, db, dim=r["dim"], k=1)[1]
        assert r["acc"] == acc(want), r
    table3 = [r for r in rows if r["table"] == "III" and "check" not in r]
    assert [tuple(r["config"]) for r in table3] == [(64, 256, 64)]
    for r in table3:
        ds, dm, k0 = r["config"]
        sched = jmake_schedule(ds, dm, k0)
        idx = jindex.index_for_schedule(db, sched)
        want = jprog.progressive_search(
            q, db, sched, sq_prefix=idx["sq_prefix"],
            index_dims=tuple(int(x) for x in idx["dims"]))[1]
        assert r["prog_acc"] == acc(want), r
        assert r["trunc_acc"] == [t for t in table2
                                  if t["dim"] == dm][0]["acc"]
    kinds = {r["table"] for r in rows}
    assert kinds == {"II", "III", "fig3", "2b", "pooled"}
    fig3 = [r for r in rows if r["table"] == "fig3" and "d_start" in r]
    assert len(fig3) == len(paper_tables.sweep_cells(tcfg.SMOKE_CONFIG, n, d))
    pooled = [r for r in rows if r["table"] == "pooled"][0]
    sched = jmake_schedule(*pooled["config"])
    want = jprog.progressive_search_pooled(q, db, sched)[1]
    assert pooled["pooled_acc"] == acc(want)
