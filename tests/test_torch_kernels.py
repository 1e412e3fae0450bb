"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version; the same
seeded numpy inputs go through the Pallas kernels in interpret mode and the
JAX oracles.  The CUDA kernels themselves are held against the plain
versions on the card in ``test_torch_cuda.py``.

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

from repro.kernels import ref as jref
from repro.kernels.distance_topk import l2_topk as pallas_l2_topk
from repro.kernels.gather_rescore import gather_rescore as pallas_gather_rescore
from repro.kernels.gather_rescore import gather_rescore_topk as pallas_gather_topk

from repro_torch.core import truncated as T
from repro_torch.kernels import distance_topk, gather_rescore, ops
from repro_torch.kernels import ref as tref

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


def _data(rng, nq, n, d):
    q = rng.normal(size=(nq, d)).astype(np.float32)
    db = rng.normal(size=(n, d)).astype(np.float32)
    return q, db


class TestL2TopkPlain:
    @pytest.mark.parametrize("nq,n,d,dim,k", [
        (8, 300, 64, 32, 8),        # N % block_n != 0 (padding tail)
        (5, 130, 16, 16, 4),
        (3, 40, 32, 16, 64),        # k > N: tail slots are (+inf, -1)
    ])
    def test_matches_pallas_interpret(self, nq, n, d, dim, k):
        rng = np.random.default_rng(nq * 1000 + n)
        q, db = _data(rng, nq, n, d)
        got = distance_topk.l2_topk(torch.from_numpy(q), torch.from_numpy(db),
                                    dim=dim, k=k)
        want = pallas_l2_topk(jnp.asarray(q[:, :dim]), jnp.asarray(db[:, :dim]),
                              k=k, block_q=8, block_n=64, interpret=True)
        assert_topk_close(got, want)
        if k <= n:
            ref = jref.l2_topk_ref(jnp.asarray(q[:, :dim]),
                                   jnp.asarray(db[:, :dim]), k)
            assert_topk_close(got, ref)
        else:
            assert (np.asarray(got[1])[:, n:] == -1).all()
            assert np.isinf(np.asarray(got[0])[:, n:]).all()

    def test_precomputed_norms_and_valid(self):
        rng = np.random.default_rng(3)
        q, db = _data(rng, 6, 257, 32)
        valid = rng.random(257) > 0.3
        sq = (db[:, :16] ** 2).sum(1).astype(np.float32)
        got = distance_topk.l2_topk(
            torch.from_numpy(q), torch.from_numpy(db), dim=16, k=10,
            sq_at_dim=torch.from_numpy(sq), valid=torch.from_numpy(valid))
        # oracle: invalid rows pushed to +inf through their norms
        sq_masked = np.where(valid, sq, np.inf).astype(np.float32)
        want = jref.l2_topk_ref(jnp.asarray(q[:, :16]), jnp.asarray(db[:, :16]),
                                10, jnp.asarray(sq_masked))
        assert_topk_close(got, want)
        assert valid[np.asarray(got[1])].all()

    def test_all_invalid_gives_sentinels(self):
        rng = np.random.default_rng(4)
        q, db = _data(rng, 4, 100, 16)
        s, i = distance_topk.l2_topk(
            torch.from_numpy(q), torch.from_numpy(db), dim=8, k=5,
            valid=torch.zeros(100, dtype=torch.bool))
        assert (i == -1).all() and torch.isinf(s).all() and (s > 0).all()
        assert i.dtype == torch.int32 and s.dtype == torch.float32

    def test_port_ref_matches_jax_ref(self):
        rng = np.random.default_rng(5)
        q, db = _data(rng, 7, 90, 24)
        assert_topk_close(tref.l2_topk_ref(torch.from_numpy(q),
                                           torch.from_numpy(db), 6),
                          jref.l2_topk_ref(jnp.asarray(q), jnp.asarray(db), 6))

    def test_ties_keep_lowest_row(self):
        db = np.zeros((10, 4), np.float32)
        db[[2, 5, 7]] = 1.0                      # three identical rows
        q = np.ones((1, 4), np.float32)
        _, i = distance_topk.l2_topk(torch.from_numpy(q), torch.from_numpy(db),
                                     dim=4, k=3)
        assert i.tolist() == [[2, 5, 7]]


class TestGatherRescorePlain:
    @pytest.mark.parametrize("nq,n,d,c,k", [
        (4, 200, 64, 16, 5),
        (6, 50, 32, 13, 13),         # C not a multiple of the Pallas block
    ])
    def test_matches_pallas_interpret(self, nq, n, d, c, k):
        rng = np.random.default_rng(nq + c)
        q, db = _data(rng, nq, n, d)
        cand = rng.integers(0, n, size=(nq, c)).astype(np.int32)
        cand[:, -2:] = -1                        # padding slots
        got = gather_rescore.gather_rescore_topk(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(cand),
            dim=d, k=k)
        s_j, i_j = pallas_gather_topk(jnp.asarray(q), jnp.asarray(db),
                                      jnp.asarray(cand), k=k, block_c=8,
                                      interpret=True)
        want = (np.asarray(s_j),
                np.where(np.isfinite(np.asarray(s_j)), np.asarray(i_j), -1))
        assert_topk_close(got, want)
        scores = pallas_gather_rescore(jnp.asarray(q), jnp.asarray(db),
                                       jnp.asarray(cand), block_c=8,
                                       interpret=True)
        np.testing.assert_allclose(
            np.asarray(scores),
            np.asarray(jref.gather_rescore_ref(jnp.asarray(q), jnp.asarray(db),
                                               jnp.asarray(cand))),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            tref.gather_rescore_ref(torch.from_numpy(q), torch.from_numpy(db),
                                    torch.from_numpy(cand)).numpy(),
            np.asarray(scores), rtol=RTOL, atol=ATOL)

    def test_truncation_norms_and_valid(self):
        rng = np.random.default_rng(9)
        q, db = _data(rng, 5, 120, 32)
        cand = np.stack([rng.permutation(120)[:20] for _ in range(5)]).astype(np.int32)
        valid = np.ones(120, bool)
        valid[cand[:, :3].ravel()] = False       # deleted between stages
        sq = (db[:, :16] ** 2).sum(1).astype(np.float32)
        got = gather_rescore.gather_rescore_topk(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(cand),
            dim=16, k=20, sq_at_dim=torch.from_numpy(sq),
            valid=torch.from_numpy(valid))
        s_j = np.asarray(jref.gather_rescore_ref(
            jnp.asarray(q[:, :16]), jnp.asarray(db[:, :16]), jnp.asarray(cand)))
        s_j = np.where(valid[cand], s_j, np.inf)
        order = np.argsort(s_j, axis=1, kind="stable")
        want_s = np.take_along_axis(s_j, order, 1)
        want_i = np.where(np.isfinite(want_s),
                          np.take_along_axis(cand, order, 1), -1)
        assert_topk_close(got, (want_s, want_i))
        assert (np.asarray(got[1])[:, -3:] == -1).all()

    def test_ties_keep_lowest_position(self):
        db = np.zeros((6, 4), np.float32)
        q = np.zeros((1, 4), np.float32)
        cand = np.array([[4, 1, 3, 0]], np.int32)
        _, i = gather_rescore.gather_rescore_topk(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(cand),
            dim=4, k=3)
        assert i.tolist() == [[4, 1, 3]]


class TestOpsDispatch:
    def test_cpu_goes_to_plain_versions(self):
        rng = np.random.default_rng(11)
        q, db = map(torch.from_numpy, _data(rng, 3, 70, 16))
        a = ops.truncated_search(q, db, dim=8, k=4, block_n=32)
        b = T.truncated_search(q, db, dim=8, k=4, block_n=32)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        cand = a[1]
        c = ops.rescore_candidates(q, db, cand, dim=16, k=2)
        d = T.rescore_candidates(q, db, cand, dim=16, k=2)
        assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])

    def test_cpu_counts_no_launches(self):
        before = (distance_topk.launches, gather_rescore.launches)
        rng = np.random.default_rng(12)
        q, db = map(torch.from_numpy, _data(rng, 2, 40, 8))
        _, cand = ops.truncated_search(q, db, dim=4, k=4)
        ops.rescore_candidates(q, db, cand, dim=8, k=2)
        assert (distance_topk.launches, gather_rescore.launches) == before
