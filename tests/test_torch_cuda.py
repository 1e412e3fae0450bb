"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Every test here needs an NVIDIA GPU and skips without one; the file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same
inputs, at shapes that reach every code path (16-byte and scalar loads,
precomputed and in-kernel norms, several query tiles, k > N, padding and
invalid candidates).  Tolerance: scores ``rtol=1e-5, atol=1e-4`` (another
float32 summation order); ids equal up to near-ties.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import progressive_search_plain
from repro_torch.engine import RetrievalEngine
from repro_torch.kernels import distance_topk, gather_rescore, ops

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("nq,n,d,dim,k", [
        (1, 5000, 64, 32, 16),
        (13, 3001, 36, 36, 7),       # ragged last dim chunk, ragged last tile
        (40, 2000, 30, 30, 256),     # odd dim (scalar loads), k at the limit, 2 q tiles
        (32, 100, 16, 16, 200),      # k > N
    ])
    @pytest.mark.parametrize("with_sq,with_valid", [(True, True), (False, False)])
    def test_l2_topk_matches_plain(self, cuda, nq, n, d, dim, k, with_sq, with_valid):
        g = torch.Generator(device=cuda).manual_seed(nq + n)
        q = torch.randn((nq, d), generator=g, device=cuda)
        db = torch.randn((n, d), generator=g, device=cuda)
        sq = (db[:, :dim] ** 2).sum(1) if with_sq else None
        valid = (torch.rand((n,), generator=g, device=cuda) > 0.1) if with_valid else None
        got = distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=sq, valid=valid)
        want = distance_topk.l2_topk_plain(q, db, dim=dim, k=k, sq_at_dim=sq,
                                           valid=valid)
        torch.cuda.synchronize()
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    @pytest.mark.parametrize("nq,n,d,c,dim,k", [
        (32, 4000, 128, 64, 96, 32),
        (3, 500, 30, 17, 30, 17),    # scalar loads, k == C
    ])
    @pytest.mark.parametrize("with_sq", [True, False])
    def test_gather_rescore_matches_plain(self, cuda, nq, n, d, c, dim, k, with_sq):
        g = torch.Generator(device=cuda).manual_seed(c)
        q = torch.randn((nq, d), generator=g, device=cuda)
        db = torch.randn((n, d), generator=g, device=cuda)
        cand = torch.randint(0, n, (nq, c), generator=g, device=cuda,
                             dtype=torch.int32)
        cand[:, :2] = -1
        valid = torch.rand((n,), generator=g, device=cuda) > 0.2
        sq = (db[:, :dim] ** 2).sum(1) if with_sq else None
        got = gather_rescore.gather_rescore_topk(q, db, cand, dim=dim, k=k,
                                                 sq_at_dim=sq, valid=valid)
        want = gather_rescore.gather_rescore_topk_plain(
            q, db, cand, dim=dim, k=k, sq_at_dim=sq, valid=valid)
        torch.cuda.synchronize()
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    def test_launch_counters_and_rejections(self, cuda):
        q = torch.randn((2, 16), device=cuda)
        db = torch.randn((100, 16), device=cuda)
        before = distance_topk.launches
        _, cand = ops.truncated_search(q, db, dim=8, k=8)
        assert distance_topk.launches == before + 1
        before = gather_rescore.launches
        ops.rescore_candidates(q, db, cand, dim=16, k=4)
        assert gather_rescore.launches == before + 1
        with pytest.raises(ValueError):
            distance_topk.l2_topk(q, db, dim=8, k=distance_topk.MAX_K + 1)
        with pytest.raises(ValueError):
            distance_topk.l2_topk(q.double(), db.double(), dim=8, k=4)
        with pytest.raises(ValueError):
            gather_rescore.gather_rescore_topk(q, db, cand.long(), dim=8, k=4)
        with pytest.raises(NotImplementedError):
            ops.truncated_search(q, db, dim=8, k=4, metric="cosine")


@pytest.mark.cuda
class TestEngineOnCard:
    def test_engine_matches_plain_path(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(7)
        docs = torch.randn((3000, 64), generator=g, device=cuda)
        eng = RetrievalEngine(64, d_start=8, k0=32, final_k=5,
                              buckets=(1, 8), capacity=4096)
        assert eng.device.type == "cuda"
        eng.add_docs(docs)
        gone = np.arange(0, 3000, 7)
        eng.delete_docs(gone)
        q = docs[:20] + 0.1 * torch.randn((20, 64), generator=g, device=cuda)
        before = (distance_topk.launches, gather_rescore.launches)
        s, i = eng.search(q.cpu().numpy())
        assert distance_topk.launches > before[0]
        assert gather_rescore.launches > before[1]
        st = eng.store
        ws, wi = progressive_search_plain(q, st.db, eng.sched,
                                          sq_prefix=st.sq_prefix,
                                          index_dims=eng.dims, valid=st.valid)
        assert_topk_close((s, i), (ws[:, :5].cpu(), wi[:, :5].cpu()))
        assert not np.isin(i, gone).any()
