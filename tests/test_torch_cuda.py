"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Every test here needs an NVIDIA GPU and skips without one; the file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same
inputs, at shapes that reach every code path (16-byte and scalar loads,
precomputed and in-kernel norms, several query tiles, k > N, padding and
invalid candidates; for the IVF and PQ scans float32 and int8 slabs, empty
and fully tombstoned lists, k beyond the rows scanned; stage 0 at k 257 to
1,024 on its kernels, and its ``wide`` route above 256 dims at every k).  The pooled search and PCA run on the card
against the CPU port (the same tolerance; PCA variances 1e-4 relative).  Tolerance: scores
``rtol=1e-5, atol=1e-4`` (another float32 summation order); ids equal up to
near-ties.  The flash-attention kernels (the tensor-core bf16 prefill, the
split-kv decode, the FMA kernel for the rest) are held against their plain
version at ``2e-4`` in float32 (the JAX package's own tolerance) and
``2e-2`` in bfloat16 (a small multiple of the one bf16 step, 7.8e-3,
measured), each case also checking which kernel served it; and the LM's ``decode_step`` on the card against
``device="cpu"`` at the smoke config.  The embedding-bag kernel equals
its plain version (``torch.equal``: both add the rows in id order to a
float32 sum from +0.0), float32 and bfloat16 tables alike, on both
routes; the segment-sum kernel within ``1e-5`` of each segment's
sum of |x| plus ``1e-6`` (another summation order; the plain version sums
in float64).  The recsys models and EGNN at their smoke configs run on the
card (kernel path) against the same weights on the CPU (plain path).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import progressive_search_plain
from repro_torch.engine import EngineConfig, RetrievalEngine
from repro_torch.engine.config import IVFConfig, QuantizedConfig
from repro_torch.configs import get_arch
from repro_torch.configs.mistral_nemo_12b import SMOKE_CONFIG
from repro_torch.kernels import (distance_topk, embedding_bag, flash_attention,
                                 gather_rescore, ivf_scan, ops, pq_scan,
                                 segment_sum)
from repro_torch.layers.common import MLP
from repro_torch.models import egnn as EG
from repro_torch.models import graph as G
from repro_torch.models import lm as LM
from repro_torch.models import recsys as R

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

    @pytest.mark.parametrize("nq", [1, 8, 32, 33, 256, 512])
    @pytest.mark.parametrize("dim", [64, 128, 30])
    def test_l2_topk_kernels_and_k(self, cuda, nq, dim):
        """Both pass-1 kernels (dim 30 goes to ``fma``) at every k class,
        held against the plain version; the route is counted."""
        g = torch.Generator(device=cuda).manual_seed(nq * 7 + dim)
        n = 20_000
        db = torch.randn((n, dim + 4), generator=g, device=cuda)
        q = torch.randn((nq, dim + 4), generator=g, device=cuda)
        valid = torch.rand((n,), generator=g, device=cuda) > 0.05
        kind = "wgmma" if dim % 4 == 0 else "fma"
        assert distance_topk.route(q, db, dim) == kind
        for k in (1, 64, 128, 256):
            before = distance_topk.launches_by_kernel[kind]
            got = distance_topk.l2_topk(q, db, dim=dim, k=k, valid=valid)
            assert distance_topk.launches_by_kernel[kind] == before + 1
            want = distance_topk.l2_topk_plain(q, db, dim=dim, k=k,
                                               valid=valid)
            torch.cuda.synchronize()
            assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    def test_l2_topk_edges(self, cuda):
        """An unaligned row stride (``fma``), Ncap < k and all rows invalid
        (``wgmma``), each against the plain version."""
        g = torch.Generator(device=cuda).manual_seed(11)
        q = torch.randn((40, 129), generator=g, device=cuda)
        db = torch.randn((3000, 129), generator=g, device=cuda)
        assert distance_topk.route(q, db, 64) == "fma"        # ld 129
        assert distance_topk.route(q, db[:, 1:], 64) == "fma"  # base + 4 bytes
        for qq, dd in ((q, db), (q[:, 1:], db[:, 1:])):
            assert_topk_close(
                [x.cpu() for x in distance_topk.l2_topk(qq, dd, dim=64, k=50)],
                [x.cpu() for x in distance_topk.l2_topk_plain(qq, dd, dim=64,
                                                              k=50)])
        small = torch.randn((50, 64), generator=g, device=cuda)
        s, i = distance_topk.l2_topk(q[:, :64], small, dim=64, k=64)
        assert distance_topk.route(q, small, 64) == "wgmma"
        assert (i[:, 50:] == -1).all() and torch.isinf(s[:, 50:]).all()
        assert_topk_close([s.cpu(), i.cpu()],
                          [x.cpu() for x in distance_topk.l2_topk_plain(
                              q[:, :64], small, dim=64, k=64)])
        none = torch.zeros((3000,), dtype=torch.bool, device=cuda)
        s, i = distance_topk.l2_topk(q[:, :64].contiguous(), db[:, :64].contiguous(),
                                     dim=64, k=16, valid=none)
        assert (i == -1).all() and torch.isinf(s).all()

    @pytest.mark.parametrize("nq,dim,k", [(32, 128, 64), (512, 64, 128),
                                          (3, 36, 256)])
    def test_l2_topk_split_count_does_not_matter(self, cuda, nq, dim, k,
                                                 monkeypatch):
        """The same call planned for 1, 7, 50 and 132 SMs (other splits of
        the doc axis, other merge groups) gives the same bits."""
        g = torch.Generator(device=cuda).manual_seed(nq + dim)
        db = torch.randn((40_000, dim), generator=g, device=cuda)
        q = torch.randn((nq, dim), generator=g, device=cuda)
        sq = (db * db).sum(1)
        outs = []
        for n_sm in (1, 7, 50, 132):
            monkeypatch.setitem(distance_topk._n_sm, cuda.index or 0, n_sm)
            outs.append(distance_topk.l2_topk(q, db, dim=dim, k=k,
                                              sq_at_dim=sq))
        for s, i in outs[1:]:
            assert torch.equal(s, outs[0][0]) and torch.equal(i, outs[0][1])

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
class TestLargeKOnCard:
    """The stage-0 kernel above k = 256 (lists of 1,024 / 2,048 slots in
    shared memory, tightened and sorted there; pass 2 folding fewer lists a
    round), on both pass-1 kernels, against the plain version."""

    @pytest.mark.parametrize("k", [257, 512, 1000, 1024])
    @pytest.mark.parametrize("nq,dim,d,kind", [
        (13, 64, 68, "wgmma"),       # Q below one tile
        (37, 128, 128, "wgmma"),     # Q not a multiple of the tile
        (9, 30, 34, "fma"),          # odd dim: scalar loads
        (21, 512, 512, "wide"),      # wider than ``wgmma``
        (21, 512, 514, "fma"),       # stride 514: TMA cannot read
    ])
    def test_matches_plain(self, cuda, nq, dim, d, kind, k):
        g = torch.Generator(device=cuda).manual_seed(nq * 31 + k)
        n = 30_000
        db = torch.randn((n, d), generator=g, device=cuda)
        q = torch.randn((nq, d), generator=g, device=cuda)
        valid = torch.rand((n,), generator=g, device=cuda) > 0.1
        sq = (db[:, :dim] ** 2).sum(1)
        assert distance_topk.route(q, db, dim, k) == kind
        for sq_at, ok in ((sq, valid), (None, None)):
            before = distance_topk.launches_by_kernel[kind]
            got = distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=sq_at,
                                        valid=ok)
            assert distance_topk.launches_by_kernel[kind] == before + 1
            want = distance_topk.l2_topk_plain(q, db, dim=dim, k=k,
                                               sq_at_dim=sq_at, valid=ok)
            torch.cuda.synchronize()
            assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    @pytest.mark.parametrize("k", [512, 1024])
    @pytest.mark.parametrize("dim,d", [(64, 64), (30, 32)])
    def test_fewer_live_rows_than_k(self, cuda, dim, d, k):
        """Tombstones leave fewer live rows than k: the tail of every row
        is (+inf, -1), the rest equals the plain version."""
        g = torch.Generator(device=cuda).manual_seed(k + dim)
        n = 3000
        db = torch.randn((n, d), generator=g, device=cuda)
        q = torch.randn((19, d), generator=g, device=cuda)
        valid = torch.rand((n,), generator=g, device=cuda) < 0.1
        live = int(valid.sum())
        assert live < k
        s, i = distance_topk.l2_topk(q, db, dim=dim, k=k, valid=valid)
        torch.cuda.synchronize()
        assert (i[:, live:] == -1).all() and torch.isinf(s[:, live:]).all()
        assert valid[i[:, :live].long()].all()
        assert_topk_close([s.cpu(), i.cpu()],
                          [x.cpu() for x in distance_topk.l2_topk_plain(
                              q, db, dim=dim, k=k, valid=valid)])
        few = db[:700]                                    # Ncap < k
        assert_topk_close(
            [x.cpu() for x in distance_topk.l2_topk(q, few, dim=dim, k=k)],
            [x.cpu() for x in distance_topk.l2_topk_plain(q, few, dim=dim,
                                                          k=k)])

    @pytest.mark.parametrize("nq,dim,k", [(32, 128, 1024), (40, 512, 512),
                                          (5, 30, 700)])
    def test_split_count_does_not_matter(self, cuda, nq, dim, k,
                                         monkeypatch):
        g = torch.Generator(device=cuda).manual_seed(nq + dim + k)
        db = torch.randn((40_000, dim), generator=g, device=cuda)
        q = torch.randn((nq, dim), generator=g, device=cuda)
        outs = []
        for n_sm in (1, 7, 132):
            monkeypatch.setitem(distance_topk._n_sm, cuda.index or 0, n_sm)
            outs.append(distance_topk.l2_topk(q, db, dim=dim, k=k))
        for s, i in outs[1:]:
            assert torch.equal(s, outs[0][0]) and torch.equal(i, outs[0][1])

    def test_small_k_keeps_its_plan(self, cuda):
        """Calls at k <= 256 keep the route and tiles they had before the
        large-k lists: the serving stage 0, the two-tower's and the FMA
        kernel's (on rows TMA cannot read; aligned float32 rows at 512 dims
        go to ``wide``)."""
        q = torch.zeros((32, 3584), device=cuda)
        db = torch.zeros((4096, 3584), device=cuda)
        assert distance_topk.plan(q, db, 128, 64)[:4] == ("wgmma", 32, 2, 3)
        q512 = torch.zeros((512, 64), device=cuda)
        assert distance_topk.plan(q512, db[:, :64].contiguous(), 64,
                                  128)[:4] == ("wgmma", 32, 3, 3)
        assert distance_topk.plan(q, db[:, 1:], 512, 256)[:4] == (
            "fma", 4, 0, 2)
        assert distance_topk.plan(q, db, 512, 256)[:4] == ("wide", 32, 4, 2)
        assert distance_topk.plan(q, db, 256, 256)[:4] == ("wgmma", 32, 2, 2)

    def test_rejects_k_above_1024(self, cuda):
        q = torch.randn((2, 16), device=cuda)
        db = torch.randn((2000, 16), device=cuda)
        with pytest.raises(ValueError):
            distance_topk.l2_topk(q, db, dim=16, k=1025)
        s, i = distance_topk.l2_topk(q, db, dim=16, k=1024)
        assert s.shape == (2, 1024)


@pytest.mark.cuda
class TestWideStage0OnCard:
    """The wide-dim tensor-core route of stage 0 (``wide``,
    ``csrc/distance_topk_wide.cu``: float32 rows TMA can read above 256
    dims, every k up to 1,024) against the plain version; the route is
    counted."""

    @pytest.mark.parametrize("nq", [1, 33, 300])
    @pytest.mark.parametrize("k", [1, 16, 64, 256, 512, 1024])
    @pytest.mark.parametrize("dim", [260, 516, 1000, 3584])
    def test_matches_plain(self, cuda, dim, k, nq):
        g = torch.Generator(device=cuda).manual_seed(dim * 7 + k + nq)
        n = 12_000 if dim > 1000 else 30_000
        db = torch.randn((n, dim + 4), generator=g, device=cuda)
        q = torch.randn((nq, dim + 4), generator=g, device=cuda)
        valid = torch.rand((n,), generator=g, device=cuda) > 0.1
        sq = (db[:, :dim] ** 2).sum(1)
        assert distance_topk.route(q, db, dim, k) == "wide"
        for sq_at, ok in ((sq, valid), (None, None)):
            before = distance_topk.launches_by_kernel["wide"]
            got = distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=sq_at,
                                        valid=ok)
            assert distance_topk.launches_by_kernel["wide"] == before + 1
            want = distance_topk.l2_topk_plain(q, db, dim=dim, k=k,
                                               sq_at_dim=sq_at, valid=ok)
            torch.cuda.synchronize()
            assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    @pytest.mark.parametrize("k", [1, 64])
    def test_near_twins_at_3584_dims(self, cuda, k):
        """Queries that are near copies of rows (dot products as large as
        the norms, as in the paper's corpus) keep the plain version's scores
        over 3,584 dims: the products' sums do not drift."""
        g = torch.Generator(device=cuda).manual_seed(k)
        db = torch.randn((20_000, 3584), generator=g, device=cuda)
        src = torch.randint(0, 20_000, (300,), generator=g, device=cuda)
        q = db[src] + 0.05 * torch.randn((300, 3584), generator=g,
                                         device=cuda)
        got = distance_topk.l2_topk(q, db, dim=3584, k=k)
        want = distance_topk.l2_topk_plain(q, db, dim=3584, k=k)
        torch.cuda.synchronize()
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])
        assert torch.equal(got[1][:, 0], src.int())

    @pytest.mark.parametrize("k", [16, 1024])
    def test_ncap_below_k_and_all_invalid(self, cuda, k):
        """A store with fewer rows than k: its tail (+inf, -1); every row
        invalid: every slot (+inf, -1)."""
        g = torch.Generator(device=cuda).manual_seed(k)
        q = torch.randn((40, 516), generator=g, device=cuda)
        few = torch.randn((k // 2 + 3, 516), generator=g, device=cuda)
        s, i = distance_topk.l2_topk(q, few, dim=516, k=k)
        torch.cuda.synchronize()
        live = few.shape[0]
        assert (i[:, live:] == -1).all() and torch.isinf(s[:, live:]).all()
        assert_topk_close([s.cpu(), i.cpu()],
                          [x.cpu() for x in distance_topk.l2_topk_plain(
                              q, few, dim=516, k=k)])
        db = torch.randn((3000, 516), generator=g, device=cuda)
        none = torch.zeros((3000,), dtype=torch.bool, device=cuda)
        s, i = distance_topk.l2_topk(q, db, dim=516, k=k, valid=none)
        assert distance_topk.route(q, db, 516, k) == "wide"
        assert (i == -1).all() and torch.isinf(s).all()

    @pytest.mark.parametrize("nq,dim,k", [(33, 516, 64), (300, 1000, 1024),
                                          (1, 3584, 16), (70, 512, 300)])
    def test_split_count_does_not_matter(self, cuda, nq, dim, k,
                                         monkeypatch):
        """The same call planned for 1, 7, 50 and 132 SMs (other cuts of the
        doc axis, grids, merge groups) gives the same bits."""
        g = torch.Generator(device=cuda).manual_seed(nq + dim + k)
        db = torch.randn((40_000, dim), generator=g, device=cuda)
        q = torch.randn((nq, dim), generator=g, device=cuda)
        outs = []
        for n_sm in (1, 7, 50, 132):
            monkeypatch.setitem(distance_topk._n_sm, cuda.index or 0, n_sm)
            outs.append(distance_topk.l2_topk(q, db, dim=dim, k=k))
        for s, i in outs[1:]:
            assert torch.equal(s, outs[0][0]) and torch.equal(i, outs[0][1])

    def test_exact_ties_keep_the_lower_id(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(3)
        db = torch.randn((500, 512), generator=g, device=cuda).repeat(8, 1)
        q = torch.randn((20, 512), generator=g, device=cuda)
        s, i = distance_topk.l2_topk(q, db, dim=512, k=64)
        want = distance_topk.l2_topk_plain(q, db, dim=512, k=64)
        torch.cuda.synchronize()
        assert torch.equal(i, want[1])

    def test_built_plan_and_counters(self, cuda):
        """The built library's plan is `wide_plan`'s; a call is one
        ``wide`` launch of ``l2_topk`` through ``ops``."""
        for nq in (1, 9, 33, 2470):
            for k in (1, 64, 65, 256, 300, 512, 700, 1024):
                assert distance_topk.built_wide_plan(nq, k) == \
                    distance_topk.wide_plan(nq, k)
        q = torch.randn((5, 600), device=cuda)
        db = torch.randn((1000, 600), device=cuda)
        before = (distance_topk.launches,
                  dict(distance_topk.launches_by_kernel))
        ops.truncated_search(q, db, dim=600, k=8)
        assert distance_topk.launches == before[0] + 1
        after = dict(distance_topk.launches_by_kernel)
        assert after.pop("wide") == before[1].pop("wide") + 1
        assert after == before[1]


def _bf16_case(dev, nq, n, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    db = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((nq, d), generator=g, device=dev).to(torch.bfloat16)
    valid = torch.rand((n,), generator=g, device=dev) > 0.1
    return q, db, valid


@pytest.mark.cuda
class TestBf16Stage0OnCard:
    """The bf16 route of stage 0 (the staged index's block: bf16 rows and
    queries, float32 sums) on both pass-1 kernels, against the plain
    version on the same bf16 tensors.  Products of two bf16 values are
    exact in float32, so the scores differ only by the order of the float32
    sums: the float32 route's tolerance."""

    @pytest.mark.parametrize("k", [1, 128, 1024])
    @pytest.mark.parametrize("nq,dim,d,kind", [
        (32, 128, 128, "wgmma"),     # the serving stage 0
        (512, 64, 64, "wgmma"),      # the two-tower stage 0
        (37, 256, 256, "wgmma"),     # the widest tensor-core dim, 2 tiles
        (5, 64, 72, "wgmma"),        # a row stride of 72 (144 bytes)
        (9, 8, 8, "fma"),            # dim 8: below one k16 step
        (21, 64, 68, "fma"),         # stride 68 (136 bytes): TMA cannot
        (13, 30, 34, "fma"),         # odd dim and stride: scalar loads
        (40, 320, 320, "fma"),       # wider than the tensor-core kernel
    ])
    def test_matches_plain(self, cuda, nq, dim, d, kind, k):
        q, db, valid = _bf16_case(cuda, nq, 20_000, d, nq * 17 + dim + k)
        sq = (db[:, :dim].float() ** 2).sum(1)
        assert distance_topk.route(q, db, dim, k) == kind
        key = kind + "_bf16"
        for sq_at, ok in ((sq, valid), (None, None)):
            before = dict(distance_topk.launches_by_kernel)
            got = distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=sq_at,
                                        valid=ok)
            after = distance_topk.launches_by_kernel
            assert after[key] == before[key] + 1
            assert all(after[x] == before[x] for x in after if x != key)
            want = distance_topk.l2_topk_plain(q, db, dim=dim, k=k,
                                               sq_at_dim=sq_at, valid=ok)
            torch.cuda.synchronize()
            assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    @pytest.mark.parametrize("kind", ["wgmma", "fma"])
    def test_unaligned_base_and_holes(self, cuda, kind):
        """A base 2 bytes past alignment (``fma`` either way), a view whose
        prefix starts mid-row, all-invalid rows and fewer live rows than
        k: sentinels identical to the plain version's."""
        q, db, _ = _bf16_case(cuda, 24, 3000, 136, 5)
        if kind == "wgmma":
            qq, dd = q[:, 8:].contiguous(), db[:, 8:]     # 16-byte offset
        else:
            qq, dd = q[:, 1:], db[:, 1:]                  # 2-byte offset
        assert distance_topk.route(qq, dd, 64, 128) == kind
        valid = torch.rand((3000,), device=cuda) < 0.02
        live = int(valid.sum())
        s, i = distance_topk.l2_topk(qq, dd, dim=64, k=128, valid=valid)
        torch.cuda.synchronize()
        assert (i[:, live:] == -1).all() and torch.isinf(s[:, live:]).all()
        assert_topk_close([s.cpu(), i.cpu()], [
            x.cpu() for x in distance_topk.l2_topk_plain(
                qq, dd, dim=64, k=128, valid=valid)])
        none = torch.zeros((3000,), dtype=torch.bool, device=cuda)
        s, i = distance_topk.l2_topk(qq, dd, dim=64, k=16, valid=none)
        assert (i == -1).all() and torch.isinf(s).all()

    def test_exact_ties_keep_the_lower_id(self, cuda):
        """Row r + 2048 repeats row r: both kernels score the two the same
        bits and list the lower id first, as the plain version does."""
        q, base, _ = _bf16_case(cuda, 16, 2048, 64, 9)
        db = torch.cat([base, base])
        wide = torch.zeros((4096, 66), dtype=torch.bfloat16, device=cuda)
        wide[:, :64] = db                               # stride 66: fma
        for dd, kind in ((db, "wgmma"), (wide, "fma")):
            assert distance_topk.route(q, dd, 64, 64) == kind
            s, i = distance_topk.l2_topk(q, dd, dim=64, k=64)
            want = distance_topk.l2_topk_plain(q, dd, dim=64, k=64)
            torch.cuda.synchronize()
            assert (i[:, 0::2] + 2048 == i[:, 1::2]).all(), kind
            assert torch.equal(s[:, 0::2], s[:, 1::2]), kind
            assert_topk_close([s.cpu(), i.cpu()], [x.cpu() for x in want])

    def test_split_count_does_not_matter(self, cuda, monkeypatch):
        q, db, _ = _bf16_case(cuda, 512, 40_000, 64, 3)
        outs = []
        for n_sm in (1, 7, 132):
            monkeypatch.setitem(distance_topk._n_sm, cuda.index or 0, n_sm)
            outs.append(distance_topk.l2_topk(q, db, dim=64, k=128))
        for s, i in outs[1:]:
            assert torch.equal(s, outs[0][0]) and torch.equal(i, outs[0][1])

    def test_rejects_mixed_dtypes(self, cuda):
        q, db, _ = _bf16_case(cuda, 2, 100, 16, 1)
        with pytest.raises(ValueError):
            distance_topk.l2_topk(q.float(), db, dim=16, k=4)
        with pytest.raises(ValueError):
            distance_topk.l2_topk(q.half(), db.half(), dim=16, k=4)


@pytest.mark.cuda
class TestPaperPathOnCard:
    """The pooled search and PCA on the card against the CPU port."""

    def test_pooled_matches_cpu(self, cuda):
        from repro_torch.core import (index_for_schedule, make_schedule,
                                      progressive_search_pooled)
        from repro_torch.rag import make_corpus
        c = make_corpus(20_000, 256, 64, seed=3)
        sched = make_schedule(32, 256, 512, final_k=4)
        valid = np.random.default_rng(0).random(20_000) > 0.05
        out = {}
        for dev in ("cpu", cuda):
            idx = index_for_schedule(c.db, sched, valid=valid, device=dev)
            before = distance_topk.launches
            out[str(dev)] = progressive_search_pooled(
                torch.from_numpy(c.queries).to(dev), idx["db"], sched,
                sq_prefix=idx["sq_prefix"],
                index_dims=tuple(s.dim for s in sched.stages),
                valid=idx["valid"])
            if dev != "cpu":
                assert distance_topk.launches == before + 1
        torch.cuda.synchronize()
        got = [x.cpu() for x in out["cuda"]]
        assert_topk_close(got, out["cpu"])
        with pytest.raises(NotImplementedError):
            progressive_search_pooled(
                torch.from_numpy(c.queries).to(cuda), idx["db"], sched,
                metric="cosine")

    def test_pca_matches_cpu(self, cuda):
        from repro_torch.core import pca
        rng = np.random.default_rng(5)
        x = (rng.standard_normal((4000, 96))
             * np.linspace(3.0, 0.1, 96)).astype(np.float32)
        cpu = pca.fit_pca(torch.from_numpy(x), 16)
        gpu = pca.fit_pca(torch.from_numpy(x).to(cuda), 16)
        np.testing.assert_allclose(gpu.explained_var.cpu(), cpu.explained_var,
                                   rtol=1e-4)
        dots = (gpu.components.cpu() * cpu.components).sum(0).abs()
        np.testing.assert_allclose(dots, 1.0, atol=1e-4)
        start = torch.from_numpy(rng.standard_normal((96, 24))
                                 .astype(np.float32))
        cpu = pca.fit_pca_power(torch.from_numpy(x), 16, n_iter=6,
                                start=start)
        gpu = pca.fit_pca_power(torch.from_numpy(x).to(cuda), 16, n_iter=6,
                                start=start)
        np.testing.assert_allclose(gpu.explained_var.cpu(), cpu.explained_var,
                                   rtol=1e-4)
        proj = lambda c: c @ c.T
        np.testing.assert_allclose(proj(gpu.components.cpu()),
                                   proj(cpu.components), atol=1e-4)


def _ivf_case(dev, nq, n_lists, max_len, dim, n_probe, dtype, seed):
    """(q, probe, masked member ids, pack): random lists with padding, an
    empty list, a fully tombstoned list and scattered tombstones."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = n_lists * max_len
    db = torch.randn((n, dim), generator=g, device=dev)
    fill = torch.randint(max_len // 2, max_len + 1, (n_lists,), generator=g,
                         device=dev)
    slot = torch.arange(max_len, device=dev)
    lists = (torch.arange(n_lists, device=dev)[:, None] * max_len + slot)
    lists = torch.where(slot < fill[:, None], lists, -1).to(torch.int32)
    lists[0] = -1                                     # an empty list
    valid = torch.rand((n,), generator=g, device=dev) > 0.1
    valid[lists[1].clamp(min=0).long()] = False       # all tombstoned
    cb = None
    if dtype == "pq":
        m = 8 if dim % 8 == 0 else 1
        cb = torch.randn((m, 256, dim // m), generator=g, device=dev)
    pack = ivf_scan.pack_ivf_lists(db, lists, dim=dim, dtype=dtype,
                                   block_m=min(128, max_len),
                                   pq_codebooks=cb)
    masked = torch.where((lists >= 0) & valid[lists.clamp(min=0).long()],
                         lists, torch.full_like(lists, -1))
    q = torch.randn((nq, dim + 3), generator=g, device=dev)
    probe = torch.stack([torch.randperm(n_lists, generator=g, device=dev)
                         [:n_probe] for _ in range(nq)]).to(torch.int32)
    probe[0, :2] = torch.tensor([0, 1], device=dev)   # empty + tombstoned
    return q, probe, masked, pack


@pytest.mark.cuda
class TestScanKernelsOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    @pytest.mark.parametrize("nq,n_lists,max_len,dim,n_probe,k", [
        (5, 16, 64, 32, 4, 10),
        (3, 12, 48, 30, 5, 300),      # scalar loads, k > rows scanned
        (32, 64, 512, 128, 12, 64),   # the serving shape, fewer lists
    ])
    def test_ivf_scan_matches_plain(self, cuda, dtype, nq, n_lists, max_len,
                                    dim, n_probe, k):
        q, probe, masked, pack = _ivf_case(cuda, nq, n_lists, max_len, dim,
                                           n_probe, dtype, seed=k)
        before = ivf_scan.launches
        got = ivf_scan.ivf_scan_topk(q, probe, masked, pack, k=k)
        want = ivf_scan.ivf_scan_topk_plain(q, probe, masked, pack, k=k)
        torch.cuda.synchronize()
        assert ivf_scan.launches == before + 1
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])
        ids = got[1]
        live = set(masked[masked >= 0].tolist())
        assert set(ids[ids >= 0].tolist()) <= live      # no tombstone back

    @pytest.mark.parametrize("nq,n_lists,max_len,dim,n_probe,k", [
        (4, 16, 64, 32, 4, 20),
        (3, 12, 48, 24, 5, 300),      # k > rows scanned
        (32, 64, 512, 128, 12, 256),  # the serving shape, fewer lists
    ])
    def test_pq_ivf_scan_matches_plain(self, cuda, nq, n_lists, max_len, dim,
                                       n_probe, k):
        q, probe, masked, pack = _ivf_case(cuda, nq, n_lists, max_len, dim,
                                           n_probe, "pq", seed=k)
        before = pq_scan.ivf_launches
        got = pq_scan.pq_ivf_scan_topk(q, probe, masked, pack, k=k)
        want = pq_scan.pq_ivf_scan_topk_plain(q, probe, masked, pack, k=k)
        torch.cuda.synchronize()
        assert pq_scan.ivf_launches == before + 1
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    @pytest.mark.parametrize("nq,n,m,k", [
        (1, 70000, 16, 256),          # many row ranges, 16-byte code loads
        (32, 20000, 16, 256),
        (5, 3001, 4, 40),             # 4-byte loads
        (3, 100, 3, 150),             # byte loads, k > N
    ])
    def test_pq_scan_matches_plain(self, cuda, nq, n, m, k):
        g = torch.Generator(device=cuda).manual_seed(n)
        lut = torch.randn((nq, m, 256), generator=g, device=cuda)
        codes = torch.randint(0, 256, (n, m), generator=g, device=cuda,
                              dtype=torch.uint8)
        ids = torch.arange(n, device=cuda, dtype=torch.int32)
        ids[torch.rand((n,), generator=g, device=cuda) < 0.2] = -1
        before = pq_scan.flat_launches
        got = pq_scan.pq_scan_topk(lut, codes, ids, k=k)
        want = pq_scan.pq_scan_topk_plain(lut, codes, ids, k=k)
        torch.cuda.synchronize()
        assert pq_scan.flat_launches == before + 1
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    def test_all_masked_ties_and_rejections(self, cuda):
        q, probe, masked, pack = _ivf_case(cuda, 2, 8, 32, 16, 3, "float32",
                                           seed=1)
        none = torch.full_like(masked, -1)
        s, i = ivf_scan.ivf_scan_topk(q, probe, none, pack, k=9)
        assert (i == -1).all() and torch.isinf(s).all()
        lut = torch.zeros((2, 4, 256), device=cuda)
        codes = torch.zeros((50, 4), dtype=torch.uint8, device=cuda)
        ids = torch.arange(50, dtype=torch.int32, device=cuda)
        s, i = pq_scan.pq_scan_topk(lut, codes, torch.full_like(ids, -1), k=5)
        assert (i == -1).all() and torch.isinf(s).all()
        # equal scores keep the lower row, as lax.top_k orders them
        ids[3] = -1
        _, i = pq_scan.pq_scan_topk(lut, codes, ids, k=5)
        assert i.cpu().tolist() == [[0, 1, 2, 4, 5]] * 2
        with pytest.raises(ValueError):
            ivf_scan.ivf_scan_topk(q, probe, masked, pack,
                                   k=ivf_scan.MAX_K + 1)
        with pytest.raises(ValueError):
            pq_scan.pq_scan_topk(lut, codes.to(torch.int32), ids, k=5)


def _list_state(dev, nq, n_lists, max_len, dim, n_probe, dtype, seed, *,
                shared=False, n_dead=2):
    """A list-major scan's inputs: the raw member table (padding, an empty
    list, ``n_dead`` - 1 fully tombstoned lists, scattered tombstones), the
    store's validity bits, the masked table and the pack; probes drawn
    from ``n_probe`` + 2 lists when ``shared`` (every list probed by
    several queries); query 1 probes only dead lists when n_probe <=
    n_dead."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = n_lists * max_len
    db = torch.randn((n, dim), generator=g, device=dev)
    fill = torch.randint(max_len // 2, max_len + 1, (n_lists,), generator=g,
                         device=dev)
    slot = torch.arange(max_len, device=dev)
    lists = (torch.arange(n_lists, device=dev)[:, None] * max_len + slot)
    lists = torch.where(slot < fill[:, None], lists, -1).to(torch.int32)
    lists[0] = -1                                     # an empty list
    valid = torch.rand((n,), generator=g, device=dev) > 0.1
    for j in range(1, n_dead):                        # all tombstoned
        valid[lists[j].clamp(min=0).long()] = False
    cb = None
    if dtype == "pq":
        m = 8 if dim % 8 == 0 else 1
        cb = torch.randn((m, 256, dim // m), generator=g, device=dev)
    pack = ivf_scan.pack_ivf_lists(db, lists, dim=dim, dtype=dtype,
                                   block_m=min(128, max_len),
                                   pq_codebooks=cb)
    q = torch.randn((nq, dim + 3), generator=g, device=dev)
    pool = min(n_lists, n_probe + 2) if shared else n_lists
    probe = torch.stack([torch.randperm(pool, generator=g, device=dev)
                         [:n_probe] for _ in range(nq)]).to(torch.int32)
    if nq > 1 and n_probe <= n_dead:
        probe[1] = torch.randperm(n_dead, generator=g, device=dev)[:n_probe]
    return dict(q=q, probe=probe, lists=lists, valid=valid, pack=pack,
                masked=ivf_scan.mask_members(lists, valid))


def _list_scan(st, k, **kw):
    if st["pack"]["dtype"] == "pq":
        return pq_scan.pq_ivf_scan_topk(st["q"], st["probe"], st["lists"],
                                        st["pack"], k=k, **kw)
    return ivf_scan.ivf_scan_topk(st["q"], st["probe"], st["lists"],
                                  st["pack"], k=k, **kw)


def _list_plain(st, k, *, mirror=False):
    if st["pack"]["dtype"] == "pq":
        return pq_scan.pq_ivf_scan_topk_plain(
            st["q"], st["probe"], st["lists"], st["pack"], k=k,
            valid=st["valid"])
    fn = ivf_scan.ivf_scan_mirror if mirror else ivf_scan.ivf_scan_topk_plain
    return fn(st["q"], st["probe"], st["lists"], st["pack"], k=k,
              valid=st["valid"])


def _kernel_names(fn, calls=3):
    """name -> launches of every CUDA kernel ``calls`` calls of ``fn`` run,
    from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "CUDA" in str(getattr(ev, "device_type", "")) \
                and "Memset" not in ev.key and "Memcpy" not in ev.key:
            out[ev.key] = out.get(ev.key, 0) + ev.count
    return out


@pytest.mark.cuda
class TestListScanOnCard:
    """The one-launch list-major scans (float32 / int8 slabs and PQ codes)
    with tombstones read from ``valid``: held against the plain versions
    (which mask the table first) over Q 1-512, n_probe 1-16 and n_lists,
    k 1-2048 (beyond the rows scanned), lists shared by several queries and
    dead lists.  The PQ kernel's scores are the plain version's bits (the
    same additions in m order); the float32 / int8 scores are
    `ivf_scan_mirror`'s (one FMA chain a row in dim order) within one part
    in 1e6 (the mirror's emulated FMA may round twice) and the plain
    version's within the file's tolerance.  The ``valid`` route gives the
    same bits as the pre-masked route; every call is one launch."""

    @pytest.mark.parametrize("dtype", ["float32", "int8", "pq"])
    @pytest.mark.parametrize("nq,n_lists,max_len,dim,n_probe,k,shared", [
        (1, 16, 64, 32, 1, 1, False),         # n_probe 1, k 1
        (1, 16, 64, 32, 16, 2048, False),     # n_probe = n_lists, k > rows
        (7, 24, 100, 40, 2, 64, True),        # shared lists, a dead query
        (32, 64, 512, 128, 12, 64, False),    # the serving shape
        (33, 48, 256, 64, 16, 300, True),
        (129, 32, 128, 128, 5, 17, False),
        (512, 64, 128, 32, 3, 256, True),
    ])
    def test_matches_plain(self, cuda, dtype, nq, n_lists, max_len, dim,
                           n_probe, k, shared):
        st = _list_state(cuda, nq, n_lists, max_len, dim, n_probe, dtype,
                         seed=nq * 31 + k, shared=shared)
        mod = pq_scan if dtype == "pq" else ivf_scan
        before = (mod.launches_by_kernel["list" if dtype == "pq" else dtype],
                  pq_scan.ivf_launches if dtype == "pq" else ivf_scan.launches)
        got = _list_scan(st, k, valid=st["valid"])
        pre = (pq_scan.pq_ivf_scan_topk if dtype == "pq" else
               ivf_scan.ivf_scan_topk)(st["q"], st["probe"], st["masked"],
                                       st["pack"], k=k)
        want = _list_plain(st, k)
        torch.cuda.synchronize()
        after = (mod.launches_by_kernel["list" if dtype == "pq" else dtype],
                 pq_scan.ivf_launches if dtype == "pq" else ivf_scan.launches)
        assert after == (before[0] + 2, before[1] + 2)
        assert torch.equal(got[0], pre[0]) and torch.equal(got[1], pre[1])
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])
        if dtype == "pq":
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        else:
            mir = _list_plain(st, k, mirror=True)
            fin = torch.isfinite(mir[0])
            assert torch.equal(torch.isfinite(got[0]), fin)
            scale = float(mir[0][fin].abs().max()) if fin.any() else 0.0
            assert float((got[0][fin] - mir[0][fin]).abs().max()
                         if fin.any() else 0.0) <= 1e-6 * max(scale, 1.0)
        ids = got[1]
        live = set(st["masked"][st["masked"] >= 0].tolist())
        assert set(ids[ids >= 0].tolist()) <= live     # no tombstone back
        if nq > 1 and n_probe <= 2:                     # query 1: dead lists
            assert (ids[1] == -1).all() and torch.isinf(got[0][1]).all()
        n_live = (st["masked"][st["probe"].long()] >= 0).sum(dim=(1, 2))
        assert torch.equal((ids == -1).sum(1), (k - n_live).clamp(min=0))

    @pytest.mark.parametrize("dtype", ["float32", "int8", "pq"])
    def test_cluster_sizes_give_the_same_bits(self, cuda, dtype):
        st = _list_state(cuda, 9, 40, 300, 64, 13, dtype, seed=5, shared=True)
        want = _list_scan(st, 100, valid=st["valid"])
        for r in (1, 2, 3, 4, 8):
            got = _list_scan(st, 100, valid=st["valid"], cluster=r)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def test_int8_fold_is_fold_int8_query(self, cuda):
        """One list whose row d is the one-hot code at dim d, its norms 0:
        row d scores -2 * (the kernel's folded query at d), so the kernel's
        fold is read back exactly and held equal to
        `core.quant.fold_int8_query` (halfway quotients included)."""
        from repro_torch.core import quant
        dim = 64
        g = torch.Generator(device=cuda).manual_seed(11)
        scale = torch.rand((dim,), generator=g, device=cuda) * 0.05 + 1e-3
        q = torch.randn((4, dim), generator=g, device=cuda) * 2.0
        q[0, :16] = (torch.arange(16, device=cuda) - 7.5) * scale[:16]
        q[1, :8] = 300.0 * scale[:8]                  # clamped to +-127
        pack = {"rows": torch.eye(dim, dtype=torch.int8, device=cuda),
                "sq": torch.zeros((1, dim), device=cuda), "scale": scale,
                "dim": dim, "max_len": dim, "block_m": dim, "dtype": "int8",
                "codebooks": None, "cent_sq": None}
        lists = torch.arange(dim, dtype=torch.int32, device=cuda)[None]
        probe = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
        s, i = ivf_scan.ivf_scan_topk(q, probe, lists, pack, k=dim)
        folded = torch.empty_like(q)
        folded.scatter_(1, i.long(), -s / 2)
        want = quant.fold_int8_query(q, scale)
        assert torch.equal(folded, want)

    def test_one_launch_a_call(self, cuda):
        st = _list_state(cuda, 32, 64, 512, 128, 12, "float32", seed=2)
        for dtype in ("float32", "int8", "pq"):
            if dtype != "float32":
                st = _list_state(cuda, 32, 64, 512, 128, 12, dtype, seed=2)
            lut = None
            if dtype == "pq":
                lut = pq_scan._lut(st["q"], st["pack"], None)
                fn = lambda: pq_scan.pq_ivf_scan_topk(
                    st["q"], st["probe"], st["lists"], st["pack"], k=256,
                    lut=lut, valid=st["valid"])
            else:
                fn = lambda: _list_scan(st, 64, valid=st["valid"])
            names = _kernel_names(fn)
            assert len(names) == 1 and "list_scan_kernel" in next(iter(names))
            assert next(iter(names.values())) == 3

    def test_rejections(self, cuda):
        st = _list_state(cuda, 2, 8, 32, 16, 3, "float32", seed=1)
        with pytest.raises(ValueError):
            _list_scan(st, ivf_scan.MAX_K + 1)
        with pytest.raises(ValueError):
            _list_scan(st, 5, cluster=ivf_scan.MAX_CLUSTER + 1)
        with pytest.raises(ValueError):
            _list_scan(st, 5, valid=st["valid"].to(torch.uint8))
        with pytest.raises(ValueError):
            _list_scan(st, 5, valid=st["valid"].cpu())


# (C, [(dim, k), ...], precomputed norms) of the serving ladders at the
# paper's schedule (d 128 -> 3584, k0 64): flat and IVF after stage 0, the
# quantized PQ pool (oversample 4)
LADDER_SCHEDULES = {
    "flat": (64, [(256, 32), (512, 16), (1024, 10), (2048, 10), (3584, 10)]),
    "ivf": (64, [(256, 32), (512, 16), (1024, 10), (2048, 10), (3584, 10)]),
    "quantized_pq": (256, [(256, 32), (512, 16), (1024, 10), (2048, 10),
                           (3584, 10)]),
}


def _ladder_inputs(dev, nq, c, d, n=4000, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    db = torch.randn((n, d), generator=g, device=dev)
    q = db[torch.randint(0, n, (nq,), generator=g, device=dev)] \
        + 0.5 * torch.randn((nq, d), generator=g, device=dev)
    cand = torch.argsort(torch.rand((nq, n), generator=g, device=dev),
                         dim=1)[:, :c].to(torch.int32).contiguous()
    valid = torch.rand((n,), generator=g, device=dev) > 0.1
    return q, db, cand, valid


@pytest.mark.cuda
class TestRescoreLadderOnCard:
    """The one-launch ladder against the plain steps chained on the same
    card tensors (tolerance as the file's: another float32 summation
    order, ids equal up to near-ties)."""

    @pytest.mark.parametrize("nq", [1, 8, 32, 33, 512])
    @pytest.mark.parametrize("schedule", sorted(LADDER_SCHEDULES))
    @pytest.mark.parametrize("with_sq", [True, False])
    def test_serving_schedules(self, cuda, nq, schedule, with_sq):
        c, stages = LADDER_SCHEDULES[schedule]
        q, db, cand, valid = _ladder_inputs(cuda, nq, c, 3584, seed=nq + c)
        if schedule == "ivf":                  # short lists: -1 padding
            cand[:, c // 2:] = -1
        dims = [dim for dim, _ in stages]
        sq = torch.stack([(db[:, :dd] ** 2).sum(1) for dd in dims], 1) \
            if with_sq else None
        cols = list(range(len(dims))) if with_sq else None
        before = dict(gather_rescore.launches_by_kernel)
        got = gather_rescore.rescore_ladder_topk(q, db, cand, stages,
                                                 sq_prefix=sq, sq_cols=cols,
                                                 valid=valid)
        assert gather_rescore.launches_by_kernel["ladder"] \
            == before["ladder"] + 1
        want = gather_rescore.rescore_ladder_topk_plain(
            q, db, cand, stages, sq_prefix=sq, sq_cols=cols, valid=valid)
        torch.cuda.synchronize()
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])

    def test_scalar_loads_unaligned_stride_and_dropping_dims(self, cuda):
        """Dims not a multiple of 4, a row stride of 257 floats and a base
        4 bytes off 16 (scalar loads), and a stage shallower than the one
        before (recomputed from 0)."""
        q, db, cand, valid = _ladder_inputs(cuda, 33, 48, 257, n=3000, seed=3)
        for qq, dd in ((q, db), (q[:, 1:], db[:, 1:])):
            for stages in ([(30, 24), (61, 12), (127, 5)],
                           [(128, 24), (64, 12), (256, 5)]):
                got = gather_rescore.rescore_ladder_topk(qq, dd, cand, stages,
                                                         valid=valid)
                want = gather_rescore.rescore_ladder_topk_plain(
                    qq, dd, cand, stages, valid=valid)
                torch.cuda.synchronize()
                assert_topk_close([x.cpu() for x in got],
                                  [x.cpu() for x in want])

    def test_invalid_padding_and_ties(self, cuda):
        """A query of -1 candidates, one whose rows are all deleted, -1
        slots mid-row, and duplicated rows that tie at every stage (the
        earlier rank wins, as the chained steps give)."""
        q, db, cand, valid = _ladder_inputs(cuda, 8, 64, 512, n=2000, seed=5)
        db[1000:2000] = db[0:1000]
        cand[0] = -1
        valid[cand[1].long()] = False
        cand[2, ::3] = -1
        cand[3] = torch.arange(32, device=cuda, dtype=torch.int32).repeat(2)
        cand[3, 32:] += 1000                   # rows equal to the first 32
        stages = [(64, 32), (128, 16), (512, 8)]
        got = gather_rescore.rescore_ladder_topk(q, db, cand, stages,
                                                 valid=valid)
        want = gather_rescore.rescore_ladder_topk_plain(q, db, cand, stages,
                                                        valid=valid)
        torch.cuda.synchronize()
        assert (got[1][:2] == -1).all() and torch.isinf(got[0][:2]).all()
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])
        assert torch.equal(got[1][3], want[1][3])

    def test_one_stage_is_the_step_and_bits_repeat(self, cuda):
        """A one-stage ladder is `gather_rescore_topk` (same bits, counted
        as a step); two launches, and every cluster size, give the same
        bits."""
        q, db, cand, valid = _ladder_inputs(cuda, 32, 64, 3584, seed=9)
        sq = (db[:, :1024] ** 2).sum(1)
        before = dict(gather_rescore.launches_by_kernel)
        a = gather_rescore.gather_rescore_topk(q, db, cand, dim=1024, k=16,
                                               sq_at_dim=sq, valid=valid)
        b = gather_rescore.rescore_ladder_topk(q, db, cand, [(1024, 16)],
                                               sq_prefix=sq[:, None],
                                               sq_cols=[0], valid=valid)
        assert gather_rescore.launches_by_kernel["step"] == before["step"] + 2
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        c, stages = LADDER_SCHEDULES["quantized_pq"]
        q, db, cand, valid = _ladder_inputs(cuda, 32, c, 3584, seed=10)
        outs = [gather_rescore.rescore_ladder_topk(q, db, cand, stages,
                                                   valid=valid, cluster=r)
                for r in (None, None, 1, 2, 3, 8)]
        for s, i in outs[1:]:
            assert torch.equal(s, outs[0][0]) and torch.equal(i, outs[0][1])

    def test_large_candidate_step(self, cuda):
        """A single step at MAX_C candidates over a dim of two chunks (the
        partial buffer then runs in waves)."""
        q, db, cand, valid = _ladder_inputs(
            cuda, 4, gather_rescore.MAX_C, 1024, n=20_000, seed=12)
        got = gather_rescore.gather_rescore_topk(q, db, cand, dim=1000, k=300,
                                                 valid=valid)
        want = gather_rescore.gather_rescore_topk_plain(q, db, cand, dim=1000,
                                                        k=300, valid=valid)
        torch.cuda.synchronize()
        assert_topk_close([x.cpu() for x in got], [x.cpu() for x in want])
        with pytest.raises(ValueError):
            gather_rescore.rescore_ladder_topk(q, db, cand,
                                               [(64, 10), (128, 11)])


def _pq_case(dev, nq, n, m, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.randn((nq, m, 256), generator=g, device=dev)
    codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.arange(n, device=dev, dtype=torch.int32)
    ids[torch.rand((n,), generator=g, device=dev) < 0.2] = -1
    return lut, codes, ids


@pytest.mark.cuda
class TestPqTileScanOnCard:
    """The query-tiled flat PQ scan: scores bitwise equal to the plain
    version (each query's sum in m order) and therefore ids equal too
    (ties by row)."""

    @pytest.mark.parametrize("nq", [1, 5, 8, 32, 33, 64])
    @pytest.mark.parametrize("m", [3, 4, 16, 32, 64])
    def test_bitwise_equal_to_plain(self, cuda, nq, m):
        lut, codes, ids = _pq_case(cuda, nq, 20_000, m, seed=nq * 100 + m)
        for k in (1, 64, 256, 2048):
            got = pq_scan.pq_scan_topk(lut, codes, ids, k=k)
            want = pq_scan.pq_scan_topk_plain(lut, codes, ids, k=k)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (k, pq_scan.tile_size(
                nq, m, 256, k))
            assert torch.equal(got[1], want[1])

    def test_tiles_edges_and_plan(self, cuda):
        """Every tile size gives the same bits; N < k; all ids -1; a code
        block 1 byte off 16 (byte staging); the plan's shared memory is the
        source's."""
        lut, codes, ids = _pq_case(cuda, 13, 9000, 16, seed=4)
        want = pq_scan.pq_scan_topk_plain(lut, codes, ids, k=256)
        for tile in pq_scan.TILES:
            got = pq_scan.pq_scan_topk(lut, codes, ids, k=256, tile=tile)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        small = pq_scan.pq_scan_topk(lut, codes[:100], ids[:100], k=150)
        want = pq_scan.pq_scan_topk_plain(lut, codes[:100], ids[:100], k=150)
        assert torch.equal(small[0], want[0]) and torch.equal(small[1], want[1])
        s, i = pq_scan.pq_scan_topk(lut, codes, torch.full_like(ids, -1), k=64)
        assert (i == -1).all() and torch.isinf(s).all()
        raw = torch.empty(9000 * 3 + 1, dtype=torch.uint8, device=cuda)
        odd = raw[1:].view(9000, 3)
        odd.copy_(codes[:, :3])
        got = pq_scan.pq_scan_topk(lut[:, :3].contiguous(), odd, ids, k=64)
        want = pq_scan.pq_scan_topk_plain(lut[:, :3], codes[:, :3], ids, k=64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        lib = pq_scan._kernel()[0]
        fn = lib.pq_tile_smem_bytes
        import ctypes
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
        for t, m, kp in ((8, 16, 256), (4, 32, 2048), (1, 3, 1), (2, 64, 64)):
            assert fn(t, m, 256, kp) == pq_scan.tile_smem_bytes(t, m, 256, kp)


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
        before = (distance_topk.launches, gather_rescore.launches,
                  gather_rescore.launches_by_kernel["ladder"])
        s, i = eng.search(q.cpu().numpy())
        assert distance_topk.launches > before[0]
        assert gather_rescore.launches > before[1]
        # one ladder launch per dispatch, as one stage-0 launch
        assert gather_rescore.launches_by_kernel["ladder"] - before[2] \
            == distance_topk.launches - before[0]
        st = eng.store
        ws, wi = progressive_search_plain(q, st.db, eng.sched,
                                          sq_prefix=st.sq_prefix,
                                          index_dims=eng.dims, valid=st.valid)
        assert_topk_close((s, i), (ws[:, :5].cpu(), wi[:, :5].cpu()))
        assert not np.isin(i, gone).any()

    @pytest.mark.parametrize("block,counter", [
        (IVFConfig(n_lists=32, n_probe=8), "ivf_scan.launches"),
        (IVFConfig(n_lists=32, n_probe=8, stage0_dtype="int8"),
         "ivf_scan.launches"),
        (IVFConfig(n_lists=32, n_probe=8, stage0_dtype="pq"),
         "pq_scan.ivf_launches"),
        (QuantizedConfig(codec="pq"), "pq_scan.flat_launches"),
        (QuantizedConfig(codec="int8"), "gather_rescore.launches"),
    ])
    def test_backend_serves_through_kernels(self, cuda, block, counter):
        mod, attr = counter.split(".")
        mod = {"ivf_scan": ivf_scan, "pq_scan": pq_scan,
               "gather_rescore": gather_rescore}[mod]
        g = torch.Generator(device=cuda).manual_seed(3)
        docs = torch.randn((3000, 64), generator=g, device=cuda)
        eng = RetrievalEngine(config=EngineConfig(
            d_emb=64, d_start=16, k0=32, final_k=5, buckets=(1, 8),
            capacity=4096, backend=block))
        eng.add_docs(docs)
        gone = np.arange(0, 3000, 7)
        eng.delete_docs(gone)
        q = docs[:20] + 0.1 * torch.randn((20, 64), generator=g, device=cuda)
        before = getattr(mod, attr)
        s, i = eng.search(q.cpu().numpy())
        assert getattr(mod, attr) > before
        if isinstance(block, IVFConfig):       # one stage-0 launch a dispatch
            assert getattr(mod, attr) - before == len(eng.policy.plan(20))
        assert not np.isin(i, gone).any()
        st = eng.store
        ws, wi = eng.backend.search_plain(
            q, eng.index_state, st.db, st.valid, sq_prefix=st.sq_prefix,
            n_total=st.size, k=5)
        assert_topk_close((s, i), (ws.cpu(), wi.cpu()))
        new = torch.randn((4, 64), generator=g, device=cuda) * 3
        ids = eng.add_docs(new)
        _, i = eng.search(new.cpu().numpy())
        np.testing.assert_array_equal(i[:, 0], ids)


# (b, hq, hkv, sq, skv, dh, causal, window): the JAX package's
# TestFlashAttention cases, decode steps, every head dim, a group of 5
# (rows not a multiple of the group), and rows with nothing to attend
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, True, None),
    (2, 4, 2, 64, 64, 32, False, None),     # GQA
    (1, 2, 2, 50, 70, 32, True, None),      # uneven + decode-aligned
    (1, 2, 2, 96, 96, 64, True, 16),        # sliding window
    (1, 4, 1, 1, 128, 64, False, None),     # single-token decode (MQA)
    (1, 2, 2, 33, 65, 16, True, 8),         # padding both axes + window
    (2, 32, 8, 1, 300, 128, True, None),    # decode, Mistral's group of 4
    (1, 8, 2, 200, 200, 128, True, None),   # prefill, several tiles
    (1, 10, 2, 70, 90, 256, True, 40),      # group of 5, window
    (1, 4, 2, 40, 24, 32, True, None),      # 16 rows with nothing to attend
    (1, 4, 4, 17, 0, 16, False, None),      # no keys at all
]


@pytest.mark.cuda
class TestFlashAttentionOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", FLASH_CASES)
    def test_matches_plain(self, cuda, dtype, b, hq, hkv, sq, skv, dh, causal,
                           window):
        dt = getattr(torch, dtype)
        g = torch.Generator(device=cuda).manual_seed(sq * 31 + skv)
        q = torch.randn((b, hq, sq, dh), generator=g, device=cuda).to(dt)
        k = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(dt)
        v = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(dt)
        before = flash_attention.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                     window=window)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert got.dtype == dt and got.shape == (b, hq, sq, dh)
        assert torch.isfinite(got).all()
        tol = 2e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if causal and sq > skv:
            assert not got[:, :, :sq - skv].any()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_strided_cache_prefix(self, cuda, dtype):
        """Decode reads k_cache[:, :, :pos + 1] in place (a strided view),
        and a non-contiguous v (prefill's transposed projection)."""
        dt = getattr(torch, dtype)
        g = torch.Generator(device=cuda).manual_seed(3)
        kc = torch.randn((2, 8, 544, 128), generator=g, device=cuda).to(dt)
        vc = torch.randn((2, 8, 544, 128), generator=g, device=cuda).to(dt)
        q = torch.randn((2, 32, 1, 128), generator=g, device=cuda).to(dt)
        tol = 2e-4 if dtype == "float32" else 2e-2
        for pos in (0, 63, 64, 300, 543):
            kp, vp = kc[:, :, :pos + 1], vc[:, :, :pos + 1]
            got = ops.flash_attention(q, kp, vp, causal=True)
            want = flash_attention.flash_attention_plain(
                q, kp.contiguous(), vp.contiguous(), causal=True)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
        x = torch.randn((2, 70, 4, 32), generator=g, device=cuda).to(dt)
        vt = x.transpose(1, 2)                        # (2, 4, 70, 32) view
        got = ops.flash_attention(vt, vt, vt, causal=True)
        want = flash_attention.flash_attention_plain(
            vt.contiguous(), vt.contiguous(), vt.contiguous(), causal=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)

    def test_rejections(self, cuda):
        q = torch.zeros((1, 4, 8, 48), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(q, q, q)
        q = torch.zeros((1, 6, 8, 32), device=cuda)
        k = torch.zeros((1, 4, 8, 32), device=cuda)
        with pytest.raises(ValueError, match="multiple"):
            ops.flash_attention(q, k, k)
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            ops.flash_attention(q.half(), q.half(), q.half())


FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}

# (b, hq, hkv, sq, skv, dh, causal, window, v a transposed view): the
# tensor-core prefill kernel (bf16, dh 64 / 128, more than 64 rows) at
# groups of 1, 3, 4, 8 and 64, tiles cut short on both axes
WGMMA_CASES = [
    (2, 32, 8, 200, 200, 128, True, None, True),   # Mistral's group of 4
    (1, 8, 8, 130, 130, 64, True, None, False),    # group 1: 128 positions
    (1, 16, 2, 70, 70, 128, True, 33, False),      # group 8, window
    (1, 64, 1, 9, 300, 64, True, None, False),     # group 64, sq < skv
    (1, 8, 2, 100, 60, 128, True, None, False),    # 40 positions see nothing
    (1, 4, 2, 150, 150, 64, False, None, True),    # no mask
    (2, 12, 4, 77, 333, 128, True, 100, False),    # group 3: 126-row tiles
    (1, 32, 8, 512, 512, 128, True, None, True),   # the RAG prefill, batch 1
    # grids the (batch, kv head) pairs alone fill: the rounds order
    (2, 80, 80, 300, 300, 64, True, None, True),   # 160 pairs, 3 q tiles
    (1, 140, 140, 600, 600, 128, True, 200, False),  # 5 tiles: idle slots
    (4, 80, 40, 200, 200, 128, False, None, False),  # group 2, 160 pairs
]

# (b, hq, hkv, sq, skv, dh, causal, window): the split-kv decode kernel
# (sq * hq / hkv <= 64), bf16 and float32
SPLITKV_CASES = [
    (2, 32, 8, 1, 543, 128, True, None),     # the RAG decode step, batch 2
    (1, 8, 8, 1, 100, 64, True, None),       # group 1
    (1, 16, 2, 1, 700, 128, True, 130),      # group 8: splits 0-8 outside
    (1, 64, 1, 1, 257, 64, True, None),      # group 64
    (1, 8, 2, 16, 90, 128, True, None),      # 16 positions x 4 heads
    (1, 4, 2, 30, 20, 64, True, None),       # 10 positions see nothing
    (3, 32, 8, 1, 5000, 128, True, None),    # 6 splits of 896 keys
    (1, 4, 1, 1, 128, 256, False, None),     # dh 256
    (2, 8, 2, 1, 77, 16, True, 5),           # dh 16, a window of 5
]


def _flash_on_card(q, k, v, causal, window, kind):
    """Kernel vs plain version within FLASH_TOL; exactly one launch, of
    ``kind``; rows with nothing to attend are 0."""
    before = dict(flash_attention.launches_by_kernel)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
    torch.cuda.synchronize()
    moved = {n: flash_attention.launches_by_kernel[n] - before[n]
             for n in before}
    assert moved == {**dict.fromkeys(before, 0), kind: 1}
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    sq, skv = q.shape[2], k.shape[2]
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    assert not got[:, :, ~keep.any(dim=1)].any()


@pytest.mark.cuda
class TestFlashKernelsOnCard:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window,vt",
                             WGMMA_CASES)
    def test_prefill_wgmma(self, cuda, b, hq, hkv, sq, skv, dh, causal,
                           window, vt):
        g = torch.Generator(device=cuda).manual_seed(sq * 7 + skv)
        bf = torch.bfloat16
        q = torch.randn((b, hq, sq, dh), generator=g, device=cuda).to(bf)
        k = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(bf)
        if vt:      # prefill's v: the (B, S, Hkv, Dh) projection, transposed
            v = torch.randn((b, skv, hkv, dh), generator=g,
                            device=cuda).to(bf).transpose(1, 2)
        else:
            v = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(bf)
        _flash_on_card(q, k, v, causal, window, "prefill_wgmma")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window",
                             SPLITKV_CASES)
    def test_decode_splitkv(self, cuda, dtype, b, hq, hkv, sq, skv, dh,
                            causal, window):
        g = torch.Generator(device=cuda).manual_seed(sq * 5 + skv)
        q = torch.randn((b, hq, sq, dh), generator=g, device=cuda).to(dtype)
        k = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(dtype)
        v = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(dtype)
        _flash_on_card(q, k, v, causal, window, "decode_splitkv")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_decode_cache_prefix(self, cuda, dtype):
        """The decode step reads k_cache[:, :, :pos + 1] in place at
        positions 0, 64 and 543 of a 544 cache, and a misaligned view
        (scalar loads); calls back to back share the kernel's counters."""
        g = torch.Generator(device=cuda).manual_seed(4)
        kc = torch.randn((8, 8, 544, 128), generator=g, device=cuda).to(dtype)
        vc = torch.randn((8, 8, 544, 128), generator=g, device=cuda).to(dtype)
        q = torch.randn((8, 32, 1, 128), generator=g, device=cuda).to(dtype)
        for pos in (0, 64, 543):
            _flash_on_card(q, kc[:, :, :pos + 1], vc[:, :, :pos + 1], True,
                           None, "decode_splitkv")
        x = torch.randn((1, 4, 41, 33), generator=g, device=cuda).to(dtype)
        k1 = x[..., 1:]                          # rows 33 elements apart
        _flash_on_card(q[:1, :8, :, :32], k1, k1, True, None,
                       "decode_splitkv")

    def test_prefill_rejects_misaligned(self, cuda):
        x = torch.zeros((1, 8, 100, 65), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(x[..., 1:], x[..., 1:], x[..., 1:])


@pytest.mark.cuda
class TestLMOnCard:
    def test_decode_step_matches_cpu(self, cuda):
        """The smoke config on the card (kernel path) against the same
        weights on the CPU (plain path): prefill, then four decode steps."""
        lm_gpu = LM.init_lm(SMOKE_CONFIG, seed=3, device=cuda)
        lm_cpu = LM.init_lm(SMOKE_CONFIG, seed=3, device="cpu")
        lm_cpu.load_state_dict({k: v.cpu() for k, v in
                                lm_gpu.state_dict().items()})
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(1, SMOKE_CONFIG.vocab, (3, 20), generator=g)
        before = flash_attention.launches
        lg, cg = LM.prefill(lm_gpu, toks.to(cuda))
        lc, cc = LM.prefill(lm_cpu, toks)
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-4, atol=2e-4)
        cg = LM.prefill_to_decode_cache(SMOKE_CONFIG, cg, 20, 24)
        cc = LM.prefill_to_decode_cache(SMOKE_CONFIG, cc, 20, 24)
        tok = lc.argmax(-1, keepdim=True)
        for i in range(4):
            lg, cg = LM.decode_step(lm_gpu, cg, tok.to(cuda), 20 + i)
            lc, cc = LM.decode_step(lm_cpu, cc, tok, 20 + i)
            torch.testing.assert_close(lg.cpu(), lc, rtol=2e-4, atol=2e-4)
            tok = lc.argmax(-1, keepdim=True)
        torch.testing.assert_close(cg["k"].cpu(), cc["k"], rtol=2e-4,
                                   atol=2e-4)
        assert flash_attention.launches == before + 2 * 5


# the other LM families' attention shapes (Gemma3: 8 / 4 heads of 256, a
# window; MLA: q / k of 192 and v of 128 padded to 256), bf16 on the
# tensor-core prefill
FAMILY_FLASH_CASES = [
    (1, 8, 4, 300, 300, 256, True, 100),     # windowed prefill, dh 256
    (2, 8, 4, 1100, 1100, 256, True, 1024),  # Gemma3's window, cut short
    (2, 8, 4, 700, 700, 256, True, None),    # a global layer's prefill
]


# (b, hq, hkv, sq, skv, causal, window, v a transposed view): bf16 at head
# dim 256 on ``prefill_wgmma`` (64-key tiles, one Q stage, the output
# stored from registers) at groups 1, 2, 4 and 8; causal, windowed and
# neither; Sq != Skv both ways; tails off the 64-key and 128-row tiles
DH256_WGMMA_CASES = [
    (1, 4, 4, 130, 130, True, None, False),     # group 1
    (2, 8, 4, 300, 300, True, 100, True),       # Gemma3's group 2, window
    (1, 16, 4, 77, 333, False, 100, False),     # group 4, window alone
    (1, 16, 2, 70, 45, True, None, False),      # group 8, 25 rows see nothing
    (1, 8, 2, 200, 131, False, None, True),     # no mask, Sq > Skv
    (1, 4, 2, 1000, 1234, False, 300, False),   # chip_smoke's dh-256 row
    (2, 8, 4, 2048, 2048, True, None, True),    # a Gemma3 global layer
    (2, 128, 128, 512, 512, True, None, False),  # 256 pairs: rounds order
    (1, 264, 132, 100, 150, False, 50, True),   # 132 pairs of group 2
]


@pytest.mark.cuda
class TestPrefillWgmmaDh256OnCard:
    """The tensor-core prefill at head dim 256 against the plain version
    within ``FLASH_TOL``, one ``prefill_wgmma`` launch a call."""

    @pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window,vt",
                             DH256_WGMMA_CASES)
    def test_matches_plain(self, cuda, b, hq, hkv, sq, skv, causal, window,
                           vt):
        g = torch.Generator(device=cuda).manual_seed(sq * 3 + skv + hq)
        bf = torch.bfloat16
        q = torch.randn((b, hq, sq, 256), generator=g, device=cuda).to(bf)
        k = torch.randn((b, hkv, skv, 256), generator=g, device=cuda).to(bf)
        if vt:      # prefill's v: the (B, S, Hkv, Dh) projection, transposed
            v = torch.randn((b, skv, hkv, 256), generator=g,
                            device=cuda).to(bf).transpose(1, 2)
        else:
            v = torch.randn((b, hkv, skv, 256), generator=g,
                            device=cuda).to(bf)
        _flash_on_card(q, k, v, causal, window, "prefill_wgmma")

    @pytest.mark.parametrize("dh", [64, 128, 256])
    def test_built_plan_is_prefill_plan(self, cuda, dh):
        """The library reports the tiles and shared memory it was built
        with (``flash_prefill_plan``), and they are `prefill_plan`'s."""
        assert flash_attention.built_prefill_plan(dh) == \
            flash_attention.prefill_plan(dh)

    def test_mla_padded_tensors(self, cuda):
        """MLA's padded call (group 1, 16 heads, q / k 192 and v 128
        zero-padded to 256, the scale of 192) against the plain version on
        the padded tensors and, cut to 128 columns, on the unpadded ones;
        the padded output columns are 0."""
        import torch.nn.functional as F
        g = torch.Generator(device=cuda).manual_seed(8)
        bf = torch.bfloat16
        q = torch.randn((2, 16, 333, 192), generator=g, device=cuda).to(bf)
        k = torch.randn((2, 16, 333, 192), generator=g, device=cuda).to(bf)
        v = torch.randn((2, 16, 333, 128), generator=g, device=cuda).to(bf)
        qp, kp, vp = F.pad(q, (0, 64)), F.pad(k, (0, 64)), F.pad(v, (0, 128))
        before = flash_attention.launches_by_kernel["prefill_wgmma"]
        got = flash_attention.flash_attention(qp, kp, vp, causal=True,
                                              scale=192 ** -0.5)
        assert flash_attention.launches_by_kernel["prefill_wgmma"] == \
            before + 1
        tol = FLASH_TOL[bf]
        want = flash_attention.flash_attention_plain(qp, kp, vp, causal=True,
                                                     scale=192 ** -0.5)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert not got[..., 128:].any()
        want = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                     scale=192 ** -0.5)
        torch.testing.assert_close(got[..., :128].float(), want.float(),
                                   rtol=tol, atol=tol)

    @pytest.mark.parametrize("sq,skv,causal,window", [
        (300, 300, True, 100), (70, 45, True, None), (77, 333, False, 100)])
    def test_lse_matches_plain(self, cuda, sq, skv, causal, window):
        """The route's log-sum-exp within 1e-5 of max(1, |plain|), -inf on
        the same rows; the output as without it."""
        g = torch.Generator(device=cuda).manual_seed(sq + skv)
        bf = torch.bfloat16
        q = torch.randn((2, 8, sq, 256), generator=g, device=cuda).to(bf)
        k = torch.randn((2, 4, skv, 256), generator=g, device=cuda).to(bf)
        v = torch.randn((2, 4, skv, 256), generator=g, device=cuda).to(bf)
        before = flash_attention.launches_by_kernel["prefill_wgmma"]
        out, lse = flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, return_lse=True)
        assert flash_attention.launches_by_kernel["prefill_wgmma"] == \
            before + 1
        _, want = flash_attention.flash_attention_plain(
            q, k, v, causal=causal, window=window, return_lse=True)
        live = torch.isfinite(want)
        assert torch.equal(torch.isfinite(lse), live)
        assert torch.equal(lse[~live], want[~live])
        err = ((lse - want).abs() / want.abs().clamp(min=1.0))[live]
        assert float(err.max()) <= 1e-5
        assert torch.equal(out, flash_attention.flash_attention(
            q, k, v, causal=causal, window=window))

    def test_two_calls_bit_equal(self, cuda):
        """No atomics, a fixed order: Gemma3's global call twice gives the
        same bits, one launch each."""
        g = torch.Generator(device=cuda).manual_seed(2)
        bf = torch.bfloat16
        q = torch.randn((8, 8, 2048, 256), generator=g, device=cuda).to(bf)
        k = torch.randn((8, 4, 2048, 256), generator=g, device=cuda).to(bf)
        v = torch.randn((8, 2048, 4, 256), generator=g,
                        device=cuda).to(bf).transpose(1, 2)
        before = dict(flash_attention.launches_by_kernel)
        first = flash_attention.flash_attention(q, k, v, causal=True)
        second = flash_attention.flash_attention(q, k, v, causal=True)
        assert torch.equal(first, second)
        after = flash_attention.launches_by_kernel
        assert {n: after[n] - before[n] for n in after} == {
            "prefill_wgmma": 2, "decode_splitkv": 0, "fma": 0}

    def test_float32_stays_on_fma(self, cuda):
        """float32 at head dim 256 keeps the FMA kernel (tensor cores
        would mean TF32)."""
        g = torch.Generator(device=cuda).manual_seed(3)
        q = torch.randn((1, 8, 150, 256), generator=g, device=cuda)
        k = torch.randn((1, 4, 150, 256), generator=g, device=cuda)
        _flash_on_card(q, k, k, True, 64, "fma")


@pytest.mark.cuda
class TestLMFamiliesOnCard:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window",
                             FAMILY_FLASH_CASES)
    def test_bf16_prefill_dh256(self, cuda, b, hq, hkv, sq, skv, dh, causal,
                                window):
        g = torch.Generator(device=cuda).manual_seed(sq)
        bf = torch.bfloat16
        q = torch.randn((b, hq, sq, dh), generator=g, device=cuda).to(bf)
        k = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(bf)
        v = torch.randn((b, skv, hkv, dh), generator=g,
                        device=cuda).to(bf).transpose(1, 2)
        _flash_on_card(q, k, v, causal, window, "prefill_wgmma")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ring_decode_across_the_wrap(self, cuda, dtype):
        """``mha_decode(ring=True)`` on the card (one ``decode_splitkv``
        launch a step, over the ring's filled prefix, then all of it)
        against the same steps on the CPU, before, at and after the wrap."""
        from repro_torch.layers import attention as A
        gen = torch.Generator().manual_seed(5)
        p = A.attn_init(gen, 256, 8, 4, 256, dtype)
        p_gpu = A.Attention(*(w.to(cuda) for w in (p.wq, p.wk, p.wv, p.wo)))
        kc = torch.zeros((2, 4, 48, 256), dtype=dtype)
        vc = torch.zeros_like(kc)
        kg, vg = kc.to(cuda), vc.to(cuda)
        tol = FLASH_TOL[dtype]
        for pos in range(60):
            x = torch.randn((2, 1, 256), generator=gen).to(dtype)
            before = dict(flash_attention.launches_by_kernel)
            got, _, _ = A.mha_decode(p_gpu, x.to(cuda), kg, vg, pos=pos,
                                     n_heads=8, n_kv_heads=4, d_head=256,
                                     window=48, ring=True)
            want, _, _ = A.mha_decode(p, x, kc, vc, pos=pos, n_heads=8,
                                      n_kv_heads=4, d_head=256, window=48,
                                      ring=True)
            assert flash_attention.launches_by_kernel["decode_splitkv"] \
                == before["decode_splitkv"] + 1
            torch.testing.assert_close(got.float().cpu(), want.float(),
                                       rtol=tol, atol=tol)
        torch.testing.assert_close(kg.float().cpu(), kc.float(), rtol=tol,
                                   atol=tol)

    def test_mla_padded_prefill(self, cuda):
        """MLA's prefill call — q / k of 192 and v of 128 zero-padded to
        256, the scale of 192 — against the plain attention on the
        unpadded tensors, and ``mla_forward`` on the card against the
        CPU."""
        import torch.nn.functional as F
        from repro_torch.configs.base import MLAConfig
        from repro_torch.layers import mla as M
        g = torch.Generator(device=cuda).manual_seed(6)
        bf = torch.bfloat16
        q = torch.randn((2, 16, 300, 192), generator=g, device=cuda).to(bf)
        k = torch.randn((2, 16, 300, 192), generator=g, device=cuda).to(bf)
        v = torch.randn((2, 16, 300, 128), generator=g, device=cuda).to(bf)
        before = dict(flash_attention.launches_by_kernel)
        got = ops.flash_attention(F.pad(q, (0, 64)), F.pad(k, (0, 64)),
                                  F.pad(v, (0, 128)), causal=True,
                                  scale=192 ** -0.5)[..., :128]
        want = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                     scale=192 ** -0.5)
        assert flash_attention.launches_by_kernel["prefill_wgmma"] == \
            before["prefill_wgmma"] + 1
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        cfg = MLAConfig(q_lora_rank=48, kv_lora_rank=32, d_nope=32,
                        d_rope=16, d_v=32)
        p = M.mla_init(torch.Generator().manual_seed(2), 96, 4, cfg,
                       torch.float32)
        p_gpu = M.MLA(**{n: w.to(cuda) for n, w in p.named_parameters()})
        x = torch.randn((2, 90, 96), generator=torch.Generator().manual_seed(3))
        got = M.mla_forward(p_gpu, x.to(cuda), n_heads=4, cfg=cfg)
        want = M.mla_forward(p, x, n_heads=4, cfg=cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("cf", [0.5, 1.25])
    def test_moe_apply_matches_cpu(self, cuda, cf):
        """``moe_apply`` on the card against the CPU: routing, capacity
        drops and output (float32 weights)."""
        from repro_torch.configs.base import MoEConfig
        from repro_torch.layers import moe as E
        cfg = MoEConfig(n_experts=16, top_k=4, d_ff_expert=64,
                        n_shared_experts=1, d_ff_shared=32,
                        capacity_factor=cf)
        p = E.moe_init(torch.Generator().manual_seed(4), 128, cfg, "swiglu",
                       torch.float32)
        p_gpu = E.MoE(p.router.to(cuda), p.w_in.to(cuda), p.w_out.to(cuda),
                      p.w_gate.to(cuda),
                      type(p.shared)(p.shared.w_in.to(cuda),
                                     p.shared.w_out.to(cuda),
                                     p.shared.w_gate.to(cuda)))
        x = torch.randn((3, 100, 128),
                        generator=torch.Generator().manual_seed(5))
        got, aux = E.moe_apply(p_gpu, x.to(cuda), cfg, "swiglu")
        want, waux = E.moe_apply(p, x, cfg, "swiglu")
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(aux.cpu(), waux, rtol=1e-5, atol=1e-7)
        x2 = x.reshape(-1, 128)
        logits = x2 @ p.router
        _, ig, *_ = E._dispatch_local(x2.to(cuda), logits.to(cuda), cfg)
        _, ic, *_ = E._dispatch_local(x2, logits, cfg)
        for a, b in zip(ig[:5], ic[:5]):     # experts, order, slots, drops
            assert torch.equal(a.cpu(), b)

    @pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-4b",
                                      "qwen3-moe-235b-a22b",
                                      "deepseek-v2-236b"])
    def test_family_decode_matches_cpu(self, cuda, arch):
        """Each family's smoke config on the card (kernel path) against the
        same weights on the CPU (plain path): prefill into the decode
        layout (Gemma3's rings of 16 from a 20-token prompt), then four
        decode steps."""
        cfg = get_arch(arch).SMOKE_CONFIG
        lm_gpu = LM.init_lm(cfg, seed=3, device=cuda)
        lm_cpu = LM.init_lm(cfg, seed=3, device="cpu")
        lm_cpu.load_state_dict({k: v.cpu() for k, v in
                                lm_gpu.state_dict().items()})
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(1, cfg.vocab, (3, 20), generator=g)
        lg, cg = LM.prefill(lm_gpu, toks.to(cuda), decode_len=24)
        lc, cc = LM.prefill(lm_cpu, toks, decode_len=24)
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-4, atol=2e-4)
        tok = lc.argmax(-1, keepdim=True)
        for i in range(4):
            lg, cg = LM.decode_step(lm_gpu, cg, tok.to(cuda), 20 + i)
            lc, cc = LM.decode_step(lm_cpu, cc, tok, 20 + i)
            torch.testing.assert_close(lg.cpu(), lc, rtol=2e-4, atol=2e-4)
            tok = lc.argmax(-1, keepdim=True)
        for name in cc:
            torch.testing.assert_close(cg[name].cpu(), cc[name], rtol=2e-4,
                                       atol=2e-4)


def _bag_case(dev, f, v, d, b, l, dtype, seed):
    """Stacked tables and (B, F, L) ids with padding, an all-padding bag and
    an id beyond the vocabulary."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tabs = torch.randn((f, v, d), generator=g, device=dev).to(dtype)
    ids = torch.randint(-1, v, (b, f, l), generator=g, device=dev,
                        dtype=torch.int32)
    ids[0, 0] = -1                                    # all padding
    ids[-1, -1, 0] = v + 3                            # reads row V - 1
    return tabs, ids


def _bag_grid_size(f_max, bag_len, d):
    """(F, B) of the grid's large case: 26 fields where the plain version's
    gathered (B, F, L, D) float32 rows stay under 256 MB, else 2; B at most
    65,536."""
    budget = 1 << 26
    for f in (f_max, 2):
        b = min(65_536, budget // (f * max(bag_len, 1) * d))
        if b >= 512 or f == 2:
            return f, b
    raise AssertionError


@pytest.mark.cuda
class TestEmbeddingBagOnCard:
    @pytest.mark.parametrize("f,v,d,b,l", [
        (4, 1000, 256, 64, 1),        # the two-tower shape (one id a bag)
        (26, 500, 64, 33, 1),         # the DLRM shape
        (3, 300, 16, 20, 8),          # AutoInt's width, padded bags
        (2, 200, 64, 7, 100),         # long bags
        (5, 97, 18, 11, 3),           # D not a multiple of 4: scalar loads
    ])
    @pytest.mark.parametrize("mode", ["sum", "mean"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_matches_plain(self, cuda, f, v, d, b, l, mode, dtype):
        tabs, ids = _bag_case(cuda, f, v, d, b, l, dtype, f * v + l)
        before = embedding_bag.launches
        got = ops.embedding_bag(tabs, ids, mode=mode)
        assert embedding_bag.launches == before + 1
        want = embedding_bag.embedding_bag_plain(tabs, ids, mode=mode)
        torch.cuda.synchronize()
        assert got.shape == (b, f, d) and got.dtype == torch.float32
        assert torch.equal(got, want)
        assert not got[0, 0].any()

    @pytest.mark.parametrize("mode", ["sum", "mean"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [8, 16, 18, 64, 256])
    @pytest.mark.parametrize("l", [1, 2, 3, 8, 100])
    def test_grid_equals_plain(self, cuda, l, d, dtype, mode):
        """torch.equal to the plain version (both add the rows in id order
        from +0.0) at F 1-26 and B 1-65,536: one bag, a few ragged tiles,
        and enough tiles that each CTA of the persistent grid walks
        several; 30% padding, all-padding bags, ids past V.  The call takes
        the route `route` names, in one launch."""
        es = torch.tensor([], dtype=dtype).element_size()
        kind = "vec16" if d * es % 16 == 0 else "scalar"
        v = 1000
        g = torch.Generator(device=cuda).manual_seed(l * 1000 + d)
        for f, b in ((1, 1), (3, 257), _bag_grid_size(26, l, d)):
            tabs = torch.randn((f, v, d), generator=g, device=cuda).to(dtype)
            ids = torch.randint(0, v, (b, f, l), generator=g, device=cuda,
                                dtype=torch.int32)
            ids[torch.rand((b, f, l), generator=g, device=cuda) < 0.3] = -1
            ids[-1, -1, 0] = v + 5                           # row V - 1
            ids[b // 2, 0] = -1                              # all padding
            assert embedding_bag.route(tabs, ids) == kind
            before = dict(embedding_bag.launches_by_kernel)
            got = embedding_bag.embedding_bag(tabs, ids, mode=mode)
            after = embedding_bag.launches_by_kernel
            assert after[kind] == before[kind] + 1 and sum(after.values()) \
                == sum(before.values()) + 1
            want = embedding_bag.embedding_bag_plain(tabs, ids, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (f, b)
            assert not got[b // 2, 0].any()
            del tabs, ids, got, want
        torch.cuda.empty_cache()

    @pytest.mark.parametrize("l", [1, 3, 100])
    @pytest.mark.parametrize("f,d", [(26, 64), (4, 256), (3, 8)])
    def test_every_walk_equals_plain(self, cuda, monkeypatch, f, d, l):
        """The vec16 grid takes the fields in passes (`tile_plan`'s
        ``fields_per_pass``: 1 is field by field, F memory order, a pass
        count that does not divide F leaves a short last pass); every
        choice gives the plain version's bits."""
        tabs, ids = _bag_case(cuda, f, 500, d, 700, l, torch.float32, f + d)
        want = embedding_bag.embedding_bag_plain(tabs, ids, mode="mean")
        planned = embedding_bag._plan
        for fp in sorted({1, 2, 4, 5, f}):
            fp = min(fp, f)
            monkeypatch.setattr(embedding_bag, "_plan", lambda *a, fp=fp: {
                **planned(*a), "fields_per_pass": fp})
            got = embedding_bag.embedding_bag(tabs, ids, mode="mean")
            torch.cuda.synchronize()
            assert torch.equal(got, want), fp

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_negative_zero_rows_give_positive_zero(self, cuda, dtype):
        tabs, ids = _bag_case(cuda, 3, 50, 64, 40, 1, dtype, 9)
        tabs[1, 7] = -0.0
        tabs[2, 3, ::2] = -0.0
        ids[:, 1, 0] = 7
        ids[:, 2, 0] = 3
        strided = torch.empty((3 * 50 * 65,), dtype=dtype, device=cuda)\
            .as_strided(tabs.shape, (50 * 65, 65, 1))
        strided.copy_(tabs)
        three = torch.cat([ids, ids, torch.full_like(ids, -1)], dim=2)
        for kind, t in (("vec16", tabs), ("scalar", strided)):
            assert embedding_bag.route(t, ids) == kind
            for bag_ids in (ids, three):
                got = embedding_bag.embedding_bag(t, bag_ids)
                want = embedding_bag.embedding_bag_plain(t, bag_ids)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                zero = got[:, 1:] == 0
                assert bool(zero[:, 0].all())
                assert not bool(torch.signbit(got[:, 1:][zero]).any())

    def test_two_d_table_and_strided_rows(self, cuda):
        tabs, ids = _bag_case(cuda, 1, 300, 64, 40, 4, torch.float32, 1)
        got = ops.embedding_bag(tabs[0], ids[:, 0], mode="mean")
        want = embedding_bag.embedding_bag_plain(tabs[0], ids[:, 0],
                                                 mode="mean")
        assert torch.equal(got, want)
        wide = torch.randn((2, 300, 70), device=cuda)
        view = wide[:, :, 3:67]                  # row stride 70: no 16-byte loads
        ids2 = ids.expand(40, 2, 4).contiguous()
        assert embedding_bag.route(view, ids2) == "scalar"
        assert torch.equal(ops.embedding_bag(view, ids2),
                           embedding_bag.embedding_bag_plain(view, ids2))
        padded = torch.randn((2, 300, 72), device=cuda)[:, :, :64]
        assert embedding_bag.route(padded, ids2) == "vec16"   # 288-byte rows
        assert torch.equal(ops.embedding_bag(padded, ids2, mode="mean"),
                           embedding_bag.embedding_bag_plain(padded, ids2,
                                                             mode="mean"))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_unaligned_base_and_field_stride(self, cuda, dtype):
        f, v, d = 3, 200, 64
        flat = torch.randn((f * v * d + 64,), device=cuda).to(dtype)
        shifted = flat[1:1 + f * v * d].view(f, v, d)      # base off 16 bytes
        fields = flat.as_strided((f, v, d), (v * d + 1, d, 1))
        _, ids = _bag_case(cuda, f, v, d, 300, 3, dtype, 4)
        for t in (shifted, fields):
            assert embedding_bag.route(t, ids) == "scalar"
            before = embedding_bag.launches_by_kernel["scalar"]
            got = embedding_bag.embedding_bag(t, ids, mode="mean")
            assert embedding_bag.launches_by_kernel["scalar"] == before + 1
            assert torch.equal(got, embedding_bag.embedding_bag_plain(
                t, ids, mode="mean"))

    def test_ids_past_v_and_empty_bags(self, cuda):
        tabs, ids = _bag_case(cuda, 4, 100, 64, 600, 1, torch.float32, 5)
        ids[:50] = -1
        ids[50:60, :, 0] = 100 + torch.arange(10, device=cuda,
                                              dtype=torch.int32)[:, None]
        for mode in ("sum", "mean"):
            got = ops.embedding_bag(tabs, ids, mode=mode)
            assert not got[:50].any()
            fixed = ids.clone()
            fixed[50:60] = 99
            assert torch.equal(got[50:60], tabs[:, 99][None].expand(10, 4, 64))
            assert torch.equal(got, ops.embedding_bag(tabs, fixed, mode=mode))
        for l in (0, 5):                       # no ids, or all padding
            empty = torch.full((70, 4, l), -1, dtype=torch.int32, device=cuda)
            before = embedding_bag.launches
            got = ops.embedding_bag(tabs, empty, mode="mean")
            assert embedding_bag.launches == before + 1
            assert got.shape == (70, 4, 64) and not got.any()

    def test_rejections(self, cuda):
        tabs, ids = _bag_case(cuda, 2, 50, 8, 4, 2, torch.float32, 2)
        with pytest.raises(NotImplementedError, match="max"):
            ops.embedding_bag(tabs, ids, mode="max")
        with pytest.raises(ValueError, match="int32"):
            ops.embedding_bag(tabs, ids.long())
        with pytest.raises(ValueError, match="contiguous"):
            ops.embedding_bag(tabs, ids.transpose(0, 2).contiguous().transpose(0, 2))


def _seg_ratio(got, want, data, seg, n):
    """max |kernel - plain| / (1e-5 * segment sum of |x| + 1e-6)."""
    scale = segment_sum.segment_sum_plain(data.abs(), seg, num_segments=n)
    return float(((got - want).abs() / (1e-5 * scale + 1e-6)).max()) \
        if got.numel() else 0.0


@pytest.mark.cuda
class TestSegmentSumOnCard:
    @pytest.mark.parametrize("e,n,d", [
        (1000, 256, 32), (500, 128, 64), (2000, 384, 16),
        (50, 128, 8),                  # most segments empty
        (5000, 300, 64), (3000, 200, 3), (3000, 200, 1),   # EGNN's widths
        (0, 10, 64),                   # no rows
        (70000, 64, 256),              # D > 128: two column passes
    ])
    def test_unsorted_matches_plain(self, cuda, e, n, d):
        g = torch.Generator(device=cuda).manual_seed(e + n + d)
        data = torch.randn((e, d), generator=g, device=cuda)
        seg = torch.randint(-1, n + 2, (e,), generator=g, device=cuda,
                            dtype=torch.int32)
        before = segment_sum.launches
        got = ops.segment_sum(data, seg, num_segments=n)
        assert segment_sum.launches == before + 1
        want = segment_sum.segment_sum_plain(data, seg, num_segments=n)
        torch.cuda.synchronize()
        assert got.shape == (n, d)
        assert _seg_ratio(got, want, data, seg, n) <= 1.0

    def test_skewed_sorted_and_shifted_pointer(self, cuda):
        """Half the rows in one segment (the JAX package's skewed case),
        through the sorted entry; a pointer shifted by one row must fail
        the same check."""
        g = torch.Generator(device=cuda).manual_seed(5)
        e, n, d = 80000, 128, 64
        data = torch.randn((e, d), generator=g, device=cuda)
        seg = torch.randint(0, n, (e,), generator=g, device=cuda,
                            dtype=torch.int32)
        seg[: e // 2] = 0
        order, seg_s, indptr = segment_sum.sort_by_segment(seg, n)
        rows = data[order]
        got = ops.sorted_segment_sum(rows, seg_s, indptr, num_segments=n)
        want = segment_sum.sorted_segment_sum_plain(rows, seg_s, indptr,
                                                    num_segments=n)
        assert _seg_ratio(got, want, rows, seg_s, n) <= 1.0
        shifted = (indptr + 1).clamp(max=e)
        shifted[0] = 0
        bad = ops.sorted_segment_sum(rows, seg_s, shifted, num_segments=n)
        assert _seg_ratio(bad, want, rows, seg_s, n) > 1.0
        col = torch.randn((e, 5), device=cuda)[:, 1:4]   # row stride 5
        torch.testing.assert_close(
            ops.sorted_segment_sum(col[order], seg_s, indptr, num_segments=n),
            segment_sum.sorted_segment_sum_plain(col[order], seg_s, indptr,
                                                 num_segments=n),
            rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
class TestSegmentSumPartitionOnCard:
    @pytest.mark.parametrize("d", [1, 3, 8, 64, 65, 128])
    def test_hub_tail_empties_and_determinism(self, cuda, d):
        """A hub spanning many warp tasks, empty segments, rows past
        indptr[N] poisoned with NaN; two launches give the same bits."""
        g = torch.Generator(device=cuda).manual_seed(d)
        n = 3000
        lengths = torch.randint(0, 40, (n,), generator=g, device=cuda)
        lengths[::7] = 0                                   # empty segments
        items = segment_sum.ITEMS[segment_sum.route(d)]
        lengths[1234] = 9 * items                          # >= 8 tasks
        indptr = torch.zeros((n + 1,), dtype=torch.int32, device=cuda)
        indptr[1:] = torch.cumsum(lengths, 0).to(torch.int32)
        e_live = int(indptr[-1])
        data = torch.randn((e_live + 100, d), generator=g, device=cuda)
        data[e_live:] = float("nan")                       # never read
        seg = torch.repeat_interleave(torch.arange(n, device=cuda),
                                      lengths).to(torch.int32)
        seg = torch.cat([seg, torch.full((100,), n, dtype=torch.int32,
                                         device=cuda)])
        before = dict(segment_sum.launches_by_kernel)
        a = ops.sorted_segment_sum(data, seg, indptr, num_segments=n)
        b = ops.sorted_segment_sum(data, seg, indptr, num_segments=n)
        kind = segment_sum.route(d)
        assert segment_sum.launches_by_kernel[kind] == before[kind] + 2
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
        assert not a[lengths == 0].any()
        want = segment_sum.sorted_segment_sum_plain(data, seg, indptr,
                                                    num_segments=n)
        assert _seg_ratio(a, want, data[:e_live], seg[:e_live], n) <= 1.0
        shifted = (indptr + 1).clamp(max=e_live)
        shifted[0] = 0
        bad = ops.sorted_segment_sum(data, seg, shifted, num_segments=n)
        assert _seg_ratio(bad, want, data[:e_live], seg[:e_live], n) > 1.0

    def test_segments_cut_at_task_edges(self, cuda):
        """Segments whose end or last row falls on a task's edge, through
        both kernels, against the plain version."""
        for d in (1, 3, 64):
            items = segment_sum.ITEMS[segment_sum.route(d)]
            lengths = torch.tensor([items - 1, items - 1, items, items,
                                    2 * items - 1, 1, 0, 2], device=cuda)
            n = lengths.numel()
            indptr = torch.zeros((n + 1,), dtype=torch.int32, device=cuda)
            indptr[1:] = torch.cumsum(lengths, 0).to(torch.int32)
            data = torch.randn((int(indptr[-1]), d), device=cuda)
            seg = torch.repeat_interleave(torch.arange(n, device=cuda),
                                          lengths).to(torch.int32)
            got = ops.sorted_segment_sum(data, seg, indptr, num_segments=n)
            want = segment_sum.sorted_segment_sum_plain(data, seg, indptr,
                                                        num_segments=n)
            assert _seg_ratio(got, want, data, seg, n) <= 1.0


def _params_to(p, dev):
    if isinstance(p, torch.Tensor):
        return p.to(dev)
    if isinstance(p, MLP):
        return MLP([w.to(dev) for w in p.w], [b.to(dev) for b in p.b])
    if isinstance(p, list):
        return [_params_to(x, dev) for x in p]
    return {k: _params_to(v, dev) for k, v in p.items()}


@pytest.mark.cuda
class TestRecsysAndEGNNOnCard:
    @pytest.mark.parametrize("arch", ["two-tower-retrieval", "autoint",
                                      "dlrm-rm2"])
    def test_smoke_path_matches_cpu(self, cuda, arch):
        from repro_torch.data.synth import recsys_batch_stream
        cfg = get_arch(arch).SMOKE_CONFIG
        p_cpu = R.recsys_init(cfg, seed=1, device="cpu")
        p_gpu = _params_to(p_cpu, cuda)
        b = next(recsys_batch_stream(
            np.random.default_rng(2), cfg.family, 16, n_sparse=cfg.n_sparse,
            vocab=cfg.vocab_per_field, n_dense=cfg.n_dense))
        bc = {k: torch.from_numpy(v) for k, v in b.items()}
        bg = {k: v.to(cuda) for k, v in bc.items()}
        before = embedding_bag.launches
        if cfg.family == "two_tower":
            items = torch.arange(500, dtype=torch.int32)[:, None, None].expand(
                500, 2, 1)
            db_c, db_g = R.tower_item(p_cpu, items), R.tower_item(p_gpu, items.to(cuda))
            torch.testing.assert_close(db_g.cpu(), db_c, rtol=1e-5, atol=1e-5)
            got = R.retrieval_serve(p_gpu, bg["user_ids"], db_g, cfg, k=5)
            want = R.retrieval_serve(p_cpu, bc["user_ids"], db_c, cfg, k=5)
            assert_topk_close([x.cpu() for x in got], want)
            assert embedding_bag.launches == before + 2
        else:
            got = R.recsys_forward(p_gpu, bg, cfg)
            want = R.recsys_forward(p_cpu, bc, cfg)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
            assert embedding_bag.launches == before + 1

    @pytest.mark.parametrize("kind", ["random", "molecules"])
    def test_egnn_matches_cpu(self, cuda, kind):
        cfg = get_arch("egnn").SMOKE_CONFIG
        rng = np.random.default_rng(3)
        graph = (G.random_graph(rng, 64, 256, cfg.d_feat_in, device="cpu")
                 if kind == "random" else
                 G.batched_molecules(rng, 6, 10, 24, cfg.d_feat_in,
                                     device="cpu"))
        p_cpu = EG.egnn_init(cfg, seed=4, device="cpu")
        before = segment_sum.launches
        lg, xg = EG.egnn_forward(_params_to(p_cpu, cuda), graph.to(cuda), cfg)
        assert segment_sum.launches == before + 3 * cfg.n_layers
        lc, xc = EG.egnn_forward(p_cpu, graph, cfg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(xg.cpu(), xc, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ backward kernels --

def _rel_err(got, want):
    """max |got - want| / max |want| (1 where want is all zero)."""
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


#: The flash backward against its plain version: float32 sums in another
#: order, and in bf16 the results' one rounding (2 ** -8 of the largest).
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


@pytest.mark.cuda
class TestFlashBackwardOnCard:
    @pytest.mark.parametrize(
        "b,hq,hkv,sq,skv,dh,dtype,causal,window,v_t,scale", [
            (2, 4, 2, 100, 100, 64, torch.float32, True, None, False, None),
            (1, 8, 8, 65, 130, 16, torch.float32, True, None, False, None),
            (1, 2, 1, 77, 77, 32, torch.bfloat16, True, 16, True, None),
            (1, 24, 2, 300, 300, 128, torch.bfloat16, True, None, True, None),
            (1, 64, 1, 70, 70, 32, torch.bfloat16, True, None, False, None),
            (1, 4, 2, 90, 90, 256, torch.bfloat16, True, 40, False, None),
            (2, 4, 4, 33, 33, 256, torch.float32, False, None, False, None),
            (1, 3, 1, 50, 120, 128, torch.float32, False, 30, False, None),
            (1, 4, 4, 96, 96, 256, torch.bfloat16, True, None, False,
             192 ** -0.5),                       # MLA's padded group-1 call
            (1, 2, 2, 80, 40, 64, torch.float32, True, None, False, None),
        ])
    def test_matches_plain(self, cuda, b, hq, hkv, sq, skv, dh, dtype, causal,
                           window, v_t, scale):
        """Head dims 16-256, groups 1-64, bf16 and float32, lengths off
        the tiles, causal and windowed masks, Sq < Skv and Sq > Skv (rows
        with no key), a transposed v view, a given scale."""
        g = torch.Generator(device=cuda).manual_seed(sq + skv + dh + hq)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=cuda).to(dtype)

        q, k = rnd(b, hq, sq, dh), rnd(b, hkv, skv, dh)
        v = rnd(b, skv, hkv, dh).transpose(1, 2) if v_t else rnd(b, hkv, skv, dh)
        do = rnd(b, hq, sq, dh)
        _, lse = flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, scale=scale,
            return_lse=True)
        kind = flash_attention.backward_route(dtype, dh)
        before = (flash_attention.bwd_launches,
                  flash_attention.bwd_launches_by_kernel[kind])
        got = flash_attention.flash_attention_backward(
            q, k, v, do, lse, causal=causal, window=window, scale=scale)
        assert (flash_attention.bwd_launches,
                flash_attention.bwd_launches_by_kernel[kind]) == \
            (before[0] + 1, before[1] + 1)
        want = flash_attention.flash_attention_backward_plain(
            q, k, v, do, causal=causal, window=window, scale=scale)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == y.shape and x.dtype == dtype, name
            assert bool(torch.isfinite(x).all()), name
            assert _rel_err(x, y) <= FLASH_BWD_TOL[dtype], \
                (name, _rel_err(x, y))

    def test_peaked_rows_match_exact_softmax_gradient(self, cuda):
        """Rows whose attention sits on one key: D is summed from P and dP
        in float32, so dq keeps the exact softmax gradient's direction
        (from rowsum(dO o O) of the bf16 output it did not: 0.33 in a
        trained StarCoder2-3B layer)."""
        g = torch.Generator(device=cuda).manual_seed(7)
        q = (6 * torch.randn((1, 8, 256, 64), generator=g, device=cuda)).to(
            torch.bfloat16)
        k = torch.randn((1, 2, 256, 64), generator=g, device=cuda).to(
            torch.bfloat16)
        v = torch.randn((1, 2, 256, 64), generator=g, device=cuda).to(
            torch.bfloat16)
        do = torch.randn((1, 8, 256, 64), generator=g, device=cuda).to(
            torch.bfloat16)
        _, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                                 return_lse=True)
        got = flash_attention.flash_attention_backward(q, k, v, do, lse,
                                                       causal=True)
        exact = [x.float().requires_grad_(True) for x in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *exact, is_causal=True, enable_gqa=True)
        want = torch.autograd.grad(out, exact, do.float())
        for x, y in zip(got, want):
            cos = float((x.float() * y).sum() / (x.float().norm() * y.norm()))
            assert cos > 0.9999, cos

    def test_autograd_route_and_counts(self, cuda):
        """``ops.flash_attention`` takes the autograd Function only when a
        gradient is asked for; the backward matches SDPA's in float32."""
        g = torch.Generator(device=cuda).manual_seed(1)
        q = torch.randn((1, 4, 70, 64), generator=g, device=cuda)
        k = torch.randn((1, 4, 70, 64), generator=g, device=cuda)
        v = torch.randn((1, 4, 70, 64), generator=g, device=cuda)
        f0, b0 = flash_attention.launches, flash_attention.bwd_launches
        with torch.no_grad():
            ops.flash_attention(q, k, v, causal=True)
        assert (flash_attention.launches, flash_attention.bwd_launches) == \
            (f0 + 1, b0)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = ops.flash_attention(qs, ks, vs, causal=True)
        out.backward(torch.ones_like(out))
        assert (flash_attention.launches, flash_attention.bwd_launches) == \
            (f0 + 2, b0 + 1)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        ref = torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True)
        ref.backward(torch.ones_like(ref))
        for x, y in ((qs, qr), (ks, kr), (vs, vr)):
            assert _rel_err(x.grad, y.grad) <= 1e-4


def _flash_bwd_inputs(dev, b, hq, hkv, sq, skv, dh, v_t, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k = rnd(b, hq, sq, dh), rnd(b, hkv, skv, dh)
    v = rnd(b, skv, hkv, dh).transpose(1, 2) if v_t else rnd(b, hkv, skv, dh)
    return q, k, v, rnd(b, hq, sq, dh)


@pytest.mark.cuda
class TestFlashBackwardWgmmaOnCard:
    """Route ``bwd_wgmma`` (bf16, head dims 64 and 128; 256 has its own
    class below) against the plain
    version, which computes its own log-sum-exp, within ``FLASH_BWD_TOL``;
    the forward kernels' log-sum-exp against the plain one."""

    @pytest.mark.parametrize(
        "b,hq,hkv,sq,skv,dh,causal,window,v_t", [
            (1, 4, 4, 128, 128, 64, False, None, False),     # group 1
            (2, 8, 2, 100, 100, 64, True, None, False),      # group 4, tails
            (1, 24, 2, 300, 300, 128, True, None, True),     # group 12, v view
            (1, 16, 1, 130, 90, 64, True, None, False),      # group 16, Sq > Skv
            (1, 8, 2, 77, 150, 64, False, 40, False),        # window alone
            (1, 12, 1, 70, 70, 128, True, 16, True),         # causal + window
            (2, 16, 4, 1000, 1234, 64, False, 300, False),   # chip_smoke's row
            (1, 4, 1, 190, 250, 128, True, 100, False),
            (1, 8, 2, 1, 40, 128, True, None, False),        # a decode shape
        ])
    def test_matches_plain(self, cuda, b, hq, hkv, sq, skv, dh, causal,
                           window, v_t):
        q, k, v, do = _flash_bwd_inputs(cuda, b, hq, hkv, sq, skv, dh, v_t,
                                        sq + skv + hq)
        assert flash_attention.backward_route(q.dtype, dh) == "bwd_wgmma"
        _, lse = flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, return_lse=True)
        got = flash_attention.flash_attention_backward(
            q, k, v, do, lse, causal=causal, window=window)
        want = flash_attention.flash_attention_backward_plain(
            q, k, v, do, causal=causal, window=window)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == y.shape and x.dtype == torch.bfloat16, name
            assert bool(torch.isfinite(x).all()), name
            assert _rel_err(x, y) <= FLASH_BWD_TOL[torch.bfloat16], \
                (name, _rel_err(x, y))

    def test_two_calls_bit_equal(self, cuda):
        """No atomics: the same call twice gives the same bits."""
        q, k, v, do = _flash_bwd_inputs(cuda, 1, 24, 2, 1000, 1000, 128,
                                        True, 5)
        _, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                                 return_lse=True)
        first = flash_attention.flash_attention_backward(q, k, v, do, lse,
                                                         causal=True)
        second = flash_attention.flash_attention_backward(q, k, v, do, lse,
                                                          causal=True)
        assert all(torch.equal(a, b) for a, b in zip(first, second))

    @pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,dtype,causal,window,kind", [
        (2, 8, 2, 100, 100, 128, torch.bfloat16, True, None, "prefill_wgmma"),
        (1, 12, 1, 70, 90, 64, torch.bfloat16, True, 16, "prefill_wgmma"),
        (1, 8, 2, 1, 543, 128, torch.bfloat16, True, None, "decode_splitkv"),
        (1, 4, 4, 16, 40, 64, torch.float32, True, None, "decode_splitkv"),
        (1, 4, 2, 90, 90, 256, torch.bfloat16, True, 40, "prefill_wgmma"),
        (1, 4, 2, 90, 90, 256, torch.float32, True, 40, "fma"),
        (1, 3, 1, 50, 120, 128, torch.float32, False, 30, "fma"),
        (1, 4, 2, 80, 40, 64, torch.float32, True, None, "fma"),  # empty rows
    ])
    def test_lse_of_each_forward_kernel(self, cuda, b, hq, hkv, sq, skv, dh,
                                        dtype, causal, window, kind):
        """Each forward kernel's log-sum-exp within 1e-5 of max(1, |plain|),
        -inf on the same rows (no kept key); the output as without it."""
        g = torch.Generator(device=cuda).manual_seed(sq * skv + dh)
        q = torch.randn((b, hq, sq, dh), generator=g, device=cuda).to(dtype)
        k = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(dtype)
        v = torch.randn((b, hkv, skv, dh), generator=g, device=cuda).to(dtype)
        assert flash_attention.route(dtype, dh, sq, hq // hkv, skv) == kind
        before = flash_attention.launches_by_kernel[kind]
        out, lse = flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, return_lse=True)
        assert flash_attention.launches_by_kernel[kind] == before + 1
        _, want = flash_attention.flash_attention_plain(
            q, k, v, causal=causal, window=window, return_lse=True)
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
        live = torch.isfinite(want)
        assert torch.equal(torch.isfinite(lse), live)
        assert torch.equal(lse[~live], want[~live])
        err = ((lse - want).abs() / want.abs().clamp(min=1.0))[live]
        assert float(err.max()) <= 1e-5
        assert torch.equal(out, flash_attention.flash_attention(
            q, k, v, causal=causal, window=window))

    def test_launches_by_route(self, cuda):
        """One call counts one launch on its route and none on the other."""
        for dtype, dh, kind in ((torch.bfloat16, 128, "bwd_wgmma"),
                                (torch.bfloat16, 256, "bwd_wgmma"),
                                (torch.float32, 256, "bwd_fma"),
                                (torch.float32, 64, "bwd_fma")):
            q, k, v, do = (x.to(dtype) for x in _flash_bwd_inputs(
                cuda, 1, 4, 2, 96, 96, dh, False, dh))
            _, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                                     return_lse=True)
            before = dict(flash_attention.bwd_launches_by_kernel)
            flash_attention.flash_attention_backward(q, k, v, do, lse,
                                                     causal=True)
            after = flash_attention.bwd_launches_by_kernel
            assert after[kind] == before[kind] + 1
            assert sum(after.values()) == sum(before.values()) + 1

    def test_lse_required(self, cuda):
        q, k, v, do = _flash_bwd_inputs(cuda, 1, 4, 2, 64, 64, 64, False, 3)
        with pytest.raises(ValueError, match="lse"):
            flash_attention.flash_attention_backward(q, k, v, do, None,
                                                     causal=True)


# b, hq, hkv, sq, skv, causal, window, v a transposed view, scale: route
# ``bwd_wgmma`` at head dim 256 — groups 1, 2 and 4; causal, window, both
# and neither; Sq != Skv both ways (rows with no key), lengths off the
# 64-row tiles, prefill's v view, MLA's scale
DH256_BWD_CASES = [
    (1, 4, 4, 128, 128, False, None, False, None),   # group 1, neither
    (1, 8, 4, 300, 300, True, 100, True, None),      # Gemma3's group 2, both
    (2, 8, 4, 200, 200, True, None, False, None),    # group 2, causal
    (1, 16, 4, 77, 333, False, 100, False, None),    # group 4, window alone
    (1, 8, 2, 130, 90, True, None, True, None),      # group 4, Sq > Skv
    (1, 4, 4, 190, 190, True, None, False, 192 ** -0.5),  # MLA's scale
    (1, 8, 2, 1, 40, True, None, False, None),       # one row
]


@pytest.mark.cuda
class TestFlashBackwardDh256OnCard:
    """Route ``bwd_wgmma`` at head dim 256 (the dK / dV launch split by
    role) against the plain version, which computes its own log-sum-exp,
    within ``FLASH_BWD_TOL`` (8e-3 of the largest |plain| in bf16, as
    ``chip_smoke.py``), one launch on the route a call."""

    @pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window,v_t,scale",
                             DH256_BWD_CASES)
    def test_matches_plain(self, cuda, b, hq, hkv, sq, skv, causal, window,
                           v_t, scale):
        q, k, v, do = _flash_bwd_inputs(cuda, b, hq, hkv, sq, skv, 256, v_t,
                                        sq * 7 + skv + hq)
        assert flash_attention.backward_route(q.dtype, 256) == "bwd_wgmma"
        _, lse = flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, scale=scale,
            return_lse=True)
        before = dict(flash_attention.bwd_launches_by_kernel)
        got = flash_attention.flash_attention_backward(
            q, k, v, do, lse, causal=causal, window=window, scale=scale)
        after = flash_attention.bwd_launches_by_kernel
        assert {n: after[n] - before[n] for n in after} == {
            "bwd_wgmma": 1, "bwd_fma": 0}
        want = flash_attention.flash_attention_backward_plain(
            q, k, v, do, causal=causal, window=window, scale=scale)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == y.shape and x.dtype == torch.bfloat16, name
            assert bool(torch.isfinite(x).all()), name
            assert _rel_err(x, y) <= FLASH_BWD_TOL[torch.bfloat16], \
                (name, _rel_err(x, y))

    def test_mla_padded_tensors(self, cuda):
        """MLA's padded call (q / k 192 and v 128 zero-padded to 256, group
        1, scale 192^-0.5, dO's padded columns 0): the gradients of the
        padded columns are exactly 0, the rest within the tolerance."""
        import torch.nn.functional as F
        g = torch.Generator(device=cuda).manual_seed(9)
        bf = torch.bfloat16

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=cuda).to(bf)

        q, k = (F.pad(rnd(1, 16, 333, 192), (0, 64)) for _ in range(2))
        v, do = (F.pad(rnd(1, 16, 333, 128), (0, 128)) for _ in range(2))
        sc = 192 ** -0.5
        _, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                                 scale=sc, return_lse=True)
        got = flash_attention.flash_attention_backward(q, k, v, do, lse,
                                                       causal=True, scale=sc)
        want = flash_attention.flash_attention_backward_plain(
            q, k, v, do, causal=True, scale=sc)
        for name, x, y, d in zip(("dq", "dk", "dv"), got, want,
                                 (192, 192, 128)):
            assert not x[..., d:].any(), name
            assert _rel_err(x, y) <= FLASH_BWD_TOL[bf], (name, _rel_err(x, y))

    def test_two_calls_bit_equal(self, cuda):
        """No atomics, a fixed order: the same call twice, the same bits."""
        q, k, v, do = _flash_bwd_inputs(cuda, 1, 8, 4, 1000, 1000, 256, True,
                                        6)
        _, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                                 window=300, return_lse=True)
        first = flash_attention.flash_attention_backward(
            q, k, v, do, lse, causal=True, window=300)
        second = flash_attention.flash_attention_backward(
            q, k, v, do, lse, causal=True, window=300)
        assert all(torch.equal(a, b) for a, b in zip(first, second))

    @pytest.mark.parametrize("dh", [64, 128, 256])
    def test_built_plan_is_backward_plan(self, cuda, dh):
        """The library reports the plan and shared memory it was built
        with (``flash_bwd_plan``), and they are `backward_plan`'s."""
        assert flash_attention.built_backward_plan(dh) == \
            flash_attention.backward_plan(dh)


@pytest.mark.cuda
class TestEmbeddingBagBackwardOnCard:
    @pytest.mark.parametrize("f,v,d,b,l,mode,dtype", [
        (4, 1000, 256, 512, 1, "sum", torch.float32),   # the two-tower shape
        (3, 50, 13, 64, 8, "mean", torch.float32),      # odd D, padding, ids >= V
        (2, 100, 64, 100, 5, "sum", torch.bfloat16),
        (1, 10, 8, 1000, 3, "sum", torch.float32),      # many ids on one row
    ])
    def test_matches_plain(self, cuda, f, v, d, b, l, mode, dtype):
        g = torch.Generator(device=cuda).manual_seed(f * v + d)
        ids = torch.randint(-1, v + 3, (b, f, l), generator=g, device=cuda,
                            dtype=torch.int32)
        ids[0] = -1                                     # an all-padding bag
        d_out = torch.randn((b, f, d), generator=g, device=cuda)
        before = embedding_bag.bwd_launches
        got = embedding_bag.embedding_bag_backward(d_out, ids, v, mode)
        assert embedding_bag.bwd_launches == before + 1
        want = embedding_bag.embedding_bag_backward_plain(d_out, ids, v, mode)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        tables = torch.randn((f, v, d), generator=g, device=cuda).to(dtype)
        tables.requires_grad_()
        out = ops.embedding_bag(tables, ids, mode=mode)
        out.backward(d_out)
        assert tables.grad.dtype == dtype
        torch.testing.assert_close(tables.grad.float(), want.to(dtype).float(),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
class TestSegmentSumBackwardOnCard:
    @pytest.mark.parametrize("e,n,d", [
        (1000, 100, 64), (400, 50, 3), (3000, 200, 1), (2000, 80, 6),
        (500, 300, 128), (700, 40, 256), (0, 10, 64),
    ])
    def test_matches_plain(self, cuda, e, n, d):
        """Empty segments, a hub, padded rows at the tail (ids >= N), D of
        1 to 256 on the narrow, scalar and 16-byte paths: the gradient is
        a copy, equal bit for bit."""
        g = torch.Generator(device=cuda).manual_seed(e + n + d)
        seg = torch.randint(0, n + 3, (e,), generator=g, device=cuda,
                            dtype=torch.int32)
        seg[: e // 3] = 1
        order, seg_s, indptr = segment_sum.sort_by_segment(seg, n)
        d_out = torch.randn((n, d), generator=g, device=cuda)
        before = segment_sum.bwd_launches
        got = segment_sum.sorted_segment_sum_backward(d_out, seg_s, indptr)
        want = segment_sum.sorted_segment_sum_backward_plain(d_out, seg_s,
                                                             indptr)
        assert segment_sum.bwd_launches == before + (1 if e else 0)
        assert got.shape == (e, d) and torch.equal(got, want)
        data = torch.randn((e, d), generator=g, device=cuda,
                           requires_grad=True)
        out = ops.sorted_segment_sum(data, seg_s, indptr, num_segments=n)
        out.backward(d_out)
        assert torch.equal(data.grad, want)


# ------------------------------------------------------ multi-device ----

_DIST_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N, D, Q = 20000, 256, 24


def setup():
    from repro_torch.core import make_schedule
    from repro_torch.core.index import prefix_squared_norms
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    db = torch.randn((N, D), generator=g, device="cuda")
    q = db[:Q] + 0.1 * torch.randn((Q, D), generator=g, device="cuda")
    sched = make_schedule(32, 256, 32, final_k=4)
    dims = tuple(s.dim for s in sched.stages)
    return db, q, sched, dims, prefix_squared_norms(db, dims)


def search(mesh, world, rank, out, tag):
    from repro_torch.core.distributed import build_sharded_search
    from repro_torch.kernels import distance_topk, gather_rescore
    db, q, sched, dims, sqp = setup()
    rows = N // world
    lo = rank * rows
    res = {}
    for mode in ("local", "global"):
        fn = build_sharded_search(mesh, sched, N, has_prefix=True,
                                  index_dims=dims, mode=mode)
        l0, g0 = distance_topk.launches, dict(gather_rescore.launches_by_kernel)
        s, i = fn(q, db[lo:lo + rows], sqp[lo:lo + rows])
        torch.cuda.synchronize()
        res[mode] = {"l2_topk": distance_topk.launches - l0,
                     **{k: gather_rescore.launches_by_kernel[k] - g0[k]
                        for k in g0}}
        np.savez(os.path.join(out, f"{tag}_{mode}_{rank}.npz"),
                 s=s.cpu().numpy(), i=i.cpu().numpy())
    with open(os.path.join(out, f"{tag}_counts_{rank}.json"), "w") as f:
        json.dump(res, f)


def ep(mesh, rank, out):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.layers.moe import MoE, moe_apply, moe_init, moe_specs
    from repro_torch.sharding.specs import make_ctx
    cfg = MoEConfig(n_experts=16, top_k=4, d_ff_expert=128)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    p = moe_init(g, 256, cfg, "swiglu", torch.bfloat16, device="cuda")
    x = torch.randn((2, 64, 256), generator=g, device="cuda").bfloat16()
    ctx = make_ctx(mesh)
    names = ("router", "w_in", "w_out", "w_gate")
    held = ctx.held_blocks({k: moe_specs(cfg, "swiglu")[k] for k in names},
                           {k: getattr(p, k).data for k in names})
    p_held = MoE(*(held[k] for k in names))
    with torch.no_grad():
        y1, a1 = moe_apply(p, x, cfg, "swiglu")
        y, a = moe_apply(p_held, x, cfg, "swiglu", ctx=ctx)
    rel = float((y.float() - y1.float()).norm() / y1.float().norm())
    with open(os.path.join(out, f"ep_{rank}.json"), "w") as f:
        json.dump({"rel_l2": rel, "aux": float(a), "aux_one": float(a1)}, f)


def rank_main(rank, world, out):
    sys.path.insert(0, os.environ["REPRO_SRC"])
    torch.cuda.set_device(0)
    torch.cuda.init()
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out, "rdzv"), rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_mesh_compat
    search(make_mesh_compat((world,), ("data",)), world, rank, out, "gloo")
    ep(make_mesh_compat((1, world), ("data", "model")), rank, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    mp.spawn(rank_main, args=(2, out), nprocs=2)
    from repro_torch.core import progressive_search
    from repro_torch.core.progressive import _topk_first
    db, q, sched, dims, sqp = setup()
    s, i = progressive_search(q, db, sched, sq_prefix=sqp, index_dims=dims)
    np.savez(os.path.join(out, "single.npz"), s=s.cpu().numpy(),
             i=i.cpu().numpy())
    # the local mode's two slabs searched and merged in this one process
    rows = N // 2
    parts = [progressive_search(q, db[r * rows:(r + 1) * rows], sched,
                                sq_prefix=sqp[r * rows:(r + 1) * rows],
                                index_dims=dims) for r in range(2)]
    all_s = torch.cat([p[0] for p in parts], 1)
    all_i = torch.cat([p[1] + r * rows for r, p in enumerate(parts)], 1)
    ms, pos = _topk_first(all_s, parts[0][0].shape[1])
    np.savez(os.path.join(out, "emulated_local.npz"), s=ms.cpu().numpy(),
             i=torch.gather(all_i, 1, pos).cpu().numpy())
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        out, "rdzv_nccl"), rank=0, world_size=1)
    from repro_torch.launch.mesh import make_mesh_compat
    search(make_mesh_compat((1,), ("data",)), 1, 0, out, "nccl")
    dist.destroy_process_group()
    print("OK")
'''


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """The sharded search in a ``gloo`` world of 2 ranks sharing the card
    and in an NCCL world of one, and the EP MoE on 2 ranks: one worker
    script, its outputs as npz / json in a temporary directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import subprocess
    import sys
    d = tmp_path_factory.mktemp("dist_card")
    (d / "worker.py").write_text(_DIST_WORKER)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, REPRO_SRC=src,
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, str(d / "worker.py"), str(d)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return d


def _npz(d, name):
    z = np.load(d / f"{name}.npz")
    return z["s"], z["i"]


@pytest.mark.cuda
class TestDistributedOnCard:
    @pytest.mark.parametrize("world", ["gloo", "nccl"])
    def test_global_equals_one_process(self, dist_run, world):
        want = _npz(dist_run, "single")
        ranks = 2 if world == "gloo" else 1
        for r in range(ranks):
            assert_topk_close(_npz(dist_run, f"{world}_global_{r}"), want)

    def test_local_gloo_equals_its_one_process_merge(self, dist_run):
        want = _npz(dist_run, "emulated_local")
        for r in range(2):
            got = _npz(dist_run, f"gloo_local_{r}")
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])

    def test_local_nccl_of_one_equals_one_process(self, dist_run):
        got, want = _npz(dist_run, "nccl_local_0"), _npz(dist_run, "single")
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])

    @pytest.mark.parametrize("world", ["gloo", "nccl"])
    def test_launches_a_call(self, dist_run, world):
        import json
        for r in range(2 if world == "gloo" else 1):
            c = json.loads((dist_run / f"{world}_counts_{r}.json").read_text())
            assert c["local"] == {"l2_topk": 1, "ladder": 1, "step": 0}
            assert c["global"] == {"l2_topk": 1, "ladder": 0, "step": 3}

    def test_ep_moe_on_two_ranks(self, dist_run):
        import json
        for r in range(2):
            res = json.loads((dist_run / f"ep_{r}.json").read_text())
            assert res["rel_l2"] <= 1e-2
            assert abs(res["aux"] - res["aux_one"]) <= 1e-6 * abs(
                res["aux_one"])

    @pytest.mark.parametrize("dead", [0.5, 0.9, 0.99, 1.0])
    @pytest.mark.parametrize("k", [1, 16, 64])
    def test_rescore_mostly_minus_one(self, cuda, dead, k):
        """The rescore kernel on candidate tables where most slots are -1
        (a rank's view in ``global`` mode), some queries with none live."""
        from repro_torch.core import truncated as T
        g = torch.Generator(device=cuda)
        g.manual_seed(int(dead * 100) + k)
        n, d, nq, c = 5000, 512, 32, 64
        db = torch.randn((n, d), generator=g, device=cuda)
        q = torch.randn((nq, d), generator=g, device=cuda)
        cand = torch.randint(0, n, (nq, c), generator=g, device=cuda,
                             dtype=torch.int32)
        drop = torch.rand((nq, c), generator=g, device=cuda) < dead
        drop[:4] = True                       # queries with no live slot
        cand = torch.where(drop, torch.full_like(cand, -1), cand)
        sq = (db[:, :256] ** 2).sum(1)
        for dim, sq_at in ((256, sq), (512, None)):
            got = gather_rescore.gather_rescore_topk(q, db, cand, dim=dim,
                                                     k=k, sq_at_dim=sq_at)
            want = T.rescore_candidates(q, db, cand, dim=dim, k=k,
                                        db_sq_at_dim=sq_at)
            assert_topk_close([x.cpu() for x in got],
                              [x.cpu() for x in want])
            assert bool((got[1][:4] == -1).all())
