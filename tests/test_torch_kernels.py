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
from repro_torch.kernels import distance_topk, embedding_bag, gather_rescore, ops
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


def _deployment_data(rng, nq, n, dim, d_emb=3584):
    """Rows and noisy-copy queries with ``chip_smoke.py``'s dim scales
    ``(1 + i)^-0.2``, normalised to d_emb over the full width."""
    sc = (1.0 + np.arange(d_emb)) ** -0.2
    sc = (sc / np.linalg.norm(sc) * d_emb ** 0.5)[:dim]
    db = (rng.normal(size=(n, dim)) * sc).astype(np.float32)
    q = (db[rng.integers(0, n, nq)] + rng.normal(size=(nq, dim)) * sc)
    return q.astype(np.float32), db


class TestStage0TensorCoreArithmetic:
    """`scores_3xtf32` — the tensor-core kernel's split-TF32 products in
    plain PyTorch — against the Pallas ``l2_topk`` in interpret mode, on the
    deployment's data.

    Tolerance: a quarter of ``chip_smoke.compare``'s ``1e-3 + 2e-5 *
    max|score|`` (0.0031 at dim 64, 0.0041 at dim 128 here), so the card's
    own summation order keeps three quarters of the limit; ids equal up to
    near-ties (a swapped pair's scores within the same tolerance).
    Measured on the data of the first test (4,096 rows, seeds 64 and 128):
    3xTF32 is within 1.2e-4 (dim 64) and 1.6e-4 (dim 128) of a float64
    score, while a single TF32 product (hi * hi alone) is off by 0.21 and
    0.20 — about 8x the limit taken over all 4,096 scores (0.024 and
    0.025), which is why the kernel takes three products.
    """

    @pytest.mark.parametrize("dim", [64, 128, 512, 3584])
    def test_3xtf32_matches_pallas_interpret(self, dim):
        rng = np.random.default_rng(dim)
        q, db = _deployment_data(rng, 32, 4096, dim)
        k = 64
        ws, wi = (np.asarray(x) for x in pallas_l2_topk(
            jnp.asarray(q), jnp.asarray(db), k=k, block_q=8, block_n=512,
            interpret=True))
        scores = distance_topk.scores_3xtf32(torch.from_numpy(q),
                                             torch.from_numpy(db), dim)
        # top-k in the kernel's order: (score, row) ascending
        order = np.lexsort((np.broadcast_to(np.arange(db.shape[0]),
                                            scores.shape),
                            scores.numpy()), axis=1)[:, :k]
        gs = np.take_along_axis(scores.numpy(), order, axis=1)
        tol = 0.25 * (1e-3 + 2e-5 * float(np.abs(ws).max()))
        assert np.abs(gs - ws).max() <= tol
        differ = order != wi
        assert np.all(np.abs(gs[differ] - ws[differ]) <= tol)

    def test_single_tf32_product_is_outside_the_limit(self):
        rng = np.random.default_rng(1)
        q, db = _deployment_data(rng, 32, 4096, 128)
        exact = ((db.astype(np.float64) ** 2).sum(1)[None]
                 - 2.0 * q.astype(np.float64) @ db.astype(np.float64).T)
        tol = 1e-3 + 2e-5 * float(np.abs(exact).max())
        three = distance_topk.scores_3xtf32(torch.from_numpy(q),
                                            torch.from_numpy(db), 128)
        assert np.abs(three.double().numpy() - exact).max() < 0.05 * tol
        qh = distance_topk.tf32_round(torch.from_numpy(q)).double()
        xh = distance_topk.tf32_round(torch.from_numpy(db)).double()
        one = (db.astype(np.float64) ** 2).sum(1)[None] - 2.0 * (qh @ xh.T).numpy()
        assert np.abs(one - exact).max() > tol

    def test_tf32_round_is_cvt_rna(self):
        x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                          -(1.0 + 2 ** -11), 3.0e-3], dtype=torch.float32)
        r = distance_topk.tf32_round(x)
        assert r[:4].tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                  -(1.0 + 2 ** -10)]    # ties away from 0
        assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
        assert abs(float(r[4]) - 3.0e-3) <= 3.0e-3 * 2 ** -11

    def test_route_and_tiles(self):
        db = torch.zeros((1000, 68))
        q = torch.zeros((5, 68))
        assert distance_topk.route(q, db, 64) == "wgmma"
        assert distance_topk.route(q, db, 30) == "fma"          # dim % 4
        assert distance_topk.route(q, db[:, 1:], 64) == "fma"   # unaligned
        assert distance_topk.route(q, torch.zeros((10, 300)), 260) == "wide"
        assert distance_topk.warpgroups(128) == 3
        assert distance_topk.warpgroups(129) == 2
        assert distance_topk.wgmma_tile(5, 64, 3)[0] == 8
        assert distance_topk.wgmma_tile(33, 128, 3)[0] == 32
        for nq, dim in ((1, 4), (512, 64), (32, 128), (32, 256)):
            for wgs in (2, 3):
                nt, st = distance_topk.wgmma_tile(nq, dim, wgs)
                assert st >= 2
                assert distance_topk.wgmma_smem_bytes(nt, dim, st, wgs) \
                    <= distance_topk.SMEM_LIMIT
        assert distance_topk.splits(8192, 16, 132) == (8, 1024)
        assert distance_topk.splits(8192, 1, 132) == (131, 63)
        assert distance_topk.merge_groups(32, 132, 132) == 5
        assert distance_topk.merge_groups(512, 8, 132) == 1

    @pytest.mark.parametrize("dim,want", [
        (260, "wide"), (512, "wide"), (3584, "wide"),   # float32, aligned
        (514, "fma"),                                   # dim % 4
        (128, "wgmma"), (256, "wgmma"),                 # up to 256 dims
    ])
    def test_wide_route(self, dim, want):
        """Aligned float32 rows above 256 dims go to ``wide``; a dim that
        is not a multiple of 4 stays on ``fma``, 256 dims and fewer on
        ``wgmma``."""
        db = torch.zeros((50, 3588))
        for nq, k in ((1, 1), (2470, 1), (32, 1024)):
            assert distance_topk.route(torch.zeros((nq, 3588)), db, dim,
                                       k) == want

    def test_wide_route_leaves_fma_what_tma_cannot_read(self):
        """An unaligned base or row stride and bf16 rows at 512 dims stay on
        ``fma``; an empty store too."""
        q = torch.zeros((32, 1024))
        db = torch.zeros((100, 1024))
        assert distance_topk.route(q, db, 512) == "wide"
        assert distance_topk.route(q, db[:, 1:], 512) == "fma"      # base
        assert distance_topk.route(q, torch.zeros((100, 1026)), 512) == "fma"
        assert distance_topk.route(q.bfloat16(), db.bfloat16(), 512) == "fma"
        assert distance_topk.route(q, db[:0], 512) == "fma"
        assert distance_topk.counter_key("wide", torch.float32) == "wide"
        assert "wide" in distance_topk.launches_by_kernel

    def test_wide_plan_by_k(self):
        """The query tile by k class (64 up to k = 64, 32 to 256, 16 to 512,
        8 to 1,024), smaller for a batch that fits a smaller tile; every
        class's lists leave a tile (128 rows) of room above k, and its
        shared memory fits `SMEM_LIMIT` at every tile."""
        for k, tile, slots in ((1, 64, 256), (16, 64, 256), (64, 64, 256),
                               (65, 32, 512), (256, 32, 512),
                               (257, 16, 1024), (512, 16, 1024),
                               (513, 8, 2048), (1024, 8, 2048)):
            assert distance_topk.wide_plan(2470, k)[:2] == (tile, slots)
            assert slots >= k + distance_topk.WIDE_ROWS
            for nq in (1, 9, 17, 33, 64, 2470):
                t, sl, st, smem = distance_topk.wide_plan(nq, k)
                assert t == min(tile, max(8, 1 << (nq - 1).bit_length()))
                assert sl == slots and st >= 3
                assert smem <= distance_topk.SMEM_LIMIT
        assert distance_topk.wide_plan(2470, 1)[3] == 231_224
        with pytest.raises(ValueError):
            distance_topk.wide_plan(1, distance_topk.MAX_K + 1)

    @pytest.mark.parametrize("nq", [32, 2470])
    @pytest.mark.parametrize("k", [1, 16, 64, 256, 512, 1024])
    def test_wide_grid_fills_the_card(self, nq, k):
        """At the serving batch and at the paper's, over the 1M-row store
        (8,192 tiles of 128 rows): a grid of at least 132 CTAs, as many
        items as CTAs or more, ranges that differ by at most one tile, and
        the pass-1 lists within `WIDE_PART_BYTES`."""
        tile = distance_topk.wide_plan(nq, k)[0]
        q_tiles = -(-nq // tile)
        cap = max(1, distance_topk.WIDE_PART_BYTES // (nq * k * 8))
        n_split, per, grid = distance_topk.wide_splits(8192, q_tiles, 132,
                                                       cap)
        assert grid >= 132 and n_split * q_tiles >= grid
        assert 1 <= n_split <= min(8192, cap) and per == -(-8192 // n_split)
        begins = [s * 8192 // n_split for s in range(n_split + 1)]
        sizes = {b - a for a, b in zip(begins, begins[1:])}
        assert max(sizes) - min(sizes) <= 1 and max(sizes) == per
        # no cut of the range gives fewer rounds of tiles by more than 2%
        rounds = lambda ns: -(-(ns * q_tiles) // 132) * -(-8192 // ns)
        best = min(rounds(ns) for ns in range(1, min(8192, cap, 528) + 1))
        assert rounds(n_split) <= 1.02 * best

    def test_timing_script_patches_match_the_wide_kernel(self):
        """Each patch of ``launch/stage0_time.py``'s `WIDE_PATCHES` still
        finds its text in ``csrc/distance_topk_wide.cu``, once; its cases
        hold the paper's wide shapes."""
        from repro_torch.kernels import _build
        from repro_torch.launch import stage0_time

        src = (_build.CSRC / "distance_topk_wide.cu").read_text()
        assert set(stage0_time.WIDE_PATCHES) == {
            "no_products", "no_loads", "rows_only", "queries_only",
            "fold_every_box", "fold_at_tile_end"}
        for name, patches in stage0_time.WIDE_PATCHES.items():
            for old, new in patches:
                assert src.count(old) == 1 and old != new, name
        shapes = {c[1:] for c in stage0_time.CASES}
        for dim in (512, 1024, 2048, 3584):
            assert (2470, dim, 1) in shapes
        assert {(2470, 512, 16), (2470, 512, 1024), (32, 512, 512),
                (32, 512, 1024)} <= shapes

    def test_wide_plan_mirrors_the_source(self):
        """``WIDE_PLAN`` and the constants of ``wd`` in
        ``csrc/distance_topk_wide.cu`` are the wrapper's, and the argument
        block's fields (``WideArgs``) are `pack_wide_args`'s, in order, each
        packed at its C offset."""
        import inspect
        import re
        import struct

        from repro_torch.kernels import _build

        src = (_build.CSRC / "distance_topk_wide.cu").read_text()
        table = tuple(tuple(int(x) for x in m) for m in re.findall(
            r"^WIDE_PLAN\((\d+), (\d+), (\d+), (\d+)\)$", src, re.M))
        assert table == distance_topk.WIDE_PLANS
        assert table[-1][0] == distance_topk.MAX_K
        wd = src[src.index("namespace wd {"):src.index("}  // namespace wd")]
        assert re.search(r"kRows = 64 \* kWgs;", wd)
        assert re.search(r"kWgs = (\d+);", wd)[1] == "2"
        assert 64 * 2 == distance_topk.WIDE_ROWS
        assert re.search(r"kSmemMax = (\d+);", wd)[1] == str(
            distance_topk.SMEM_LIMIT)
        body = re.search(r"struct WideArgs \{(.*?)\n\};", src, re.S)[1]
        fields = []
        for line in body.splitlines():
            m = re.match(r"\s*((?:const )?[a-z0-9_ ]+?\*?)\s*(\w+(?:, \w+)*);",
                         line)
            if m:
                fields += [(n, m[1].strip()) for n in m[2].split(", ")]
        names = list(inspect.signature(
            distance_topk.pack_wide_args).parameters)[1:]
        assert names == [n for n, _ in fields]
        offsets, off = {}, 0
        for name, ty in fields:
            code = "q" if ty == "long long" else "i" if ty == "int" else "Q"
            size = struct.calcsize(code)
            off = -(-off // size) * size
            offsets[name] = (off, code)
            off += size
        assert distance_topk._WIDE_ARGS.size == -(-off // 8) * 8
        values = {n: 1000 + 7 * j for j, n in enumerate(names)}
        buf = bytearray(distance_topk._WIDE_ARGS.size)
        distance_topk.pack_wide_args(buf, **values)
        for name, (o, code) in offsets.items():
            assert struct.unpack_from("@" + code, buf, o)[0] == values[name]


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


def _ladder_chain_jax(q, db, cand, stages, *, sq=None, sq_cols=None,
                      valid=None):
    """The ladder as ``repro``'s Pallas ``gather_rescore`` (interpret mode)
    chained stage by stage through numpy: each stage scores the previous
    stage's ids in rank order at its dim; a precomputed norm column
    replaces the row norm (s - |x|^2 + sq), invalid rows score +inf,
    equal scores keep the lower position (``lax.top_k``'s order)."""
    for j, (dim, k) in enumerate(stages):
        s = np.asarray(pallas_gather_rescore(
            jnp.asarray(q[:, :dim]), jnp.asarray(db[:, :dim]),
            jnp.asarray(cand), block_c=8, interpret=True)).astype(np.float64)
        safe = np.clip(cand, 0, None)
        col = None if sq_cols is None else sq_cols[j]
        if col is not None:
            rows = db[safe, :dim].astype(np.float64)
            s = s - (rows * rows).sum(-1) + sq[safe, col]
        ok = cand >= 0
        if valid is not None:
            ok &= valid[safe]
        s = np.where(ok, s, np.inf)
        order = np.argsort(s, axis=1, kind="stable")[:, :k]
        s = np.take_along_axis(s, order, 1)
        cand = np.where(np.isfinite(s), np.take_along_axis(cand, order, 1),
                        -1).astype(np.int32)
    return s.astype(np.float32), cand


def _ladder_case(seed, nq=4, n=300, d=256, c=64):
    rng = np.random.default_rng(seed)
    q, db = _data(rng, nq, n, d)
    cand = np.stack([rng.permutation(n)[:c] for _ in range(nq)]).astype(np.int32)
    cand[:, -3:] = -1                                  # padding slots
    return rng, q, db, cand


# (dim, k) ladders: doubling dims down to 10 (carried dot), a dim that
# drops (recomputed from 0), one deeper than a chunk (two partial sums)
LADDERS = {
    "doubling": [(32, 32), (64, 16), (128, 12), (256, 10)],
    "drop": [(64, 20), (32, 12), (128, 10)],
    "chunks": [(256, 24), (700, 10)],
}


class TestRescoreLadderMirror:
    """`gather_rescore.rescore_ladder_mirror` — the CUDA ladder's
    arithmetic (rank-order chaining, carried dot products and norms in
    512-dim chunks, -1 propagation) — against ``repro``'s Pallas kernel
    chained stage by stage.  Tolerance ``rtol=1e-5, atol=1e-4``: the
    carried sums add the same products in another order than one
    reduction over the prefix."""

    @pytest.mark.parametrize("ladder", sorted(LADDERS))
    @pytest.mark.parametrize("with_sq", [False, True])
    def test_matches_chained_pallas(self, ladder, with_sq):
        stages = LADDERS[ladder]
        rng, q, db, cand = _ladder_case(len(ladder) + with_sq, d=704)
        valid = rng.random(300) > 0.15
        valid[cand[1]] = False           # a query whose candidates all fail
        dims = sorted({dim for dim, _ in stages})
        sq = np.stack([(db[:, :dd].astype(np.float64) ** 2).sum(1)
                       for dd in dims], 1)
        sq += rng.uniform(0, 5, size=sq.shape)   # so that the column matters
        sq = sq.astype(np.float32)
        cols = [dims.index(dim) if with_sq and i % 2 == 0 else None
                for i, (dim, _) in enumerate(stages)]
        got = gather_rescore.rescore_ladder_mirror(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(cand),
            stages, sq_prefix=torch.from_numpy(sq), sq_cols=cols,
            valid=torch.from_numpy(valid))
        want = _ladder_chain_jax(q, db, cand, stages, sq=sq, sq_cols=cols,
                                 valid=valid)
        assert_topk_close(got, want)
        assert (got[1][1] == -1).all() and torch.isinf(got[0][1]).all()
        plain = gather_rescore.rescore_ladder_topk_plain(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(cand),
            stages, sq_prefix=torch.from_numpy(sq), sq_cols=cols,
            valid=torch.from_numpy(valid))
        assert_topk_close(got, plain)

    def test_equal_scores_keep_the_previous_rank(self):
        """Rows that tie at every stage keep the order of the stage
        before, as the chained steps give."""
        rng, q, db, cand = _ladder_case(5, nq=3, n=40, d=64, c=24)
        db[20:40] = db[0:20]             # row r + 20 equals row r
        cand = np.stack([rng.permutation(40)[:24] for _ in range(3)]).astype(np.int32)
        stages = [(16, 16), (32, 12), (64, 8)]
        got = gather_rescore.rescore_ladder_mirror(
            torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(cand),
            stages)
        want = _ladder_chain_jax(q, db, cand, stages)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL,
                                   atol=ATOL)

    def test_ops_ladder_on_cpu_is_the_chained_step(self):
        from repro_torch.core import make_schedule
        from repro_torch.core.index import build_index, lookup_prefix

        rng, q, db, cand = _ladder_case(8, nq=5, n=200, d=128, c=32)
        sched = make_schedule(16, 128, 32, final_k=4)
        qt, dbt = torch.from_numpy(q), torch.from_numpy(db)
        idx = build_index(dbt, tuple(s.dim for s in sched.stages))
        valid = torch.from_numpy(rng.random(200) > 0.1)
        before = (gather_rescore.launches,
                  dict(gather_rescore.launches_by_kernel))
        got = ops.rescore_ladder(qt, dbt, torch.from_numpy(cand),
                                 sched.stages[1:], sq_prefix=idx["sq_prefix"],
                                 index_dims=idx["dims"], valid=valid)
        s, c = None, torch.from_numpy(cand)
        for st in sched.stages[1:]:
            s, c = T.rescore_candidates(
                qt, dbt, c, dim=st.dim, k=st.k, valid=valid,
                db_sq_at_dim=lookup_prefix(idx["sq_prefix"], idx["dims"],
                                           st.dim))
        assert torch.equal(got[0], s) and torch.equal(got[1], c)
        assert (gather_rescore.launches,
                gather_rescore.launches_by_kernel) == before
        assert ops.rescore_ladder(qt, dbt, c, (), scores=s) == (s, c)
        plain = ops.plain.rescore_ladder(
            qt, dbt, torch.from_numpy(cand), sched.stages[1:],
            sq_prefix=idx["sq_prefix"], index_dims=idx["dims"], valid=valid)
        assert torch.equal(plain[0], s) and torch.equal(plain[1], c)

    def test_plan_and_cluster_size(self):
        stages = [(256, 32), (512, 16), (1024, 10), (2048, 10), (3584, 10)]
        b_cap, p_cap = gather_rescore.plan(64, tuple(stages))
        assert b_cap == 32 and p_cap == 64       # 64 rows x 1 chunk at stage 1
        assert gather_rescore.plan(4096, ((3584, 10),)) == (0, 4096)
        assert gather_rescore.plan(10, ((64, 10), (2048, 5))) == (10, 40)
        assert [gather_rescore.cluster_size(nq, 132)
                for nq in (1, 8, 32, 33, 512)] == [8, 8, 4, 4, 1]


def _c_struct(path, name):
    """[(field, C type)] of ``struct name`` in a CUDA source, in order."""
    import re
    body = re.search(r"struct %s \{(.*?)\n\};" % name, path.read_text(),
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*((?:const )?[a-z ]+?\*?)\s*(\w+);", line)
        if m:
            fields.append((m.group(2), m.group(1).strip()))
    return fields


def _vec16_walk(plan, n_bags, bag_len, n_fields):
    """The (bag, id index) pairs the ``vec16`` kernel's CTAs visit, in each
    bag's order: its stage loop (tile = cta + (s // chunks) * ctas, chunk =
    s % chunks), its per-stage loop (bag slot i = u * groups + g, ids l
    + k of the chunk) and its walk order (``walk_at``: bag-major, or
    passes of ``fields_per_pass`` fields, every batch row's bags of a
    pass's fields before the next pass's) written out.  Also checks that
    the field the kernel reads is the bag's."""
    rows, fp = n_bags // n_fields, plan["fields_per_pass"]

    def walk_at(j):
        if fp == n_fields:
            return j, j % n_fields
        p = j // (rows * fp)
        r = j - p * rows * fp
        w = min(fp, n_fields - p * fp)
        b = r // w
        f = p * fp + r - b * w
        return b * n_fields + f, f

    groups = embedding_bag.THREADS // plan["group"]
    per_tile, lc_max = plan["bags_per_tile"], plan["ids_chunk"]
    u_n, k_n = plan["bags_per_group"], plan["ids_per_step"]
    chunks = -(-bag_len // lc_max) if bag_len > lc_max else 1
    n_tiles = -(-n_bags // per_tile)
    seen = {}
    for cta in range(plan["ctas"]):
        my_tiles = (n_tiles - 1 - cta) // plan["ctas"] + 1 if cta < n_tiles else 0
        for s in range(my_tiles * chunks):
            tile, chunk = cta + (s // chunks) * plan["ctas"], s % chunks
            bag0 = tile * per_tile
            nb = min(per_tile, n_bags - bag0)
            lc = min(lc_max, bag_len - chunk * lc_max)
            for g in range(groups):
                for l in range(0, lc, k_n):
                    for u in range(u_n):
                        i = u * groups + g
                        for k in range(k_n):
                            if i < nb and l + k < lc:
                                bag, f = walk_at(bag0 + i)
                                assert f == bag % n_fields
                                seen.setdefault(bag, []).append(
                                    chunk * lc_max + l + k)
                for u in range(u_n):                 # every bag is stored
                    if u * groups + g < nb:
                        seen.setdefault(walk_at(bag0 + u * groups + g)[0], [])
    return seen


class TestEmbeddingBagPlan:
    """The embedding-bag wrapper's route, tile plan and argument block, as
    plain functions (the kernel itself runs on the card only)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [8, 16, 18, 64, 256])
    def test_route(self, d, dtype):
        es = torch.tensor([], dtype=dtype).element_size()
        ids = torch.zeros((4, 3, 2), dtype=torch.int32)
        whole = d * es % 16 == 0
        aligned = torch.zeros((3, 50, d), dtype=dtype)
        assert embedding_bag.route(aligned, ids) == \
            ("vec16" if whole else "scalar")
        # a row stride of whole 16-byte words, wider than the row
        padded = torch.zeros((3, 50, d + 16 // es), dtype=dtype)[:, :, :d]
        assert embedding_bag.route(padded, ids) == \
            ("vec16" if whole else "scalar")
        # row stride d + 1 elements: never whole words
        strided = torch.zeros((3, 50, d + 1), dtype=dtype)[:, :, :d]
        assert embedding_bag.route(strided, ids) == "scalar"
        # a field stride off the 16-byte grid
        flat = torch.zeros(3 * 50 * d + 8, dtype=dtype)
        field = flat.as_strided((3, 50, d), (50 * d + 1, d, 1))
        assert embedding_bag.route(field, ids) == "scalar"
        # an unaligned base: the same table one element on
        shifted = flat[1:1 + 3 * 50 * d].view(3, 50, d)
        assert shifted.data_ptr() % 16 != 0
        assert embedding_bag.route(shifted, ids) == "scalar"
        assert embedding_bag.route(aligned[0], ids[:, 0]) == \
            ("vec16" if whole else "scalar")

    def test_route_rows_wider_than_a_cta(self):
        ids = torch.zeros((2, 1, 1), dtype=torch.int32)
        assert embedding_bag.route(torch.zeros((1, 4, 1024)), ids) == "vec16"
        assert embedding_bag.route(torch.zeros((1, 4, 1028)), ids) == "scalar"
        assert embedding_bag.route(
            torch.zeros((1, 4, 2048), dtype=torch.bfloat16), ids) == "vec16"

    @pytest.mark.parametrize("es", [4, 2])
    @pytest.mark.parametrize("d", [8, 16, 18, 64, 256])
    @pytest.mark.parametrize("bag_len", [0, 1, 3, 100])
    @pytest.mark.parametrize("n_bags,sms", [(1, 132), (13 * 512, 132),
                                            (5000, 3), (6_815_744, 132)])
    def test_tile_plan(self, es, d, bag_len, n_bags, sms):
        n_fields = 26 if n_bags % 26 == 0 else 1
        if d * es % 16:                  # the scalar route: a lane an element
            p = embedding_bag.tile_plan("scalar", d, es, bag_len, n_bags,
                                        n_fields, sms)
            assert p["group"] == 32 and p["ids_chunk"] == bag_len
            assert p["fields_per_pass"] == n_fields
            assert p["ctas"] * embedding_bag.THREADS >= n_bags * 32 \
                > (p["ctas"] - 1) * embedding_bag.THREADS
            return
        p = embedding_bag.tile_plan("vec16", d, es, bag_len, n_bags, n_fields,
                                    sms)
        assert p["fields_per_pass"] == min(
            n_fields, -(-2048 // (4 * d + d * es * bag_len)))
        words = d * es // 16
        g = p["group"]
        assert g & (g - 1) == 0 and words <= g < max(2 * words, 2)
        u, k = p["bags_per_group"], p["ids_per_step"]
        assert u * k <= 8 and (k == 1) == (bag_len == 1)
        assert (u, k) in ((8, 1), (4, 1), (2, 2), (1, 4), (1, 8))
        assert p["bags_per_tile"] <= embedding_bag.SLOTS_CAP
        assert u <= 2 or k == 1          # at most two bags' sums in registers
        assert p["bags_per_tile"] == embedding_bag.THREADS // g * u
        assert 1 <= p["ids_chunk"] <= max(bag_len, 1)
        assert p["bags_per_tile"] * p["ids_chunk"] <= embedding_bag.IDS_CAP
        assert (p["tiles"] - 1) * p["bags_per_tile"] < n_bags \
            <= p["tiles"] * p["bags_per_tile"]
        assert p["ctas"] == min(p["tiles"], sms * embedding_bag.CTAS_PER_SM)

    def test_tile_plan_at_the_path_shapes(self):
        plan = embedding_bag.tile_plan
        dlrm = plan("vec16", 64, 4, 1, 26 * 262_144, 26, 132)
        assert (dlrm["group"], dlrm["bags_per_tile"], dlrm["ctas"],
                dlrm["fields_per_pass"]) == (16, 128, 528, 4)
        item = plan("vec16", 256, 4, 1, 4 * 1_000_000, 4, 132)
        assert (item["group"], item["bags_per_tile"], item["tiles"]) == \
            (64, 32, 125_000)
        l100 = plan("vec16", 64, 4, 100, 4 * 4096, 4, 132)
        assert (l100["bags_per_tile"], l100["ids_chunk"], l100["ctas"],
                l100["fields_per_pass"]) == (16, 100, 528, 1)
        l100_bf16 = plan("vec16", 64, 2, 100, 4 * 4096, 4, 132)
        assert (l100_bf16["bags_per_tile"], l100_bf16["ids_chunk"],
                l100_bf16["ctas"]) == (32, 64, 512)
        p99 = plan("vec16", 64, 4, 1, 26 * 512, 26, 132)
        assert (p99["tiles"], p99["ctas"]) == (104, 104)
        assert item["fields_per_pass"] == 1          # 1 KiB output rows
        autoint = plan("vec16", 16, 4, 1, 39 * 512, 39, 132)
        assert autoint["fields_per_pass"] == 16      # 64-byte output rows
        assert plan("vec16", 64, 4, 1, 300, 1, 132)["fields_per_pass"] == 1
        sc = plan("scalar", 18, 4, 3, 55, 5, 132)
        assert (sc["group"], sc["ctas"], sc["fields_per_pass"]) == (32, 7, 5)
        with pytest.raises(ValueError, match="route"):
            plan("tma", 64, 4, 1, 10, 1, 132)

    @pytest.mark.parametrize("d,es,bag_len,n_bags,n_fields,sms", [
        (64, 4, 1, 1040, 26, 2),      # passes of 4 fields, the last of 2
        (256, 4, 1, 1040, 26, 2),     # field by field, tiles across fields
        (64, 4, 1, 1000, 1, 2),       # one field, a ragged last tile
        (16, 4, 1, 1014, 39, 1),      # passes of 16 fields, the last of 7
        (8, 4, 1, 1014, 3, 1),        # memory order: 32-byte output rows
        (64, 4, 100, 77, 7, 1),       # one bag's ids in one chunk
        (8, 4, 100, 300, 3, 2),       # ids in chunks of 16
        (64, 2, 100, 70, 2, 1),       # bf16: chunks of 64 and 36
        (16, 4, 3, 1500, 3, 1),
        (8, 2, 2, 600, 4, 3),
        (64, 4, 0, 40, 4, 1),         # empty bags: stored, no id read
    ])
    def test_vec16_walk_visits_every_id_once_in_order(self, d, es, bag_len,
                                                      n_bags, n_fields, sms):
        p = embedding_bag.tile_plan("vec16", d, es, bag_len, n_bags, n_fields,
                                    sms)
        seen = _vec16_walk(p, n_bags, bag_len, n_fields)
        assert sorted(seen) == list(range(n_bags))
        assert all(ls == list(range(bag_len)) for ls in seen.values())

    @pytest.mark.parametrize("fp", [1, 2, 3, 5, 7])
    def test_vec16_walk_any_pass_size(self, fp):
        """Passes of any size, a short last pass included (7 fields)."""
        p = {**embedding_bag.tile_plan("vec16", 64, 4, 2, 7 * 150, 7, 2),
             "fields_per_pass": fp}
        seen = _vec16_walk(p, 7 * 150, 2, 7)
        assert sorted(seen) == list(range(7 * 150))
        assert all(ls == [0, 1] for ls in seen.values())

    def test_timing_script_patches_match_the_kernel(self):
        """The patched copies `launch/embedding_bag_time.py` builds still
        find the text they replace in ``csrc/embedding_bag.cu``."""
        from repro_torch.kernels import _build
        from repro_torch.launch.embedding_bag_time import VARIANTS

        src = (_build.CSRC / "embedding_bag.cu").read_text()
        assert "createpolicy" in src
        for name, (flags, patches) in VARIANTS.items():
            assert flags or patches, name
            for old, _ in patches:
                assert src.count(old) == 1, name

    def test_argument_block_matches_the_cuda_struct(self):
        """Field by field: the wrapper's `pack_args` parameters name the
        fields of ``EmbeddingBagArgs`` in ``csrc/embedding_bag.cu`` in its
        order, and each packed value lands at that field's C offset."""
        import inspect
        import struct

        from repro_torch.kernels import _build

        fields = _c_struct(_build.CSRC / "embedding_bag.cu", "EmbeddingBagArgs")
        names = list(inspect.signature(embedding_bag.pack_args).parameters)[1:]
        assert names == [n for n, _ in fields]
        ctype = {"const void*": "Q", "const int*": "Q", "float*": "Q",
                 "void*": "Q", "long long": "q", "int": "i"}
        offsets, off = {}, 0
        for name, ty in fields:
            code = ctype[ty]
            size = struct.calcsize(code)
            off = -(-off // size) * size               # C alignment
            offsets[name] = (off, code)
            off += size
        assert embedding_bag.ARGS.size == -(-off // 8) * 8
        values = {n: 1000 + 7 * j for j, n in enumerate(names)}
        buf = bytearray(embedding_bag.ARGS.size)
        embedding_bag.pack_args(buf, **values)
        for name, (o, code) in offsets.items():
            assert struct.unpack_from("@" + code, buf, o)[0] == values[name]
