"""The port's int8 and PQ stage 0 against the JAX package on the same inputs.

Covers `core/quant.py` (the int8 grid, the blocked stage 0 and
`quantized_progressive_search`), `core/pq.py` (encode / decode / LUT / ADC
given the JAX package's codebooks, both stage-0 routes),
`kernels/pq_scan.py` (the plain flat and list-major scans against the
Pallas kernels in interpret mode and both oracles) and the ``quantized``
backend and the ``ivf`` backend with PQ slabs: states built by the JAX
package are carried over through ``state_dict`` → the port's
``load_state`` and searched by both packages, through the tail window,
deletes and ``absorb_appends``.  Fresh port builds (whose codebook draws
differ from ``jax.random``) are compared on recall.

Tolerance: scores ``rtol=1e-5, atol=1e-4`` — float32 sums taken in another
order by XLA / the Pallas interpreter (a one-hot product for the ADC
lookup) and by torch.  Ids equal up to near-ties; the (+inf, -1) sentinels
identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp

from repro.core import make_schedule as j_make_schedule
from repro.core import pq as JP
from repro.core import quant as JQ
from repro.engine import DocStore as JDocStore
from repro.index_backends import make_backend as j_make_backend
from repro.kernels import ivf_scan as JK
from repro.kernels import pq_scan as JPQ
from repro.kernels import ref as JR

from repro_torch.core import make_schedule
from repro_torch.core import pq as PP
from repro_torch.core import quant as PQ
from repro_torch.engine import DocStore
from repro_torch.index_backends import make_backend
from repro_torch.kernels import ivf_scan as PK
from repro_torch.kernels import ops
from repro_torch.kernels import pq_scan as PPQ
from repro_torch.kernels import ref as PR

RTOL, ATOL = 1e-5, 1e-4
D = 32
DIMS = (8, 16, 32)


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


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    db = rng.normal(size=(300, D)).astype(np.float32)
    q = rng.normal(size=(6, D)).astype(np.float32)
    valid = rng.random(300) > 0.15
    cb = JP.train_pq(jnp.asarray(db[:, :16]), m=4, n_codes=32, n_iter=4)
    return dict(rng=rng, db=db, q=q, valid=valid, cb=np.asarray(cb))


class TestInt8Grid:
    def test_grid_helpers_match(self, data):
        x, valid = data["db"], data["valid"]
        js = JQ.fit_int8_scale(jnp.asarray(x), jnp.asarray(valid))
        ps = PQ.fit_int8_scale(_t(x), _t(valid))
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL)
        jc, jsq = JQ.int8_encode(jnp.asarray(x), js)
        pc, psq = PQ.int8_encode(_t(x), _t(js))
        assert pc.dtype == torch.int8
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(psq.numpy(), np.asarray(jsq),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            PQ.fold_int8_query(_t(data["q"]), _t(js)).numpy(),
            np.asarray(JQ.fold_int8_query(jnp.asarray(data["q"]), js)),
            rtol=RTOL, atol=1e-6)
        jq, jsc = JQ.quantize_per_dim(jnp.asarray(x))
        pq, psc = PQ.quantize_per_dim(_t(x))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), rtol=RTOL)

    def test_pad_pow2_and_in_place_scatter(self):
        for n in (1, 3, 4, 7):
            a = np.arange(n) * 10
            np.testing.assert_array_equal(PQ.pad_pow2(a), JQ.pad_pow2(a))
        buf = torch.zeros((8, 2), dtype=torch.int8)
        sq = torch.zeros(8)
        dests = PQ.pad_pow2(np.array([1, 5, 6]))           # repeats the last
        rows = torch.ones((4, 2), dtype=torch.int8)
        a, b = PQ.scatter_rows2(buf, sq, dests, rows, torch.full((4,), 2.0))
        assert a is buf and b is sq                        # written in place
        assert buf[:, 0].tolist() == [0, 1, 0, 0, 0, 1, 1, 0]
        assert sq.tolist() == [0, 2, 0, 0, 0, 2, 2, 0]

    def test_build_quantized_index_matches(self, data):
        js = j_make_schedule(8, D, 16, final_k=4)
        ps = make_schedule(8, D, 16, final_k=4)
        ji = JQ.build_quantized_index(jnp.asarray(data["db"]), js,
                                      valid=jnp.asarray(data["valid"]))
        pi = PQ.build_quantized_index(_t(data["db"]), ps,
                                      valid=_t(data["valid"]))
        np.testing.assert_array_equal(pi["db0_q"].numpy(),
                                      np.asarray(ji["db0_q"]))
        for key in ("scale0", "sq0"):
            np.testing.assert_allclose(pi[key].numpy(), np.asarray(ji[key]),
                                       rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("block_n", [37, 65536])
    def test_quantized_search_matches(self, data, block_n):
        """Blocked stage 0 (and one block), row limit, tail injection and
        the validity mask, against the JAX search on the same index."""
        js = j_make_schedule(8, D, 16, final_k=4)
        ps = make_schedule(8, D, 16, final_k=4)
        ji = JQ.build_quantized_index(jnp.asarray(data["db"]), js)
        pi = {k: _t(v) for k, v in ji.items()}
        tail = np.array([280, 281, 295, -1], np.int32)
        valid = data["valid"].copy()
        valid[281] = False
        want = JQ.quantized_progressive_search(
            jnp.asarray(data["q"]), ji, js, valid=jnp.asarray(valid),
            row_limit=jnp.asarray(280), extra_cand=jnp.asarray(tail))
        got = PQ.quantized_progressive_search(
            _t(data["q"]), pi, ps, valid=_t(valid), row_limit=280,
            extra_cand=_t(tail), block_n=block_n)
        assert_topk_close(got, want)
        assert_topk_close(
            PQ.quantized_progressive_search_plain(
                _t(data["q"]), pi, ps, valid=_t(valid), row_limit=280,
                extra_cand=_t(tail), block_n=block_n), want)

    def test_fully_masked_stage0_gives_sentinels(self, data):
        ps = make_schedule(8, D, 16, final_k=4)
        pi = PQ.build_quantized_index(_t(data["db"]), ps)
        s, i = PQ.quantized_progressive_search(
            _t(data["q"]), pi, ps, valid=torch.zeros(300, dtype=torch.bool),
            block_n=64)
        assert (i == -1).all() and torch.isinf(s).all()


class TestPqCodec:
    def test_codec_given_jax_codebooks(self, data):
        x, cb = data["db"][:, :16], data["cb"]
        jc = JP.pq_encode(jnp.asarray(x), jnp.asarray(cb), block_n=64)
        pc = PP.pq_encode(_t(x), _t(cb), block_n=64)
        assert pc.dtype == torch.uint8
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(PP.pq_decode(pc, _t(cb)).numpy(),
                                   np.asarray(JP.pq_decode(jc, jnp.asarray(cb))),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(PP.pq_cent_sq(_t(cb)).numpy(),
                                   np.asarray(JP.pq_cent_sq(jnp.asarray(cb))),
                                   rtol=RTOL, atol=ATOL)
        q = data["q"][:, :16]
        jl = JP.pq_lut(jnp.asarray(q), jnp.asarray(cb))
        pl = PP.pq_lut(_t(q), _t(cb))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(PP.pq_adc_scores(pl, pc).numpy(),
                                   np.asarray(JP.pq_adc_scores(jl, jc)),
                                   rtol=RTOL, atol=ATOL)
        assert [PP.auto_pq_m(d) for d in (8, 16, 24, 128, 130)] == \
            [JP.auto_pq_m(d) for d in (8, 16, 24, 128, 130)]
        assert PP.pq_dims(_t(cb)) == JP.pq_dims(jnp.asarray(cb))

    def test_port_training_quantizes(self, data):
        x = _t(data["db"][:, :16])
        cb = PP.train_pq(x, m=4, n_codes=32, n_iter=4, seed=3)
        assert cb.shape == (4, 32, 4) and cb.dtype == torch.float32
        err = ((PP.pq_decode(PP.pq_encode(x, cb), cb) - x) ** 2).sum(1).mean()
        assert float(err) < 0.5 * float((x ** 2).sum(1).mean())
        # fewer rows than codes samples with replacement
        assert PP.train_pq(x[:10], m=2, n_codes=32, n_iter=2).shape == \
            (2, 32, 8)
        with pytest.raises(ValueError):
            PP.train_pq(x, m=3)


class TestPqScanPlain:
    @pytest.mark.parametrize("k", [20, 400])              # and k > N
    def test_flat_matches_pallas_and_oracle(self, data, k):
        x, cb = data["db"][:, :16], data["cb"]
        codes = np.asarray(JP.pq_encode(jnp.asarray(x), jnp.asarray(cb)))
        lut = np.asarray(JP.pq_lut(jnp.asarray(data["q"][:, :16]),
                                   jnp.asarray(cb)))
        ids = np.where(data["valid"], np.arange(300), -1).astype(np.int32)
        want = JPQ.pq_scan_topk(jnp.asarray(lut), jnp.asarray(codes),
                                jnp.asarray(ids), k=k, block_m=64,
                                interpret=True)
        got = ops.pq_scan_topk(_t(lut), _t(codes), _t(ids), k=k)
        assert_topk_close(got, want)
        out = got[1].numpy()
        assert data["valid"][out[out >= 0]].all()
        if k <= 300:
            pr = PR.pq_scan_ref(_t(lut), _t(codes), _t(ids), k=k)
            jr = JR.pq_scan_ref(jnp.asarray(lut), jnp.asarray(codes),
                                jnp.asarray(ids), k=k)
            assert_topk_close(got, pr)
            assert_topk_close(pr, jr)
        else:
            assert (out[:, int(data["valid"].sum()):] == -1).all()

    def test_flat_all_masked_and_ties(self):
        lut = torch.zeros((2, 2, 4))
        codes = torch.zeros((5, 2), dtype=torch.uint8)
        s, i = ops.pq_scan_topk(lut, codes, torch.full((5,), -1,
                                                       dtype=torch.int32), k=3)
        assert (i == -1).all() and torch.isinf(s).all()
        # every row scores 0: the lower row wins, as lax.top_k orders them
        ids = torch.tensor([0, 1, -1, 3, 4], dtype=torch.int32)
        _, i = ops.pq_scan_topk(lut, codes, ids, k=4)
        assert i.tolist() == [[0, 1, 3, 4]] * 2

    @pytest.mark.parametrize("k", [12, 130])             # and k > rows scanned
    def test_list_major_matches_pallas_and_oracle(self, data, k):
        rng = np.random.default_rng(5)
        n, n_lists, max_len, d0 = 240, 12, 24, 16
        db = data["db"][:n]
        ids = rng.permutation(n)[:216]
        lists = np.full((n_lists, max_len), -1, np.int32)
        for j, chunk in enumerate(np.array_split(ids, n_lists)):
            lists[j, :len(chunk)] = chunk
        lists[3] = -1                                     # an empty list
        valid = data["valid"][:n]
        masked = np.where((lists >= 0) & valid[np.maximum(lists, 0)], lists,
                          -1).astype(np.int32)
        probe = np.stack([rng.choice(n_lists, 5, replace=False)
                          for _ in range(6)]).astype(np.int32)
        probe[0, :2] = [3, 4]
        cb = data["cb"]
        jp = JK.pack_ivf_lists(jnp.asarray(db), jnp.asarray(lists), dim=d0,
                               dtype="pq", block_m=16,
                               pq_codebooks=jnp.asarray(cb))
        pp = PK.pack_ivf_lists(_t(db), _t(lists), dim=d0, dtype="pq",
                               block_m=16, pq_codebooks=_t(cb))
        np.testing.assert_array_equal(pp["rows"].numpy(),
                                      np.asarray(jp["rows"]))
        want = JPQ.pq_ivf_scan_topk(jnp.asarray(data["q"]),
                                    jnp.asarray(probe), jnp.asarray(masked),
                                    jp, k=k, interpret=True)
        got = ops.pq_ivf_scan_topk(_t(data["q"]), _t(probe), _t(masked), pp,
                                   k=k)
        assert_topk_close(got, want)
        if k <= 5 * 24:
            lut = PPQ._lut(_t(data["q"]), pp, None)
            codes = PP.pq_encode(_t(db[:, :d0]), _t(cb))
            pr = PR.pq_ivf_scan_ref(lut, codes, _t(masked), _t(probe), k=k)
            jr = JR.pq_ivf_scan_ref(jnp.asarray(lut.numpy()),
                                    jnp.asarray(codes.numpy()),
                                    jnp.asarray(masked), jnp.asarray(probe),
                                    k=k)
            assert_topk_close(got, pr)
            assert_topk_close(pr, jr)

    def test_update_pq_pack_matches(self, data):
        db = data["db"]
        lists = np.arange(64, dtype=np.int32).reshape(4, 16)
        lists[:, 12:] = -1
        cb = data["cb"]
        jp = JK.pack_ivf_lists(jnp.asarray(db), jnp.asarray(lists), dim=16,
                               dtype="pq", block_m=16,
                               pq_codebooks=jnp.asarray(cb))
        pp = PK.pack_ivf_lists(_t(db), _t(lists), dim=16, dtype="pq",
                               block_m=16, pq_codebooks=_t(cb))
        ids = np.array([70, 71, 99], np.int32)
        dests = np.array([12, 13, 3 * 16 + 15], np.int64)
        jp2 = JK.update_pack(jp, jnp.asarray(db), ids, dests)
        pp2 = PK.update_pack(pp, _t(db), ids, dests)
        assert pp2["rows"] is pp["rows"]                  # written in place
        np.testing.assert_array_equal(pp2["rows"].numpy(),
                                      np.asarray(jp2["rows"]))


def _pq_lists(data):
    """(db, lists, probe, packs) of a list-major PQ case: 12 lists of 24
    slots, list 3 empty, 6 queries x 5 probes."""
    rng = np.random.default_rng(5)
    n, n_lists, max_len, d0 = 240, 12, 24, 16
    db = data["db"][:n]
    ids = rng.permutation(n)[:216]
    lists = np.full((n_lists, max_len), -1, np.int32)
    for j, chunk in enumerate(np.array_split(ids, n_lists)):
        lists[j, :len(chunk)] = chunk
    lists[3] = -1
    probe = np.stack([rng.choice(n_lists, 5, replace=False)
                      for _ in range(6)]).astype(np.int32)
    cb = data["cb"]
    jp = JK.pack_ivf_lists(jnp.asarray(db), jnp.asarray(lists), dim=d0,
                           dtype="pq", block_m=16, pq_codebooks=jnp.asarray(cb))
    pp = PK.pack_ivf_lists(_t(db), _t(lists), dim=d0, dtype="pq",
                           block_m=16, pq_codebooks=_t(cb))
    return db, lists, probe, jp, pp


def _masked(lists, valid):
    return np.where((lists >= 0) & valid[np.maximum(lists, 0)], lists,
                    -1).astype(np.int32)


class TestPqListValidRoute:
    """The list-major PQ scan given the raw member table and the validity
    bits (as a dispatch calls it) against ``repro``'s mask-then-scan (the
    Pallas kernel in interpret mode on the masked table)."""

    @pytest.mark.parametrize("k", [12, 130])
    def test_valid_route_is_mask_then_scan(self, data, k):
        db, lists, probe, jp, pp = _pq_lists(data)
        valid = data["valid"][:240]
        masked = _masked(lists, valid)
        got = ops.pq_ivf_scan_topk(_t(data["q"]), _t(probe), _t(lists), pp,
                                   k=k, valid=_t(valid))
        pre = ops.pq_ivf_scan_topk(_t(data["q"]), _t(probe), _t(masked), pp,
                                   k=k)
        assert torch.equal(got[0], pre[0]) and torch.equal(got[1], pre[1])
        want = JPQ.pq_ivf_scan_topk(jnp.asarray(data["q"]), jnp.asarray(probe),
                                    jnp.asarray(masked), jp, k=k,
                                    interpret=True)
        assert_topk_close(got, want)
        out = got[1].numpy()
        assert valid[out[out >= 0]].all()

    def test_dead_lists_n_probe_one_and_k_above_live(self, data):
        db, lists, probe, jp, pp = _pq_lists(data)
        valid = data["valid"][:240].copy()
        valid[lists[5][lists[5] >= 0]] = False           # all tombstoned
        masked = _masked(lists, valid)
        for p in (probe[:, :1].copy(), probe[:, :2].copy()):
            p[0] = [3, 5][:p.shape[1]]
            k = 2 * 24 + 5
            got = ops.pq_ivf_scan_topk(_t(data["q"]), _t(p), _t(lists), pp,
                                       k=k, valid=_t(valid))
            want = JPQ.pq_ivf_scan_topk(jnp.asarray(data["q"]), jnp.asarray(p),
                                        jnp.asarray(masked), jp, k=k,
                                        interpret=True)
            assert_topk_close(got, want)
            assert (got[1][0] == -1).all() and torch.isinf(got[0][0]).all()
            n_live = (masked[p] >= 0).sum(axis=(1, 2))
            np.testing.assert_array_equal((got[1].numpy() == -1).sum(1),
                                          k - n_live)

    def test_ties_by_probe_rank_then_slot(self):
        # every code 0 and a zero table: every live row scores 0, so the
        # earlier probe rank, then the earlier slot wins; id 3 tombstoned
        pack = {"rows": torch.zeros((9, 2), dtype=torch.uint8), "sq": None,
                "scale": None, "codebooks": None, "cent_sq": None, "dim": 4,
                "max_len": 3, "block_m": 3, "dtype": "pq"}
        lists = torch.tensor([[0, 1, -1], [2, 3, 4], [5, -1, -1]],
                             dtype=torch.int32)
        valid = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool)
        lut = torch.zeros((1, 2, 4))
        probe = torch.tensor([[1, 0, 2]], dtype=torch.int32)
        _, i = PPQ.pq_ivf_scan_topk(torch.zeros((1, 4)), probe, lists, pack,
                                    k=7, lut=lut, valid=valid)
        assert i.tolist() == [[2, 4, 0, 1, 5, -1, -1]]
        masked = _masked(lists.numpy(), valid.numpy())
        jpack = {**{key: pack[key] for key in ("dim", "max_len", "block_m",
                                                "dtype")},
                 "rows": jnp.zeros((9, 2), jnp.uint8)}
        want = JPQ.pq_ivf_scan_topk(jnp.zeros((1, 4)), jnp.asarray(probe),
                                    jnp.asarray(masked), jpack, k=7,
                                    lut=jnp.zeros((1, 2, 4)), interpret=True)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))


class TestPqTileMirror:
    """`pq_scan.pq_scan_tile_plain` — the flat CUDA scan's arithmetic: the
    tables of a tile of queries laid out ``[m][code][t]``, one lookup of a
    code for the whole tile, each query's sum in m order.  Its scores are
    bitwise equal to the plain version's (the same additions in the same
    order), and it agrees with ``repro``'s Pallas kernel in interpret mode
    within this file's tolerance (the one-hot product sums in another
    order)."""

    @pytest.mark.parametrize("tile", [1, 2, 4, 8])
    @pytest.mark.parametrize("nq", [1, 5, 6])
    def test_bitwise_plain_and_close_to_pallas(self, data, tile, nq):
        x, cb = data["db"][:, :16], data["cb"]
        codes = np.asarray(JP.pq_encode(jnp.asarray(x), jnp.asarray(cb)))
        q = np.concatenate([data["q"]] * 2)[:nq, :16]
        lut = np.asarray(JP.pq_lut(jnp.asarray(q), jnp.asarray(cb)))
        ids = np.where(data["valid"], np.arange(300), -1).astype(np.int32)
        got = PPQ.pq_scan_tile_plain(_t(lut), _t(codes), _t(ids), k=40,
                                     tile=tile)
        plain = PPQ.pq_scan_topk_plain(_t(lut), _t(codes), _t(ids), k=40)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        want = JPQ.pq_scan_topk(jnp.asarray(lut), jnp.asarray(codes),
                                jnp.asarray(ids), k=40, block_m=64,
                                interpret=True)
        assert_topk_close(got, want)

    def test_tile_plan(self):
        """The tile the wrapper picks at the serving shape (Q 32, M 16,
        C 256, k 256) is 8 in 215,136 bytes, and every tile it picks fits
        the 227 KB a block may take."""
        assert PPQ.tile_size(32, 16, 256, 256) == 8
        assert PPQ.tile_smem_bytes(8, 16, 256, 256) == 215_136
        assert PPQ.tile_size(1, 16, 256, 256) == 1
        assert PPQ.tile_size(5, 16, 256, 256) == 8
        assert PPQ.tile_size(32, 16, 256, 2048) == 4
        for m in (3, 4, 16, 32, 64):
            for k in (1, 64, 256, 2048):
                t = PPQ.tile_size(64, m, 256, k)
                assert PPQ.tile_smem_bytes(t, m, 256, k) <= PPQ.SMEM_LIMIT
        n_split, rows_per = PPQ.split_rows(32, 1_048_576, 8, 16, 256, 256, 132)
        assert rows_per % PPQ.ROWS == 0 and n_split * rows_per >= 1_048_576
        assert 4 * n_split >= 132


class TestPqSearch:
    @pytest.mark.parametrize("route", ["plain", "kernel"])
    def test_search_matches_on_jax_index(self, data, route):
        js = j_make_schedule(16, D, 16, final_k=4)
        ps = make_schedule(16, D, 16, final_k=4)
        ji = JP.build_pq_index(jnp.asarray(data["db"]), js, m=4, n_codes=32,
                               n_iter=3)
        pi = {k: _t(v) for k, v in ji.items()}
        tail = np.array([290, 291, -1, -1], np.int32)
        valid = data["valid"].copy()
        kw = dict(oversample=2, row_limit=290)
        if route == "plain":
            want = JP.pq_progressive_search(
                jnp.asarray(data["q"]), ji, js, valid=jnp.asarray(valid),
                extra_cand=jnp.asarray(tail), **kw)
            got = PP.pq_progressive_search(_t(data["q"]), pi, ps,
                                           valid=_t(valid),
                                           extra_cand=_t(tail), **kw)
        else:
            want = JP.pq_progressive_search_kernel(
                jnp.asarray(data["q"]), ji, js, valid=jnp.asarray(valid),
                extra_cand=jnp.asarray(tail), block_m=64, interpret=True,
                **kw)
            got = PP.pq_progressive_search_kernel(
                _t(data["q"]), pi, ps, valid=_t(valid), extra_cand=_t(tail),
                **kw)
            assert_topk_close(PP.pq_progressive_search_kernel_plain(
                _t(data["q"]), pi, ps, valid=_t(valid), extra_cand=_t(tail),
                **kw), want)
        assert_topk_close(got, want)
        with pytest.raises(ValueError, match="L2"):
            PP.pq_progressive_search(_t(data["q"]), pi, ps, metric="cosine")


# -- backends: JAX-built states carried into the port ------------------------

VARIANTS = {
    "quantized_int8": ("quantized", dict(min_rebuild_rows=16)),
    "quantized_pq": ("quantized", dict(min_rebuild_rows=16, codec="pq",
                                       pq_m=4, pq_codes=32, pq_iters=3,
                                       pq_oversample=2)),
    "quantized_pq_kernel": ("quantized", dict(
        min_rebuild_rows=16, codec="pq", pq_m=4, pq_codes=32, pq_iters=3,
        use_kernel=True, kernel_block_m=64)),
    "quantized_pq_off": ("quantized", dict(
        min_rebuild_rows=16, codec="pq", pq_m=4, pq_codes=32, pq_iters=3,
        use_kernel=False)),
    "ivf_pq": ("ivf", dict(n_lists=12, n_probe=6, min_index_rows=32,
                           min_rebuild_rows=16, append_spare=2,
                           kernel_block_m=16, use_kernel=True,
                           stage0_dtype="pq", pq_m=4, pq_codes=32,
                           pq_iters=4, pq_oversample=2)),
}


def _search_both(jb, jstate, js, pb, pstate, ps, q, k=4):
    want = jb.search(jnp.asarray(q), jstate, js.db, js.valid,
                     sq_prefix=js.sq_prefix, n_total=js.size, k=k)
    got = pb.search(_t(q), pstate, ps.db, ps.valid, sq_prefix=ps.sq_prefix,
                    n_total=ps.size, k=k)
    assert_topk_close(got, want)
    return got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_carried_state_searches_alike(variant):
    rng = np.random.default_rng(19)
    name, opts = VARIANTS[variant]
    docs = rng.normal(size=(160, D)).astype(np.float32)
    js = JDocStore(D, DIMS, capacity=256)
    ps = DocStore(D, DIMS, capacity=256, device="cpu")
    d_start = 16 if name == "quantized" else 8
    jsched = j_make_schedule(d_start, D, 16, final_k=4)
    psched = make_schedule(d_start, D, 16, final_k=4)
    jb = j_make_backend(name, sched=jsched, **opts)
    pb = make_backend(name, sched=psched, device="cpu", **opts)
    for st in (js, ps):
        st.add(docs)
        st.delete([4, 9, 33])
    jstate = jb.build(js.db, js.valid, sq_prefix=js.sq_prefix,
                      stats=js.stats())
    payload = jb.state_dict(jstate)
    pstate = pb.load_state(payload, db=ps.db, valid=ps.valid,
                           sq_prefix=ps.sq_prefix, stats=ps.stats())
    if name == "quantized":
        assert "idx/db" not in payload["arrays"]
        assert pstate.data["idx"]["db"] is ps.db         # the store's own
        key = "codes" if opts.get("codec") == "pq" else "db0_q"
        assert pstate.data["idx"][key].dtype == \
            (torch.uint8 if key == "codes" else torch.int8)
    else:
        assert pstate.data["pack"]["rows"].dtype == torch.uint8
    q = docs[::20] + 0.05 * rng.normal(size=(8, D)).astype(np.float32)
    got = _search_both(jb, jstate, js, pb, pstate, ps, q)
    assert not np.isin(got[1].numpy(), [4, 9, 33]).any()

    # appends: first through the tail window, then absorbed (coded on the
    # frozen grid / into the same list slots) by both packages
    new = rng.normal(size=(30, D)).astype(np.float32) * 3
    js.add(new)
    ps.add(new)
    _search_both(jb, jstate, js, pb, pstate, ps, new[:8])
    for be, st, state in ((jb, js, jstate), (pb, ps, pstate)):
        be.absorb_appends(state, st.db, st.valid, sq_prefix=st.sq_prefix,
                          stats=st.stats())
    if name == "quantized":
        key = "codes" if opts.get("codec") == "pq" else "db0_q"
        np.testing.assert_array_equal(pstate.data["idx"][key].numpy(),
                                      np.asarray(jstate.data["idx"][key]))
    else:
        np.testing.assert_array_equal(pstate.data["lists"].numpy(),
                                      np.asarray(jstate.data["lists"]))
        np.testing.assert_array_equal(pstate.data["pack"]["rows"].numpy(),
                                      np.asarray(jstate.data["pack"]["rows"]))
    for st in (js, ps):
        st.delete([160, 161])
    got = _search_both(jb, jstate, js, pb, pstate, ps, new[:8])
    assert not np.isin(got[1].numpy(), [160, 161]).any()
    assert pb.gauges(pstate, ps.stats()) == pytest.approx(
        jb.gauges(jstate, js.stats()))
    # and back: the port's state_dict loads into the JAX package
    jstate2 = jb.load_state(pb.state_dict(pstate), db=js.db, valid=js.valid,
                            sq_prefix=js.sq_prefix, stats=js.stats())
    want2 = jb.search(jnp.asarray(new[:8]), jstate2, js.db, js.valid,
                      sq_prefix=js.sq_prefix, n_total=js.size, k=4)
    assert_topk_close(got, want2)


def test_codec_mismatch_rejected_at_load():
    rng = np.random.default_rng(3)
    docs = rng.normal(size=(80, D)).astype(np.float32)
    js = JDocStore(D, DIMS, capacity=128)
    ps = DocStore(D, DIMS, capacity=128, device="cpu")
    js.add(docs)
    ps.add(docs)
    sched = j_make_schedule(16, D, 16, final_k=4)
    jb = j_make_backend("quantized", sched=sched)
    payload = jb.state_dict(jb.build(js.db, js.valid, stats=js.stats()))
    pb = make_backend("quantized", sched=make_schedule(16, D, 16, final_k=4),
                      device="cpu", codec="pq", pq_m=4)
    with pytest.raises(ValueError, match="codec"):
        pb.load_state(payload, db=ps.db, valid=ps.valid, stats=ps.stats())
    with pytest.raises(ValueError, match="ivf"):
        make_backend("ivf", sched=make_schedule(16, D, 16), device="cpu") \
            .load_state(payload, db=ps.db, valid=ps.valid, stats=ps.stats())


def test_fresh_build_recall_matches_jax():
    from repro.rag import make_clustered_corpus
    c = make_clustered_corpus(n_docs=1024, dim=64, n_queries=32,
                              n_clusters=16, seed=5)
    exact = np.argsort(((c.queries[:, None, :] - c.db[None]) ** 2).sum(-1),
                       axis=1, kind="stable")[:, :10]

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / 10
                              for a, b in zip(ids, exact)]))

    variants = {
        "quantized_int8": ("quantized", {}),
        "quantized_pq": ("quantized", {"codec": "pq", "pq_iters": 4}),
        "ivf_pq": ("ivf", {"n_lists": 16, "n_probe": 6, "min_index_rows": 32,
                           "use_kernel": True, "stage0_dtype": "pq",
                           "pq_iters": 4}),
    }
    out = {}
    for pkg in ("jax", "port"):
        sched = (j_make_schedule if pkg == "jax" else make_schedule)(
            16, 64, 64, final_k=10)
        store = (JDocStore(64, (16, 32, 64), capacity=1024) if pkg == "jax"
                 else DocStore(64, (16, 32, 64), capacity=1024, device="cpu"))
        store.add(c.db)
        q = jnp.asarray(c.queries) if pkg == "jax" else _t(c.queries)
        for v, (name, opts) in variants.items():
            be = (j_make_backend(name, sched=sched, **opts) if pkg == "jax"
                  else make_backend(name, sched=sched, device="cpu", **opts))
            st = be.build(store.db, store.valid, sq_prefix=store.sq_prefix,
                          stats=store.stats())
            _, ids = be.search(q, st, store.db, store.valid,
                               sq_prefix=store.sq_prefix, n_total=1024, k=10)
            out[(pkg, v)] = recall(np.asarray(ids))
    for v in variants:
        assert out[("port", v)] >= 0.85, out
        assert abs(out[("port", v)] - out[("jax", v)]) <= 0.05, out
