"""The port's IVF path against the JAX package on the same seeded inputs.

Covers `kernels/ivf_scan.py` (the plain scan against the Pallas kernel in
interpret mode and both oracles, float32 and int8 slabs; `pack_ivf_lists`
and `update_pack`), `core/ivf.py`
(`balanced_assign`, `pack_lists`, the sched and kernel routes) and the
``ivf`` backend: states built by the JAX package are carried over through
``state_dict`` → the port's ``load_state`` and searched by both packages,
through the tail window, deletes and ``absorb_appends`` (PQ slabs and the
list-major PQ scan: `test_torch_quant_pq.py`).  Fresh port builds
(whose k-means draws differ from ``jax.random``) are compared on recall.

Tolerance: scores ``rtol=1e-5, atol=1e-4`` — float32 products summed in
another order by XLA / the Pallas interpreter and by torch.  Ids equal up
to near-ties (where two ids differ their scores agree within the
tolerance); the (+inf, -1) sentinels identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp

from repro.core import make_schedule as j_make_schedule
from repro.core import ivf as JI
from repro.engine import DocStore as JDocStore
from repro.index_backends import make_backend as j_make_backend
from repro.kernels import ivf_scan as JK
from repro.kernels import ref as JR

from repro_torch.core import make_schedule
from repro_torch.core import ivf as PI
from repro_torch.engine import DocStore
from repro_torch.index_backends import make_backend
from repro_torch.kernels import ivf_scan as PK
from repro_torch.kernels import ops
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


def _random_lists(rng, n, n_lists, max_len, coverage=0.9):
    """(n_lists, max_len) member table of distinct ids, -1 padded."""
    ids = rng.permutation(n)[: int(n * coverage)]
    table = np.full((n_lists, max_len), -1, np.int32)
    for j, chunk in enumerate(np.array_split(ids, n_lists)):
        chunk = chunk[:max_len]
        table[j, : len(chunk)] = chunk
    return table


@pytest.fixture(scope="module")
def slabs():
    rng = np.random.default_rng(5)
    n, n_lists, max_len, d0 = 240, 12, 24, 16
    db = rng.normal(size=(n, D)).astype(np.float32)
    lists = _random_lists(rng, n, n_lists, max_len)
    lists[3] = -1                                       # an empty list
    valid = rng.random(n) > 0.2
    masked = np.where((lists >= 0) & valid[np.maximum(lists, 0)], lists,
                      -1).astype(np.int32)
    q = rng.normal(size=(6, D)).astype(np.float32)
    probe = np.stack([rng.choice(n_lists, 5, replace=False)
                      for _ in range(6)]).astype(np.int32)
    probe[0, :2] = [3, 3 + 1]                           # probes the empty list
    return dict(rng=rng, db=db, lists=lists, valid=valid, masked=masked, q=q,
                probe=probe, d0=d0, n_lists=n_lists)


class TestIvfScanPlain:
    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_pack_matches(self, slabs, dtype):
        s = slabs
        jp = JK.pack_ivf_lists(jnp.asarray(s["db"]), jnp.asarray(s["lists"]),
                               dim=s["d0"], dtype=dtype, block_m=16)
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               dtype=dtype, block_m=16)
        assert (pp["dim"], pp["max_len"], pp["block_m"], pp["dtype"]) == \
            (jp["dim"], jp["max_len"], jp["block_m"], jp["dtype"]) == \
            (s["d0"], 32, 16, dtype)
        if dtype == "int8":
            np.testing.assert_array_equal(pp["rows"].numpy(),
                                          np.asarray(jp["rows"]))
            np.testing.assert_allclose(pp["scale"].numpy(),
                                       np.asarray(jp["scale"]), rtol=RTOL)
        else:
            np.testing.assert_array_equal(pp["rows"].numpy(),
                                          np.asarray(jp["rows"]))
        js = np.asarray(jp["sq"])
        np.testing.assert_array_equal(np.isinf(pp["sq"].numpy()), np.isinf(js))
        fin = np.isfinite(js)
        np.testing.assert_allclose(pp["sq"].numpy()[fin], js[fin],
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("dtype,k", [("float32", 10), ("int8", 10),
                                         ("float32", 150)])  # k > rows scanned
    def test_scan_matches_pallas_and_oracle(self, slabs, dtype, k):
        s = slabs
        jp = JK.pack_ivf_lists(jnp.asarray(s["db"]), jnp.asarray(s["lists"]),
                               dim=s["d0"], dtype=dtype, block_m=16)
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               dtype=dtype, block_m=16)
        want = JK.ivf_scan_topk(jnp.asarray(s["q"]), jnp.asarray(s["probe"]),
                                jnp.asarray(s["masked"]), jp, k=k,
                                interpret=True)
        got = ops.ivf_scan_topk(_t(s["q"]), _t(s["probe"]), _t(s["masked"]),
                                pp, k=k)
        assert_topk_close(got, want)
        ids = got[1].numpy()
        assert s["valid"][ids[ids >= 0]].all()          # no tombstone back
        if k > 5 * 24:
            assert (ids[:, 5 * 24:] == -1).all()
        if dtype == "float32" and k <= 5 * 24:
            pr = PR.ivf_scan_ref(_t(s["q"]), _t(s["db"]), _t(s["masked"]),
                                 _t(s["probe"]), dim=s["d0"], k=k)
            jr = JR.ivf_scan_ref(jnp.asarray(s["q"]), jnp.asarray(s["db"]),
                                 jnp.asarray(s["masked"]),
                                 jnp.asarray(s["probe"]), dim=s["d0"], k=k)
            assert_topk_close(got, pr)
            assert_topk_close(pr, jr)

    def test_all_members_masked(self, slabs):
        s = slabs
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               block_m=16)
        none = torch.full_like(_t(s["masked"]), -1)
        sc, ids = ops.ivf_scan_topk(_t(s["q"]), _t(s["probe"]), none, pp, k=7)
        assert (ids == -1).all() and torch.isinf(sc).all()

    def test_ties_keep_scan_order(self):
        # duplicate rows score equal: the earlier probe rank, then the
        # earlier slot wins, as lax.top_k orders the probed-list table
        db = np.zeros((6, 4), np.float32)
        db[:, 0] = [1, 1, 2, 1, 1, 0]
        lists = np.array([[0, 1, -1], [2, 3, 4], [5, -1, -1]], np.int32)
        pp = PK.pack_ivf_lists(_t(db), _t(lists), dim=4, block_m=3)
        jp = JK.pack_ivf_lists(jnp.asarray(db), jnp.asarray(lists), dim=4,
                               block_m=3)
        q = np.zeros((1, 4), np.float32)
        probe = np.array([[1, 0, 2]], np.int32)
        got = ops.ivf_scan_topk(_t(q), _t(probe), _t(lists), pp, k=6)
        want = JK.ivf_scan_topk(jnp.asarray(q), jnp.asarray(probe),
                                jnp.asarray(lists), jp, k=6, interpret=True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].numpy().tolist() == [[5, 3, 4, 0, 1, 2]]

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_update_pack_matches(self, slabs, dtype):
        s = slabs
        jp = JK.pack_ivf_lists(jnp.asarray(s["db"]), jnp.asarray(s["lists"]),
                               dim=s["d0"], dtype=dtype, block_m=16)
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               dtype=dtype, block_m=16)
        ids = np.array([7, 19, 3], np.int32)
        dests = np.array([3 * 32 + 0, 3 * 32 + 1, 11 * 32 + 30], np.int64)
        jp2 = JK.update_pack(jp, jnp.asarray(s["db"]), ids, dests)
        pp2 = PK.update_pack(pp, _t(s["db"]), ids, dests)
        assert pp2["rows"] is pp["rows"]                  # written in place
        np.testing.assert_allclose(pp2["rows"].numpy().astype(np.float32),
                                   np.asarray(jp2["rows"]).astype(np.float32),
                                   rtol=RTOL, atol=ATOL)
        js = np.asarray(jp2["sq"])
        fin = np.isfinite(js)
        np.testing.assert_allclose(pp2["sq"].numpy()[fin], js[fin],
                                   rtol=RTOL, atol=ATOL)


class TestIvfScanValidRoute:
    """The scan given the raw member table and the store's validity bits
    (as a dispatch calls it; the CUDA kernel reads ``valid`` per slot, the
    plain version masks the table first) against ``repro``'s mask-then-scan
    (the Pallas kernel in interpret mode on the masked table)."""

    @pytest.mark.parametrize("dtype,k", [("float32", 10), ("int8", 10),
                                         ("float32", 150), ("int8", 150)])
    def test_valid_route_is_mask_then_scan(self, slabs, dtype, k):
        s = slabs
        jp = JK.pack_ivf_lists(jnp.asarray(s["db"]), jnp.asarray(s["lists"]),
                               dim=s["d0"], dtype=dtype, block_m=16)
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               dtype=dtype, block_m=16)
        got = ops.ivf_scan_topk(_t(s["q"]), _t(s["probe"]), _t(s["lists"]),
                                pp, k=k, valid=_t(s["valid"]))
        pre = ops.ivf_scan_topk(_t(s["q"]), _t(s["probe"]), _t(s["masked"]),
                                pp, k=k)
        assert torch.equal(got[0], pre[0]) and torch.equal(got[1], pre[1])
        want = JK.ivf_scan_topk(jnp.asarray(s["q"]), jnp.asarray(s["probe"]),
                                jnp.asarray(s["masked"]), jp, k=k,
                                interpret=True)
        assert_topk_close(got, want)
        ids = got[1].numpy()
        assert s["valid"][ids[ids >= 0]].all()

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_dead_lists_n_probe_one_and_k_above_live(self, slabs, dtype):
        """Query 0 probes only dead lists (one empty, one whose members are
        all tombstoned): all (+inf, -1); n_probe 1; k above the live rows
        of every query."""
        s = slabs
        valid = s["valid"].copy()
        valid[s["lists"][5][s["lists"][5] >= 0]] = False
        masked = np.where((s["lists"] >= 0) & valid[np.maximum(s["lists"], 0)],
                          s["lists"], -1).astype(np.int32)
        jp = JK.pack_ivf_lists(jnp.asarray(s["db"]), jnp.asarray(s["lists"]),
                               dim=s["d0"], dtype=dtype, block_m=16)
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               dtype=dtype, block_m=16)
        for probe in (s["probe"][:, :1].copy(), s["probe"][:, :2].copy()):
            probe[0] = [3, 5][:probe.shape[1]]
            k = 2 * 24 + 5                               # above any live count
            got = ops.ivf_scan_topk(_t(s["q"]), _t(probe), _t(s["lists"]),
                                    pp, k=k, valid=_t(valid))
            want = JK.ivf_scan_topk(jnp.asarray(s["q"]), jnp.asarray(probe),
                                    jnp.asarray(masked), jp, k=k,
                                    interpret=True)
            assert_topk_close(got, want)
            assert (got[1][0] == -1).all() and torch.isinf(got[0][0]).all()
            n_live = (masked[probe] >= 0).sum(axis=(1, 2))
            np.testing.assert_array_equal((got[1].numpy() == -1).sum(1),
                                          k - n_live)

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_ties_by_probe_rank_then_slot(self, dtype):
        # duplicate rows score equal: the earlier probe rank, then the
        # earlier slot wins; id 3 is tombstoned through ``valid``
        db = np.zeros((6, 4), np.float32)
        db[:, 0] = [1, 1, 2, 1, 1, 0]
        lists = np.array([[0, 1, -1], [2, 3, 4], [5, -1, -1]], np.int32)
        valid = np.array([1, 1, 1, 0, 1, 1], bool)
        masked = np.where((lists >= 0) & valid[np.maximum(lists, 0)], lists,
                          -1).astype(np.int32)
        pp = PK.pack_ivf_lists(_t(db), _t(lists), dim=4, block_m=3,
                               dtype=dtype)
        jp = JK.pack_ivf_lists(jnp.asarray(db), jnp.asarray(lists), dim=4,
                               block_m=3, dtype=dtype)
        q = np.zeros((1, 4), np.float32)
        probe = np.array([[1, 0, 2]], np.int32)
        got = ops.ivf_scan_topk(_t(q), _t(probe), _t(lists), pp, k=6,
                                valid=_t(valid))
        want = JK.ivf_scan_topk(jnp.asarray(q), jnp.asarray(probe),
                                jnp.asarray(masked), jp, k=6, interpret=True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].numpy().tolist() == [[5, 4, 0, 1, 2, -1]]

    def test_dispatch_passes_raw_lists_and_valid(self, slabs):
        """``_kernel_search`` hands the scan the raw member table and the
        validity bits: it builds no masked table of its own."""
        import types
        s = slabs
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               block_m=16)
        seen = []

        def scan(q, probe, member_ids, pack, *, k, valid=None):
            seen.append((member_ids, valid))
            return PK.ivf_scan_topk_plain(q, probe, member_ids, pack, k=k,
                                          valid=valid)

        impl = types.SimpleNamespace(**vars(ops.plain))
        impl.ivf_scan_topk = scan
        lists, valid = _t(s["lists"]), _t(s["valid"])
        cents = torch.randn((s["n_lists"], s["d0"]),
                            generator=torch.Generator().manual_seed(0))
        sched = make_schedule(s["d0"], D, 8)
        sc, ids = PI._kernel_search(
            _t(s["q"]), _t(s["db"]), cents, lists, sched, n_probe=4,
            valid=valid, sq_prefix=None, index_dims=None, extra_cand=None,
            metric="l2", cent_sq=None, pack=pp, pq_oversample=1,
            stage0_only=True, impl=impl)
        assert len(seen) == 1
        assert seen[0][0] is lists and seen[0][1] is valid
        assert sc.shape == (6, 8)
        out = ids.numpy()
        assert s["valid"][out[out >= 0]].all()


class TestIvfScanMirror:
    """`ivf_scan.ivf_scan_mirror` — the CUDA kernel's arithmetic on the CPU:
    the query folded as the kernel's prologue folds it, each row's dot
    product one FMA chain in dim order from its first product
    (`fma_chain_dots`), ``sq − 2·dot``.  Held against ``repro``'s Pallas
    kernel in interpret mode and the plain version within this file's
    tolerance (both sum in another order)."""

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    @pytest.mark.parametrize("k", [10, 150])
    def test_close_to_pallas_and_plain(self, slabs, dtype, k):
        s = slabs
        jp = JK.pack_ivf_lists(jnp.asarray(s["db"]), jnp.asarray(s["lists"]),
                               dim=s["d0"], dtype=dtype, block_m=16)
        pp = PK.pack_ivf_lists(_t(s["db"]), _t(s["lists"]), dim=s["d0"],
                               dtype=dtype, block_m=16)
        got = PK.ivf_scan_mirror(_t(s["q"]), _t(s["probe"]), _t(s["lists"]),
                                 pp, k=k, valid=_t(s["valid"]))
        want = JK.ivf_scan_topk(jnp.asarray(s["q"]), jnp.asarray(s["probe"]),
                                jnp.asarray(s["masked"]), jp, k=k,
                                interpret=True)
        assert_topk_close(got, want)
        plain = PK.ivf_scan_topk_plain(_t(s["q"]), _t(s["probe"]),
                                       _t(s["lists"]), pp, k=k,
                                       valid=_t(s["valid"]))
        assert_topk_close(got, plain)

    def test_fma_chain_is_the_chain(self):
        """The chain's first term is the rounded first product and each
        step one rounding of acc + x·q (a float64 sum of a product exact in
        float64); against a float64 dot it differs by float32 rounding
        only."""
        rng = np.random.default_rng(3)
        qd = rng.normal(size=(3, 7)).astype(np.float32)
        rows = rng.normal(size=(3, 5, 7)).astype(np.float32)
        got = PK.fma_chain_dots(_t(qd), _t(rows)).numpy()
        acc = (rows[..., 0].astype(np.float64)
               * qd[:, None, 0].astype(np.float64)).astype(np.float32)
        for d in range(1, 7):
            acc = (acc.astype(np.float64) + rows[..., d].astype(np.float64)
                   * qd[:, None, d].astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(got, acc)
        exact = np.einsum("qd,qcd->qc", qd.astype(np.float64),
                          rows.astype(np.float64))
        np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)


class TestHostPacking:
    def test_balanced_assign_and_pack_lists_identical(self):
        rng = np.random.default_rng(9)
        n, n_lists, m = 500, 16, 4
        choices = np.stack([rng.permutation(n_lists)[:m] for _ in range(n)])
        order = rng.permutation(n)
        for cap in (32, 40, n):
            a = PI.balanced_assign(choices, order, n_lists, cap)
            np.testing.assert_array_equal(
                a, JI.balanced_assign(choices, order, n_lists, cap))
            ids = rng.permutation(10 * n)[:n]
            for spare, pow2 in ((0, False), (3, True)):
                np.testing.assert_array_equal(
                    PI.pack_lists(a, n_lists, ids=ids, spare=spare,
                                  round_pow2=pow2),
                    JI.pack_lists(a, n_lists, ids=ids, spare=spare,
                                  round_pow2=pow2))
        with pytest.raises(ValueError):
            PI.balanced_assign(choices, order, n_lists, 8)

    def test_stage0_bytes_models_match(self):
        from repro.kernels import pq_scan as JPQ
        from repro_torch.kernels import pq_scan as PPQ
        for kw in (dict(member_bytes=4), dict(member_bytes=1),
                   dict(row_bytes=16, lut_bytes=16384.0, norms=False)):
            args = dict(n_lists=4096, max_len=512, n_probe=12, d0=128, k=64)
            assert PK.stage0_bytes_model(**args, **kw) == \
                JK.stage0_bytes_model(**args, **kw)
        assert PPQ.flat_stage0_bytes_model(n=1 << 20, k=256, row_bytes=16,
                                           lut_bytes=16384.0) == \
            JPQ.flat_stage0_bytes_model(n=1 << 20, k=256, row_bytes=16,
                                        lut_bytes=16384.0)


# -- backends: JAX-built states carried into the port ------------------------

IVF_BASE = dict(n_lists=12, n_probe=6, min_index_rows=32, min_rebuild_rows=16,
                append_spare=2, kernel_block_m=16)
VARIANTS = {
    "ivf_auto": {},                                  # CPU: the sched route
    "ivf_false": dict(use_kernel=False),
    "ivf_kernel": dict(use_kernel=True),
    "ivf_int8": dict(use_kernel=True, stage0_dtype="int8"),
}
# the ivf backend with PQ slabs is carried over in test_torch_quant_pq.py


def _stores(rng, n):
    docs = rng.normal(size=(n, D)).astype(np.float32)
    js = JDocStore(D, DIMS, capacity=256)
    ps = DocStore(D, DIMS, capacity=256, device="cpu")
    js.add(docs)
    ps.add(docs)
    return js, ps, docs


def _search_both(jb, jstate, js, pb, pstate, ps, q, k=4):
    want = jb.search(jnp.asarray(q), jstate, js.db, js.valid,
                     sq_prefix=js.sq_prefix, n_total=js.size, k=k)
    got = pb.search(_t(q), pstate, ps.db, ps.valid, sq_prefix=ps.sq_prefix,
                    n_total=ps.size, k=k)
    assert_topk_close(got, want)
    return got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_carried_state_searches_alike(variant):
    rng = np.random.default_rng(17)
    opts = {**IVF_BASE, **VARIANTS[variant]}
    js, ps, docs = _stores(rng, 160)
    jsched = j_make_schedule(8, D, 16, final_k=4)
    psched = make_schedule(8, D, 16, final_k=4)
    jb = j_make_backend("ivf", sched=jsched, **opts)
    pb = make_backend("ivf", sched=psched, device="cpu", **opts)
    for st in (js, ps):
        st.delete([4, 9, 33])
    jstate = jb.build(js.db, js.valid, sq_prefix=js.sq_prefix,
                      stats=js.stats())
    pstate = pb.load_state(jb.state_dict(jstate), db=ps.db, valid=ps.valid,
                           sq_prefix=ps.sq_prefix, stats=ps.stats())
    pack = pstate.data["pack"]
    if variant in ("ivf_auto", "ivf_false"):
        assert pack is None
    else:
        assert pack["rows"].dtype == {"ivf_kernel": torch.float32,
                                      "ivf_int8": torch.int8}[variant]
    assert pstate.data["lists"].dtype == torch.int32
    q = docs[::20] + 0.05 * rng.normal(size=(8, D)).astype(np.float32)
    got = _search_both(jb, jstate, js, pb, pstate, ps, q)
    assert not np.isin(got[1].numpy(), [4, 9, 33]).any()

    # appends: first through the tail window, then absorbed into the same
    # list slots by both packages; a deleted absorbed row never comes back
    new = rng.normal(size=(30, D)).astype(np.float32) * 3
    js.add(new)
    ps.add(new)
    _search_both(jb, jstate, js, pb, pstate, ps, new[:8])
    for be, st, state in ((jb, js, jstate), (pb, ps, pstate)):
        be.absorb_appends(state, st.db, st.valid, sq_prefix=st.sq_prefix,
                          stats=st.stats())
    np.testing.assert_array_equal(pstate.data["lists"].numpy(),
                                  np.asarray(jstate.data["lists"]))
    np.testing.assert_array_equal(pstate.data["tail_pending"],
                                  jstate.data["tail_pending"])
    if pack is not None:
        np.testing.assert_allclose(
            pstate.data["pack"]["rows"].numpy().astype(np.float32),
            np.asarray(jstate.data["pack"]["rows"]).astype(np.float32),
            rtol=RTOL, atol=ATOL)
    for st in (js, ps):
        st.delete([160, 161])
    got = _search_both(jb, jstate, js, pb, pstate, ps, new[:8])
    assert not np.isin(got[1].numpy(), [160, 161]).any()
    assert pb.gauges(pstate, ps.stats()) == pytest.approx(
        jb.gauges(jstate, js.stats()))


def test_port_state_loads_into_jax():
    rng = np.random.default_rng(23)
    opts = {**IVF_BASE, "use_kernel": True, "stage0_dtype": "int8"}
    js, ps, docs = _stores(rng, 150)
    jsched = j_make_schedule(8, D, 16, final_k=4)
    psched = make_schedule(8, D, 16, final_k=4)
    jb = j_make_backend("ivf", sched=jsched, **opts)
    pb = make_backend("ivf", sched=psched, device="cpu", **opts)
    pstate = pb.build(ps.db, ps.valid, sq_prefix=ps.sq_prefix,
                      stats=ps.stats())
    payload = pb.state_dict(pstate)
    jstate = jb.load_state(payload, db=js.db, valid=js.valid,
                           sq_prefix=js.sq_prefix, stats=js.stats())
    assert payload["arrays"]["pack/rows"].dtype == np.int8
    _search_both(jb, jstate, js, pb, pstate, ps, docs[:9] + 0.01)


def test_gather_route_state_needs_kernel_grid():
    rng = np.random.default_rng(29)
    js, ps, _ = _stores(rng, 120)
    jsched = j_make_schedule(8, D, 16, final_k=4)
    psched = make_schedule(8, D, 16, final_k=4)
    jb = j_make_backend("ivf", sched=jsched, **IVF_BASE)       # no pack
    payload = jb.state_dict(jb.build(js.db, js.valid, sq_prefix=js.sq_prefix,
                                     stats=js.stats()))
    kw = dict(db=ps.db, valid=ps.valid, sq_prefix=ps.sq_prefix,
              stats=ps.stats())
    # float32 slabs are packed from the store's rows at load ...
    pb = make_backend("ivf", sched=psched, device="cpu", use_kernel=True,
                      **IVF_BASE)
    state = pb.load_state(payload, **kw)
    assert state.data["pack"]["rows"].shape == (
        state.data["n_lists"] * state.data["max_len"], 8)
    # ... int8 slabs need the grid fitted at build time
    pb8 = make_backend("ivf", sched=psched, device="cpu", use_kernel=True,
                       stage0_dtype="int8", **IVF_BASE)
    with pytest.raises(ValueError, match="use_kernel=True"):
        pb8.load_state(payload, **kw)


def test_kernel_and_sched_routes_agree_under_fixed_probes():
    """The kernel route (scan + tail merge) returns what the sched route
    returns on the same state, in both packages."""
    rng = np.random.default_rng(31)
    docs = rng.normal(size=(200, D)).astype(np.float32)
    db = _t(docs)
    ivf = PI.build_ivf(db, 10, seed=3, n_iter=4)
    sched = make_schedule(8, D, 16, final_k=4)
    q = _t(docs[:7] + 0.02)
    tail = torch.tensor([195, 196, -1, -1], dtype=torch.int32)
    valid = torch.ones(200, dtype=torch.bool)
    valid[[2, 3, 196]] = False
    kw = dict(n_probe=4, valid=valid, extra_cand=tail)
    a = PI.ivf_progressive_search_sched(q, db, ivf["centroids"],
                                        ivf["lists"], sched, **kw)
    b = PI.ivf_progressive_search_kernel(q, db, ivf["centroids"],
                                         ivf["lists"], sched, block_m=16,
                                         **kw)
    c = PI.ivf_progressive_search_kernel_plain(
        q, db, ivf["centroids"], ivf["lists"], sched, block_m=16, **kw)
    assert_topk_close(a, b)
    assert_topk_close(b, c)
    jsched = j_make_schedule(8, D, 16, final_k=4)
    jkw = dict(n_probe=4, valid=jnp.asarray(valid.numpy()),
               extra_cand=jnp.asarray(tail.numpy()))
    j = JI.ivf_progressive_search_kernel(
        jnp.asarray(q.numpy()), jnp.asarray(docs),
        jnp.asarray(ivf["centroids"].numpy()),
        jnp.asarray(ivf["lists"].numpy()), jsched, block_m=16,
        interpret=True, **jkw)
    assert_topk_close(b, j)


def test_ivf_search_helpers_match_jax():
    """`ivf_search` and `ivf_progressive_search` on one index, in both
    packages, with tombstones."""
    rng = np.random.default_rng(37)
    docs = rng.normal(size=(160, D)).astype(np.float32)
    ivf = PI.build_ivf(_t(docs), 8, seed=1, n_iter=3)
    jivf = {key: jnp.asarray(v.numpy()) for key, v in ivf.items()}
    q = docs[:5] + 0.05 * rng.normal(size=(5, D)).astype(np.float32)
    valid = np.ones(160, bool)
    valid[[1, 2, 40]] = False
    got = PI.ivf_search(_t(q), _t(docs), ivf, n_probe=3, k=6, dim=16,
                        valid=_t(valid))
    want = JI.ivf_search(jnp.asarray(q), jnp.asarray(docs), jivf, n_probe=3,
                         k=6, dim=16, valid=jnp.asarray(valid))
    assert_topk_close(got, want)
    got = PI.ivf_progressive_search(_t(q), _t(docs), ivf, n_probe=3, k=4,
                                    d_probe=8, d_final=D, valid=_t(valid))
    want = JI.ivf_progressive_search(
        jnp.asarray(q), jnp.asarray(docs), jivf, n_probe=3, k=4, d_probe=8,
        d_final=D, valid=jnp.asarray(valid))
    assert_topk_close(got, want)
    assert not np.isin(np.asarray(got[1]), [1, 2, 40]).any()


def test_fresh_build_recall_matches_jax():
    from repro.rag import make_clustered_corpus
    c = make_clustered_corpus(n_docs=1024, dim=64, n_queries=32,
                              n_clusters=16, seed=5)
    exact = np.argsort(((c.queries[:, None, :] - c.db[None]) ** 2).sum(-1),
                       axis=1, kind="stable")[:, :10]
    opts = dict(n_lists=16, n_probe=6, min_index_rows=32)

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / 10
                              for a, b in zip(ids, exact)]))

    jsched = j_make_schedule(16, 64, 64, final_k=10)
    psched = make_schedule(16, 64, 64, final_k=10)
    out = {}
    for name, mk, sched, wrap in (
            ("jax", j_make_backend, jsched, jnp.asarray),
            ("port", lambda *a, **k: make_backend(*a, device="cpu", **k),
             psched, _t)):
        store = (JDocStore(64, (16, 32, 64), capacity=1024) if name == "jax"
                 else DocStore(64, (16, 32, 64), capacity=1024, device="cpu"))
        store.add(c.db)
        for variant in ({}, {"use_kernel": True, "stage0_dtype": "int8"}):
            be = mk("ivf", sched=sched, **opts, **variant)
            st = be.build(store.db, store.valid, sq_prefix=store.sq_prefix,
                          stats=store.stats())
            _, ids = be.search(wrap(c.queries), st, store.db, store.valid,
                               sq_prefix=store.sq_prefix, n_total=1024, k=10)
            out[(name, bool(variant))] = recall(np.asarray(ids))
    for int8 in (False, True):
        assert out[("port", int8)] >= 0.85
        assert abs(out[("port", int8)] - out[("jax", int8)]) <= 0.05, out
