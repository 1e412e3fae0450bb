"""The port's segment sum, graphs and EGNN against the JAX package, on the
CPU.

The same seeded numpy inputs — and the same weights, carried from the JAX
package's ``egnn_init`` pytree through ``models.egnn.load_jax_params`` — go
through both packages at SMOKE_CONFIG size.  The JAX segment-sum kernel
runs in interpret mode behind its sort + CSR wrapper ``segment_sum_op``, as
``tests/test_kernels.py`` runs it.  The CUDA kernel itself is held against
the plain version on the card in ``test_torch_cuda.py``.

Tolerance: segment sums ``rtol=atol=1e-5`` (``1e-4`` for the skewed case,
as the JAX package's own test); EGNN logits and coordinates ``1e-4``
(four layers of MLPs over sums in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.kernels import ref as JREF
from repro.kernels.ops import segment_sum_op
from repro.models import egnn as JE
from repro.models import graph as JG

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import segment_sum as tss
from repro_torch.models import egnn as TE
from repro_torch.models import graph as TG

KEY = jax.random.PRNGKey(0)
CFG = get_arch("egnn").SMOKE_CONFIG
J_CFG = j_get_arch("egnn").SMOKE_CONFIG
EGNN_TOL = 1e-4


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


def params(seed=0):
    jp = JE.egnn_init(jax.random.PRNGKey(seed), J_CFG)
    np_p = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return TE.load_jax_params(np_p, CFG, device="cpu"), jp


def graphs(kind, seed):
    """(torch graph, jax graph) from the same numpy generator state."""
    if kind == "random":
        args = (64, 256, CFG.d_feat_in)
        kw = {"n_classes": CFG.n_classes}
        tg = TG.random_graph(np.random.default_rng(seed), *args, device="cpu",
                             **kw)
        jg = JG.random_graph(np.random.default_rng(seed), *args, **kw)
    else:
        args = (6, 10, 24, CFG.d_feat_in)
        kw = {"n_classes": CFG.n_classes}
        tg = TG.batched_molecules(np.random.default_rng(seed), *args,
                                  device="cpu", **kw)
        jg = JG.batched_molecules(np.random.default_rng(seed), *args, **kw)
    return tg, jg


class TestSegmentSum:
    @pytest.mark.parametrize("e,n,d,bn,ec", [
        (1000, 256, 32, 128, 256),
        (500, 128, 64, 64, 128),
        (2000, 384, 16, 128, 64),
        (50, 128, 8, 128, 32),          # sparse: most segments empty
    ])
    def test_matches_pallas_interpret_and_ref(self, e, n, d, bn, ec):
        rng = np.random.default_rng(e + n)
        data = rng.normal(size=(e, d)).astype(np.float32)
        seg = rng.integers(0, n, e).astype(np.int32)
        seg[: e // 20] = -1             # padded edges
        before = tss.launches
        got = ops.segment_sum(t(data), t(seg), num_segments=n)
        assert tss.launches == before   # the CPU never launches
        assert got.shape == (n, d) and got.dtype == torch.float32
        want = segment_sum_op(jnp.asarray(data), jnp.asarray(seg),
                              num_segments=n, block_n=bn, edge_chunk=ec)
        close(got, want)
        masked = jnp.where((jnp.asarray(seg) >= 0)[:, None],
                           jnp.asarray(data), 0)
        close(got, JREF.segment_sum_ref(masked, jnp.maximum(jnp.asarray(seg),
                                                            0), n))
        close(got, TREF.segment_sum_ref(t(data), t(seg), n))   # -1 dropped

    def test_skewed_degree_distribution(self):
        """Power-law receivers: one node takes half the edges."""
        rng = np.random.default_rng(9)
        e, n, d = 800, 128, 16
        data = rng.normal(size=(e, d)).astype(np.float32)
        seg = np.zeros(e, np.int32)
        seg[e // 2:] = rng.integers(0, n, e - e // 2)
        got = ops.segment_sum(t(data), t(seg), num_segments=n)
        want = segment_sum_op(jnp.asarray(data), jnp.asarray(seg),
                              num_segments=n, block_n=64, edge_chunk=64)
        close(got, want, 1e-4)

    def test_sorted_entry_and_csr(self):
        rng = np.random.default_rng(4)
        n, e = 50, 300
        seg = rng.integers(-1, n + 3, e).astype(np.int32)   # -1 and >= N dropped
        data = rng.normal(size=(e, 3)).astype(np.float32)
        order, seg_s, indptr = tss.sort_by_segment(t(seg), n)
        assert order.dtype == torch.int64 and indptr.dtype == torch.int32
        assert torch.equal(seg_s, torch.sort(seg_s).values)
        live = (seg >= 0) & (seg < n)
        assert int(indptr[-1]) == live.sum() and int(indptr[0]) == 0
        np.testing.assert_array_equal(np.diff(indptr.numpy()),
                                      np.bincount(seg[live], minlength=n))
        got = ops.sorted_segment_sum(t(data)[order], seg_s, indptr,
                                     num_segments=n)
        want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg),
                                   num_segments=n)
        close(got, want)
        ones = ops.sorted_segment_sum(torch.ones(e), seg_s, indptr,
                                      num_segments=n)   # 1-D rows
        assert ones.shape == (n,)
        close(ones, np.diff(indptr.numpy()))

    def test_no_rows(self):
        got = ops.segment_sum(torch.zeros((0, 4)), torch.zeros((0,), dtype=torch.int32),
                              num_segments=5)
        assert got.shape == (5, 4) and not got.any()

    def test_bound_bytes(self):
        assert tss.bound_bytes(torch.zeros((10, 4)), 8, 3) == 8 * 16 + 4 * 4 + 3 * 16


def _indptr_of(lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


class TestMergePathPartition:
    """`merge_path_plain` — the CUDA kernel's task partition and carry /
    fix-up merge, with the wrapper's own `ITEMS` — against the JAX
    package's ``sorted_segment_sum`` (interpret mode, behind
    ``segment_sum_op``) and a float64 sum.

    Tolerances: against float64, ``1e-6`` of each segment's sum of |x|
    (the mirror sums float64 parts and rounds once, so only that rounding
    shows); against the Pallas kernel, ``1e-5`` of the sum of |x| plus
    ``1e-6`` (its float32 accumulation over up to 3,000 rows: about
    sqrt(3000) * 6e-8 = 3e-6 of the sum of |x|), the limit of the card
    check in ``chip_smoke.py``.
    """

    CASES = {
        # one segment spanning many tasks (about 6 wide / 3 narrow ones)
        "hub": lambda items: [5, 0, 3000, 7] + [3] * 40,
        # segment ends at the last entry of a task, and ones whose last row
        # is a task's last entry while the end opens the next task
        "cut_at_edges": lambda items: [items - 1, items - 1, items,
                                       items, 2 * items - 1, 1, 0, 2],
        "all_empty": lambda items: [0] * 50,
        "mostly_empty": lambda items: [0] * 30 + [4] + [0] * 300 + [1, 0, 9],
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("d", [1, 3, 64])
    def test_matches_pallas_interpret(self, case, d):
        items = tss.ITEMS[tss.route(d)]
        lengths = np.array(self.CASES[case](items))
        n = lengths.size
        indptr = _indptr_of(lengths)
        e_live = int(indptr[-1])
        rng = np.random.default_rng(len(case) * 100 + d)
        tail = 37                                # rows past indptr[N]
        data = rng.normal(size=(e_live + tail, d)).astype(np.float32)
        data[e_live:] = np.nan                   # never read
        got = tss.merge_path_plain(t(data), t(indptr), num_segments=n,
                                   items=items)
        assert got.shape == (n, d) and bool(torch.isfinite(got).all())
        seg = np.repeat(np.arange(n), lengths).astype(np.int32)
        live = data[:e_live].astype(np.float64)
        want64 = np.zeros((n, d))
        np.add.at(want64, seg, live)
        scale = np.zeros((n, d))
        np.add.at(scale, seg, np.abs(live))
        assert (np.abs(got.numpy() - want64) <= 1e-6 * scale).all()
        assert not got.numpy()[lengths == 0].any()      # empty segments: 0
        if e_live:
            want = segment_sum_op(jnp.asarray(data[:e_live]), jnp.asarray(seg),
                                  num_segments=n, block_n=128, edge_chunk=256)
            gap = np.abs(got.numpy() - np.asarray(want, np.float64))
            assert (gap <= 1e-5 * scale + 1e-6).all()

    def test_partition_covers_every_entry_once(self):
        """Every row lands in exactly one task and every segment end in
        exactly one: summing ones gives the degrees, for any items."""
        lengths = np.array([0, 7, 1, 0, 0, 20, 3, 0, 11])
        indptr = _indptr_of(lengths)
        ones = torch.ones((int(indptr[-1]), 1))
        for items in (1, 2, 3, 5, 8, 64):
            got = tss.merge_path_plain(ones, t(indptr),
                                       num_segments=lengths.size, items=items)
            np.testing.assert_array_equal(got[:, 0].numpy(), lengths)

    def test_route_and_tasks(self):
        assert [tss.route(d) for d in (1, 3, 4, 5, 64)] == \
            ["narrow"] * 3 + ["wide"] * 2
        assert tss.n_tasks(10, 0, 512) == 1
        assert tss.task_items(64, 100, 5000) == tss.ITEMS["wide"]
        assert tss.task_items(1, 100, 5000) == tss.ITEMS["narrow"]
        assert tss.task_items(64, 100_000, 0) == tss.SPARSE_ITEMS
        assert tss.n_tasks(2_449_029, 61_859_140, 512) == 125_602


class TestGraphs:
    @pytest.mark.parametrize("kind", ["random", "molecules"])
    def test_same_graph_as_the_reference(self, kind):
        tg, jg = graphs(kind, 2)
        for f in dataclasses.fields(tg):
            np.testing.assert_array_equal(getattr(tg, f.name).numpy(),
                                          np.asarray(getattr(jg, f.name)))

    def test_entry_points_raise_without_a_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        rng = np.random.default_rng(0)
        for fn in (lambda: TG.random_graph(rng, 4, 8, 2),
                   lambda: TE.egnn_init(CFG),
                   lambda: TE.load_jax_params({}, CFG)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


class TestEGNN:
    @pytest.mark.parametrize("kind", ["random", "molecules"])
    def test_forward_matches_reference(self, kind):
        p, jp = params()
        tg, jg = graphs(kind, 3)
        logits, x = TE.egnn_forward(p, tg, CFG)
        j_logits, j_x = JE.egnn_forward(jp, jg, J_CFG)
        assert logits.shape == (tg.nodes.shape[0], CFG.n_classes)
        close(logits, j_logits, EGNN_TOL)
        close(x, j_x, EGNN_TOL)

    def test_edge_chunks_do_not_change_the_result(self, monkeypatch):
        p, _ = params()
        tg, _ = graphs("random", 5)
        whole = TE.egnn_forward(p, tg, CFG)
        monkeypatch.setattr(TE, "EDGE_CHUNK_BYTES", 7 * (2 * CFG.d_hidden + 1) * 4)
        chunked = TE.egnn_forward(p, tg, CFG)
        for a, b in zip(whole, chunked):     # matmuls of other row counts
            close(a, b)

    def test_sort_edges_drops_masked_edges(self):
        tg, _ = graphs("random", 6)
        mask = torch.ones_like(tg.edge_mask)
        mask[::3] = False
        es = TE.sort_edges(dataclasses.replace(tg, edge_mask=mask))
        n = tg.nodes.shape[0]
        assert es.senders.shape[0] == int(mask.sum())
        assert torch.equal(es.receivers, torch.sort(es.receivers, stable=True).values)
        assert int(es.indptr[-1]) == int(mask.sum()) and es.indptr.shape == (n + 1,)

    def test_padded_edges_are_noops(self):
        """Adding masked (padded) edges changes no output, and matches the
        reference on the padded graph."""
        p, jp = params()
        tg, jg = graphs("random", 7)
        e = tg.senders.shape[0]
        pad = dataclasses.replace(
            tg,
            senders=torch.cat([tg.senders, torch.full((20,), -1, dtype=torch.int32)]),
            receivers=torch.cat([tg.receivers, torch.full((20,), -1, dtype=torch.int32)]),
            edge_attr=torch.zeros((e + 20, 0)),
            edge_mask=torch.cat([tg.edge_mask, torch.zeros(20, dtype=torch.bool)]))
        j_pad = dataclasses.replace(
            jg, senders=jnp.asarray(pad.senders.numpy()),
            receivers=jnp.asarray(pad.receivers.numpy()),
            edge_attr=jnp.zeros((e + 20, 0)),
            edge_mask=jnp.asarray(pad.edge_mask.numpy()))
        l1, x1 = TE.egnn_forward(p, tg, CFG)
        l2, x2 = TE.egnn_forward(p, pad, CFG)
        close(l1, l2)
        close(x1, x2)
        j_l, j_x = JE.egnn_forward(jp, j_pad, J_CFG)
        close(l2, j_l, EGNN_TOL)
        close(x2, j_x, EGNN_TOL)

    def test_equivariance(self):
        """E(3): rotating and translating the input coordinates rotates the
        output coordinates and leaves the logits unchanged."""
        p, _ = params()
        tg, _ = graphs("random", 8)
        rng = np.random.default_rng(8)
        q = t(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
        shift = t(rng.normal(size=(3,)).astype(np.float32))
        l1, x1 = TE.egnn_forward(p, tg, CFG)
        l2, x2 = TE.egnn_forward(
            p, dataclasses.replace(tg, coords=tg.coords @ q + shift), CFG)
        close(l1, l2, 2e-3)
        close(x1 @ q + shift, x2, 2e-3)

    def test_init_on_cpu(self):
        p = TE.egnn_init(CFG, seed=1, device="cpu")
        _, jp = params()
        assert [tuple(w.shape) for w in p["layers"][0]["phi_e"].w] == \
            [l["w"].shape for l in jp["layers"][0]["phi_e"]]
        tg, _ = graphs("molecules", 1)
        logits, _ = TE.egnn_forward(p, tg, CFG)
        assert bool(torch.isfinite(logits).all())
