"""The port's embedding bag and recsys models against the JAX package, on
the CPU.

The same seeded numpy inputs — and the same weights, carried from the JAX
package's ``recsys_init`` pytree through ``models.recsys.load_jax_params``
— go through both packages at SMOKE_CONFIG size.  The JAX embedding-bag
kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.  The
CUDA kernel itself is held against the plain version on the card in
``test_torch_cuda.py``.

Tolerance: ``rtol=atol=1e-5`` (XLA and torch sum in other orders);
retrieval ids equal up to ties.
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
from repro.data import synth as JS
from repro.kernels import ref as JREF
from repro.kernels.embedding_bag import embedding_bag as pallas_embedding_bag
from repro.models import recsys as JR

from repro_torch.configs import family_of, get_arch
from repro_torch.data import synth as TS
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ops
from repro_torch.models import recsys as TR

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
ARCHS = ["two-tower-retrieval", "din", "autoint", "dlrm-rm2"]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


def both(arch, seed=0):
    """(torch params, jax params, cfg) of the smoke config, same weights."""
    cfg = get_arch(arch).SMOKE_CONFIG
    jcfg = j_get_arch(arch).SMOKE_CONFIG
    jp = JR.recsys_init(jax.random.PRNGKey(seed), jcfg)
    np_p = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return TR.load_jax_params(np_p, cfg, device="cpu"), jp, jcfg


def batch_of(arch, batch, seed=1):
    cfg = get_arch(arch).SMOKE_CONFIG
    rng = np.random.default_rng(seed)
    return next(JS.recsys_batch_stream(
        rng, cfg.family, batch, n_sparse=cfg.n_sparse,
        multi_hot=cfg.multi_hot, vocab=cfg.vocab_per_field,
        n_dense=cfg.n_dense, seq_len=cfg.seq_len))


class TestConfigs:
    @pytest.mark.parametrize("arch", ARCHS + ["egnn"])
    def test_configs_copy_the_reference(self, arch):
        for name in ("CONFIG", "SMOKE_CONFIG"):
            assert dataclasses.asdict(getattr(get_arch(arch), name)) == \
                dataclasses.asdict(getattr(j_get_arch(arch), name))
        assert {k: dataclasses.asdict(v)
                for k, v in get_arch(arch).SHAPES.items()} == \
            {k: dataclasses.asdict(v)
             for k, v in j_get_arch(arch).SHAPES.items()}

    def test_registry_families(self):
        assert [family_of(a) for a in ARCHS] == ["recsys"] * 4
        assert family_of("egnn") == "gnn"
        assert family_of("mistral-nemo-12b") == "lm"


class TestBatchStream:
    @pytest.mark.parametrize("family", ["two_tower", "din", "dlrm"])
    def test_same_batches_as_the_reference(self, family):
        kw = dict(n_sparse=6, vocab=997, n_dense=13, seq_len=7, multi_hot=2)
        a = TS.recsys_batch_stream(np.random.default_rng(3), family, 16, **kw)
        b = JS.recsys_batch_stream(np.random.default_rng(3), family, 16, **kw)
        for _ in range(2):
            x, y = next(a), next(b)
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


class TestEmbeddingBag:
    @pytest.mark.parametrize("v,d,b,l,bb", [
        (100, 32, 16, 4, 8),
        (500, 64, 10, 7, 4),
        (50, 128, 4, 1, 2),
        (64, 16, 6, 100, 2),             # long padded bags
    ])
    @pytest.mark.parametrize("mode", ["sum", "mean"])
    def test_matches_pallas_interpret_and_ref(self, v, d, b, l, bb, mode):
        rng = np.random.default_rng(v + l)
        table = rng.normal(size=(v, d)).astype(np.float32)
        idx = rng.choice(v, size=(b, l)).astype(np.int32)
        idx[-1, l // 2:] = -1
        idx[0, :] = -1                   # an all-padding bag
        before = teb.launches
        got = ops.embedding_bag(t(table), t(idx), mode=mode)
        assert teb.launches == before    # the CPU never launches
        assert got.dtype == torch.float32 and got.shape == (b, d)
        want = pallas_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                    mode=mode, block_b=bb, interpret=True)
        close(got, want)
        close(got, JREF.embedding_bag_ref(jnp.asarray(table),
                                          jnp.asarray(idx), mode=mode))
        assert not got[0].any()          # an empty bag gives 0

    @pytest.mark.parametrize("mode", ["sum", "mean", "max"])
    def test_stacked_tables_with_weights_and_clamp(self, mode):
        rng = np.random.default_rng(5)
        f, v, d, b, l = 3, 40, 8, 9, 5
        tabs = rng.normal(size=(f, v, d)).astype(np.float32)
        ids = rng.integers(-1, v, size=(b, f, l)).astype(np.int32)
        ids[2, 1, 0] = v + 7             # out of range: reads row V - 1
        ids[4, 0, :] = -1
        w = rng.random(size=(b, f, l)).astype(np.float32)
        got = ops.embedding_bag(t(tabs), t(ids), mode=mode)
        for i in range(f):
            want = JREF.embedding_bag_ref(jnp.asarray(tabs[i]),
                                          jnp.asarray(ids[:, i]), mode=mode)
            close(got[:, i], want)
        if mode != "max":
            from repro_torch.kernels.ref import embedding_bag_ref
            got_w = embedding_bag_ref(t(tabs), t(ids), mode=mode,
                                      weights=t(w))
            for i in range(f):
                close(got_w[:, i], JREF.embedding_bag_ref(
                    jnp.asarray(tabs[i]), jnp.asarray(ids[:, i]), mode=mode,
                    weights=jnp.asarray(w[:, i])))

    def test_id_beyond_vocab_reads_the_last_row(self):
        table = np.arange(12, dtype=np.float32).reshape(4, 3)
        ids = np.array([[5, -1], [3, 9]], np.int32)
        got = ops.embedding_bag(t(table), t(ids), mode="sum")
        close(got, [table[3], table[3] * 2])
        close(got, JREF.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids)))
        tabs = np.stack([table, table + 100])
        e = TR.embed_fields(t(tabs), t(np.array([[[7], [4]]], np.int32)))
        close(e, JR.embed_fields(jnp.asarray(tabs),
                                 jnp.asarray(np.array([[[7], [4]]], np.int32))))

    def test_bound_bytes_counts_distinct_rows(self):
        tabs = torch.zeros((2, 10, 4))
        ids = torch.tensor([[[1, 1, -1], [1, 12, 9]]], dtype=torch.int32)
        # rows (0,1), (1,1), (1,9) once each; 6 ids; one (1, 2, 4) output
        assert teb.bound_bytes(tabs, ids) == 3 * 16 + 6 * 4 + 2 * 16

    def test_dlrm_shape_matches_pallas_and_ref(self):
        """26 fields of one id a bag (DLRM-RM2's layout, its batch stream's
        ids): each bag is 0 + its row, so the plain version equals the
        Pallas kernel (interpret mode) and the oracle exactly, field by
        field (tolerance 0)."""
        f, v, d, b = 26, 60, 64, 6
        rng = np.random.default_rng(26)
        tabs = rng.normal(size=(f, v, d)).astype(np.float32)
        ids = next(JS.recsys_batch_stream(
            rng, "dlrm", b, n_sparse=f, multi_hot=1, vocab=v, n_dense=13,
            seq_len=4))["ids"]
        assert ids.shape == (b, f, 1)
        got = ops.embedding_bag(t(tabs), t(ids)).numpy()
        assert got.shape == (b, f, d) and got.dtype == np.float32
        for i in range(f):
            want = pallas_embedding_bag(jnp.asarray(tabs[i]),
                                        jnp.asarray(ids[:, i]), block_b=8,
                                        interpret=True)
            np.testing.assert_array_equal(got[:, i], np.asarray(want))
            np.testing.assert_array_equal(got[:, i], np.asarray(
                JREF.embedding_bag_ref(jnp.asarray(tabs[i]),
                                       jnp.asarray(ids[:, i]))))
        np.testing.assert_array_equal(got, tabs[np.arange(f)[None, :],
                                                ids[..., 0]])

    @pytest.mark.parametrize("mode", ["sum", "mean"])
    def test_bf16_stacked_tables_per_field(self, mode):
        """bfloat16 stacked tables, bags of 3 ids with padding: each field
        against the Pallas kernel (interpret mode) and the oracle on the
        table widened to float32.  The port and the Pallas kernel both add
        the rows in id order to a float32 sum from 0: ``rtol=atol=1e-6``;
        the oracle sums in XLA's order: ``TOL``."""
        f, v, d, b, l = 3, 50, 16, 9, 3
        rng = np.random.default_rng(16)
        tabs = torch.from_numpy(rng.normal(size=(f, v, d)).astype(
            np.float32)).to(torch.bfloat16)
        ids = rng.integers(-1, v, size=(b, f, l)).astype(np.int32)
        ids[0, 1] = -1                               # an all-padding bag
        got = ops.embedding_bag(tabs, t(ids), mode=mode).numpy()
        wide = tabs.to(torch.float32).numpy()        # exact
        for i in range(f):
            want = pallas_embedding_bag(jnp.asarray(wide[i]),
                                        jnp.asarray(ids[:, i]), mode=mode,
                                        block_b=4, interpret=True)
            close(got[:, i], want, tol=1e-6)
            close(got[:, i], JREF.embedding_bag_ref(
                jnp.asarray(wide[i]), jnp.asarray(ids[:, i]), mode=mode))
        assert not got[0, 1].any()

    def test_negative_zero_row(self):
        """A row of -0.0: a bag of that one id is 0 + (-0.0) = +0.0 in the
        port (and on the card, where the kernel adds as the plain version
        does).  XLA folds ``0 + x`` to ``x``, so the Pallas kernel
        (interpret mode) and the oracle keep -0.0: the values compare equal
        (tolerance 0), the signs differ by design."""
        table = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
        table[2] = -0.0
        table[3, ::2] = -0.0
        ids = np.array([[2], [3], [-1], [2]], np.int32)
        got = ops.embedding_bag(t(table), t(ids)).numpy()
        assert not np.signbit(got[got == 0]).any()
        want = np.asarray(pallas_embedding_bag(
            jnp.asarray(table), jnp.asarray(ids), block_b=2, interpret=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(JREF.embedding_bag_ref(
            jnp.asarray(table), jnp.asarray(ids))))
        assert np.signbit(want[0]).all()
        two = ops.embedding_bag(t(table), t(np.array([[2, 2], [-1, 2]],
                                                      np.int32))).numpy()
        assert not np.signbit(two[two == 0]).any()  # +0 + (-0) + (-0)


class TestModels:
    def test_init_raises_without_a_gpu_and_runs_on_cpu(self):
        cfg = get_arch("dlrm-rm2").SMOKE_CONFIG
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TR.recsys_init(cfg)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TR.load_jax_params({}, cfg)
        p = TR.recsys_init(cfg, seed=3, device="cpu")
        _, jp, _ = both("dlrm-rm2")
        assert p["tables"].shape == jp["tables"].shape
        assert [tuple(w.shape) for w in p["top_mlp"].w] == \
            [l["w"].shape for l in jp["top_mlp"]]
        q = TR.recsys_init(cfg, seed=3, device="cpu")
        assert torch.equal(p["tables"], q["tables"])

    def test_load_rejects_other_keys(self):
        with pytest.raises(ValueError, match="need keys"):
            TR.load_jax_params({"tables": np.zeros((1, 2, 2))},
                               get_arch("din").SMOKE_CONFIG, device="cpu")

    def test_towers(self):
        p, jp, _ = both("two-tower-retrieval")
        b = batch_of("two-tower-retrieval", 12)
        close(TR.embed_fields(p["user_tables"], t(b["user_ids"])),
              JR.embed_fields(jp["user_tables"], jnp.asarray(b["user_ids"])))
        close(TR.tower_user(p, t(b["user_ids"])),
              JR.tower_user(jp, jnp.asarray(b["user_ids"])))
        close(TR.tower_item(p, t(b["item_ids"])),
              JR.tower_item(jp, jnp.asarray(b["item_ids"])))

    @pytest.mark.parametrize("arch", ["din", "autoint", "dlrm-rm2"])
    def test_forwards(self, arch):
        p, jp, jcfg = both(arch)
        b = batch_of(arch, 16)
        cfg = get_arch(arch).SMOKE_CONFIG
        got = TR.recsys_forward(p, {k: t(v) for k, v in b.items()}, cfg)
        want = JR.recsys_forward(jp, {k: jnp.asarray(v) for k, v in b.items()},
                                 jcfg)
        assert got.shape == (16,)
        close(got, want)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_serve_candidates(self, arch):
        p, jp, jcfg = both(arch)
        cfg = get_arch(arch).SMOKE_CONFIG
        b = batch_of(arch, 3)
        cand = np.random.default_rng(7).integers(
            0, cfg.vocab_per_field, 11).astype(np.int32)
        got = TR.serve_candidates(p, {k: t(v) for k, v in b.items()}, t(cand),
                                  cfg)
        want = JR.serve_candidates(jp, {k: jnp.asarray(v) for k, v in b.items()},
                                   jnp.asarray(cand), jcfg)
        assert got.shape == (3, 11)
        close(got, want)

    def test_retrieval_serve(self):
        p, jp, jcfg = both("two-tower-retrieval")
        cfg = get_arch("two-tower-retrieval").SMOKE_CONFIG
        n_items = 600
        cand = np.arange(n_items, dtype=np.int32)
        item_ids = np.broadcast_to(cand[:, None, None],
                                   (n_items, 2, 1)).astype(np.int32)
        db_t = TR.tower_item(p, t(item_ids))
        db_j = JR.tower_item(jp, jnp.asarray(item_ids))
        close(db_t, db_j)
        b = batch_of("two-tower-retrieval", 9)
        s_t, i_t = TR.retrieval_serve(p, t(b["user_ids"]), db_t, cfg, k=5)
        s_j, i_j = JR.retrieval_serve(jp, jnp.asarray(b["user_ids"]), db_j,
                                      jcfg, k=5)
        assert i_t.dtype == torch.int32 and i_t.shape == (9, 5)
        close(s_t, s_j)
        s_j, i_j = np.asarray(s_j), np.asarray(i_j)
        differ = i_t.numpy() != i_j
        # ids equal up to ties: a swapped pair has equal scores
        assert np.allclose(s_t.numpy()[differ], s_j[differ], atol=TOL)
