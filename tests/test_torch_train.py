"""The port's training math against the JAX package, on the CPU.

The same seeded numpy inputs and the same weights (the JAX package's
``init_lm`` / ``recsys_init`` / ``egnn_init`` pytrees carried over with
``load_jax_params``) go through both packages:

* the optimizer (``adamw_update``, ``clip_by_global_norm``,
  ``cosine_schedule``; bf16 gradient compression; decay on matrices only),
  mirroring ``tests/test_train_and_ckpt.py::TestOptim``;
* ``softmax_xent`` (z-loss, ignored labels), value and gradient;
* the data streams and the neighbour sampler, bit for bit;
* every loss and its gradient, leaf by leaf of the JAX package's pytree
  (``param_tree``) against ``jax.grad``: the five LM families'
  ``SMOKE_CONFIG`` (chunked and dense attention, remat on), the four
  recsys families, EGNN on ``random_graph``, ``batched_molecules`` and a
  ``sampled_subgraph``;
* each backward kernel's plain version (``*_backward_plain``) against
  ``jax.vjp`` of what the JAX package trains through
  (``chunked_attention``, ``embed_fields``, ``jax.ops.segment_sum``) and
  against autograd through the port's own plain forward; the autograd
  ``Function``s behind ``ops`` on CPU tensors.

Tolerances: float32 gradients ``rtol=1e-4, atol=1e-5`` of the largest
entry (XLA and torch sum in other orders); optimizer states ``1e-6``
relative; data and samplers exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.data import synth as JS
from repro.layers import attention as JA
from repro.layers import common as JC
from repro.models import egnn as JE
from repro.models import graph as JG
from repro.models import lm as JL
from repro.models import recsys as JR
from repro.optim import adamw as JO

from repro_torch.checkpoint.ckpt import _leaves
from repro_torch.configs import get_arch
from repro_torch.data import synth as TS
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as tss
from repro_torch.layers import common as TC
from repro_torch.models import egnn as TE
from repro_torch.models import graph as TG
from repro_torch.models import lm as TL
from repro_torch.models import recsys as TR
from repro_torch.optim import adamw as TO

RTOL, ATOL = 1e-4, 1e-5
LM_ARCHS = ["starcoder2-3b", "gemma3-4b", "mistral-nemo-12b",
            "qwen3-moe-235b-a22b", "deepseek-v2-236b"]
RECSYS_ARCHS = ["two-tower-retrieval", "din", "autoint", "dlrm-rm2"]


def t(a):
    return torch.from_numpy(np.array(a))


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def grad_close(got, want, what=""):
    """|got - want| <= ATOL * max|want| + RTOL * |want|, leaf by leaf."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * max(scale, 1.0),
                               err_msg=what)


def trainable(tree):
    """``tree`` with every leaf asking for a gradient."""
    for leaf in _leaves(tree)[0]:
        leaf.requires_grad_(True)
    return tree


def compare_grads(tree, jgrads):
    """Each leaf's ``.grad`` of the port's tree against the JAX package's
    gradient pytree, walked in the same (JAX flatten) order."""
    leaves, treedef = _leaves(tree)
    jleaves = jax.tree.leaves(jgrads)
    assert treedef == str(jax.tree.structure(jgrads))
    assert len(leaves) == len(jleaves)
    for i, (p, j) in enumerate(zip(leaves, jleaves)):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        grad_close(g.detach().float().numpy(), j, f"leaf {i}")


# --------------------------------------------------------------- optim --

def _opt_trees(seed, bf16=False):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "layers": [{"k": (3, 4, 2)},
                                                  {"k": (7,)}]}
    vals = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
    dt_j = jnp.bfloat16 if bf16 else jnp.float32
    dt_t = torch.bfloat16 if bf16 else torch.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, dt_j), vals)
    jg = jax.tree.map(lambda a: jnp.asarray(a, dt_j), grads)
    tp = jax.tree.map(lambda a: t(a).to(dt_t), vals)
    tg = jax.tree.map(lambda a: t(a).to(dt_t), grads)
    return jp, jg, tp, tg


class TestOptim:
    def test_clip_by_global_norm(self):
        g = {"a": torch.ones(4) * 10.0, "b": torch.ones(2, 2) * 10.0}
        clipped, gn = TO.clip_by_global_norm(g, 1.0)
        total = np.sqrt(sum(float((x ** 2).sum())
                            for x in _leaves(clipped)[0]))
        np.testing.assert_allclose(total, 1.0, rtol=1e-5)
        np.testing.assert_allclose(float(gn), np.sqrt(8 * 100), rtol=1e-5)

    def test_cosine_schedule_shape(self):
        lrs = [TO.cosine_schedule(s, base_lr=1.0, warmup=10, total=100)
               for s in range(100)]
        assert lrs[0] < lrs[9]
        assert max(lrs) <= 1.0 + 1e-6
        assert lrs[99] < lrs[20]
        assert lrs[99] >= 0.1 - 1e-6

    @pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5),
                                              (100, 10000)])
    def test_cosine_schedule_matches_reference(self, warmup, total):
        for s in list(range(0, 2 * warmup + 3)) + [total // 2, total - 1,
                                                    total + 7]:
            want = float(JO.cosine_schedule(jnp.asarray(s, jnp.int32),
                                            base_lr=3e-4, warmup=warmup,
                                            total=total))
            got = TO.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                     base_lr=3e-4, warmup=warmup, total=total)
            np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_adamw_decreases_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        opt = TO.adamw_init(params)
        for _ in range(200):
            g = {"w": 2 * params["w"]}
            params, opt, _ = TO.adamw_update(params, g, opt, lr=5e-2,
                                             weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.5

    def test_grad_compression_dtype(self):
        params = {"w": torch.ones(4)}
        opt = TO.adamw_init(params)
        g = {"w": torch.full((4,), 0.123456789)}
        p1, _, _ = TO.adamw_update(params, g, opt, lr=1e-2,
                                   grad_dtype="bfloat16")
        p2, _, _ = TO.adamw_update(params, g, opt, lr=1e-2)
        assert bool(torch.isfinite(p1["w"]).all())
        np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(),
                                   rtol=1e-2)

    @pytest.mark.parametrize("grad_dtype", [None, "bfloat16"])
    @pytest.mark.parametrize("bf16_params", [False, True])
    @pytest.mark.parametrize("inplace", [False, True])
    def test_adamw_update_matches_reference(self, grad_dtype, bf16_params,
                                            inplace):
        """Three steps of both updates from the same tree: params, moments,
        step and grad norm; weight decay on the 2-D and 3-D leaves only."""
        jp, jg, tp, tg = _opt_trees(3, bf16_params)
        jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
        for step in range(3):
            lr = 1e-2 * (step + 1)
            jp, jo, jm = JO.adamw_update(jp, jg, jo, lr=lr, max_grad_norm=2.0,
                                         grad_dtype=grad_dtype)
            tp, to, tm = TO.adamw_update(tp, tg, to, lr=lr, max_grad_norm=2.0,
                                         grad_dtype=grad_dtype,
                                         inplace=inplace)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
        assert int(to.step) == int(jo.step) == 3
        rtol = 1e-2 if bf16_params else 1e-5
        for got, want in zip(_leaves(tp)[0], jax.tree.leaves(jp)):
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=rtol, atol=rtol * 1e-1)
        for tree_t, tree_j in ((to.mu, jo.mu), (to.nu, jo.nu)):
            for got, want in zip(_leaves(tree_t)[0], jax.tree.leaves(tree_j)):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-7)

    def test_decay_only_on_matrices(self):
        params = {"v": torch.ones(3), "m": torch.ones(2, 3)}
        zero = {"v": torch.zeros(3), "m": torch.zeros(2, 3)}
        new, _, _ = TO.adamw_update(params, zero, TO.adamw_init(params),
                                    lr=0.5, weight_decay=0.1)
        assert torch.equal(new["v"], params["v"])
        np.testing.assert_allclose(new["m"].numpy(), 1 - 0.5 * 0.1, rtol=1e-6)

    def test_inplace_writes_the_given_tensors(self):
        params = {"m": torch.ones(2, 3)}
        opt = TO.adamw_init(params)
        w, mu = params["m"], opt.mu["m"]
        new, new_opt, _ = TO.adamw_update(params, {"m": torch.ones(2, 3)}, opt,
                                          lr=0.1, inplace=True)
        assert new["m"] is w and new_opt.mu["m"] is mu
        assert float(w.max()) < 1.0


# ----------------------------------------------------------- cross-entropy --

class TestSoftmaxXent:
    @pytest.mark.parametrize("z_loss", [0.0, 1e-4])
    def test_value_and_gradient_match_reference(self, z_loss):
        rng = np.random.default_rng(5)
        logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
        labels = rng.integers(-1, 11, (3, 7)).astype(np.int32)
        labels[0, :3] = -1
        (jl, jn), jg = jax.value_and_grad(
            lambda x: JC.softmax_xent(x, jnp.asarray(labels), z_loss=z_loss),
            has_aux=True)(jnp.asarray(logits))
        x = t(logits).requires_grad_(True)
        tl, tn = TC.softmax_xent(x, t(labels), z_loss=z_loss)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        assert int(tn) == int(jn) == int((labels >= 0).sum())
        grad_close(x.grad.numpy(), jg)

    def test_all_ignored_counts_one(self):
        loss, n = TC.softmax_xent(torch.zeros(2, 3, 5),
                                  torch.full((2, 3), -1))
        assert float(loss) == 0.0 and int(n) == 1


# ----------------------------------------------------------------- data --

class TestData:
    def test_markov_chain_equal(self):
        a = JS.synthetic_markov_lm(np.random.default_rng(7), 300, branching=5)
        b = TS.synthetic_markov_lm(np.random.default_rng(7), 300, branching=5)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    @pytest.mark.parametrize("vocab,batch,seq", [(512, 8, 16), (64, 3, 33)])
    def test_lm_batch_stream_equal(self, vocab, batch, seq):
        ja = JS.lm_batch_stream(np.random.default_rng(8), vocab, batch, seq)
        tb = TS.lm_batch_stream(np.random.default_rng(8), vocab, batch, seq)
        for _ in range(4):
            x, y = next(ja)["tokens"], next(tb)["tokens"]
            assert x.dtype == y.dtype == np.int32
            assert np.array_equal(x, y)

    def test_csr_graph_equal(self):
        rng = np.random.default_rng(9)
        s = rng.integers(0, 200, 3000).astype(np.int32)
        r = rng.integers(0, 200, 3000).astype(np.int32)
        a, b = JG.CSRGraph(200, s, r), TG.CSRGraph(200, s, r)
        assert np.array_equal(a.indptr, b.indptr) and a.indptr.dtype == b.indptr.dtype
        assert np.array_equal(a.dst, b.dst)

    @pytest.mark.parametrize("fanout,budget", [((5, 3), None), ((4, 4, 2), 0.5)])
    def test_sampled_subgraph_equal(self, fanout, budget):
        """The same generator state gives the same subgraph, bit for bit,
        also when the budgets cut it."""
        rng = np.random.default_rng(10)
        n = 500
        s = rng.integers(0, n, 6000).astype(np.int32)
        r = rng.integers(0, n, 6000).astype(np.int32)
        feats = rng.normal(size=(n, 6)).astype(np.float32)
        labels = rng.integers(0, 5, n).astype(np.int32)
        coords = rng.normal(size=(n, 3)).astype(np.float32)
        seeds = 16
        nb = seeds * (1 + int(np.cumprod(fanout).sum()))
        eb = seeds * int(np.cumprod(fanout).sum())
        if budget:
            nb, eb = int(nb * budget), int(eb * budget)
        csr_j, csr_t = JG.CSRGraph(n, s, r), TG.CSRGraph(n, s, r)
        for _ in range(2):
            jg = JG.sampled_subgraph(np.random.default_rng(11), csr_j, feats,
                                     labels, coords, seeds, fanout,
                                     node_budget=nb, edge_budget=eb)
            tg = TG.sampled_subgraph(np.random.default_rng(11), csr_t, feats,
                                     labels, coords, seeds, fanout,
                                     node_budget=nb, edge_budget=eb,
                                     device="cpu")
            for f in dataclasses.fields(tg):
                x = getattr(tg, f.name).numpy()
                y = np.asarray(getattr(jg, f.name))
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name


# --------------------------------------------------------------- LM loss --

def _lm_case(arch, *, remat=False, seed=0):
    jcfg = j_get_arch(arch).SMOKE_CONFIG
    cfg = get_arch(arch).SMOKE_CONFIG
    if remat:
        jcfg = dataclasses.replace(jcfg, remat=True)
        cfg = dataclasses.replace(cfg, remat=True)
    jp = JL.init_lm(jax.random.PRNGKey(seed), jcfg)
    toks = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32)
    return jcfg, cfg, jp, toks


class TestLMLoss:
    @pytest.mark.parametrize("arch", LM_ARCHS)
    def test_param_tree_inverts_load(self, arch):
        jcfg, cfg, jp, _ = _lm_case(arch)
        tree = TL.param_tree(TL.load_jax_params(to_np(jp), cfg, device="cpu"))
        leaves, treedef = _leaves(tree)
        assert treedef == str(jax.tree.structure(jp))
        for got, want in zip(leaves, jax.tree.leaves(jp)):
            assert tuple(got.shape) == want.shape
            assert np.array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))

    @pytest.mark.parametrize("arch", LM_ARCHS)
    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_loss_and_grads_match_reference(self, arch, impl):
        """``lm_loss`` over ``lm_view(param_tree)`` against ``jax.grad`` of
        the JAX package's ``lm_loss``: loss, metrics, every leaf's
        gradient (MoE aux loss and MLA's padded flash call included)."""
        jcfg, cfg, jp, toks = _lm_case(arch)
        (jl, jm), jg = jax.value_and_grad(
            lambda p: JL.lm_loss(p, {"tokens": jnp.asarray(toks)}, jcfg,
                                 impl=impl), has_aux=True)(jp)
        tree = trainable(TL.param_tree(
            TL.load_jax_params(to_np(jp), cfg, device="cpu")))
        loss, m = TL.lm_loss(TL.lm_view(tree, cfg), {"tokens": t(toks)},
                             impl=impl)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                                   rtol=1e-5, atol=1e-7)
        assert int(m["tokens"]) == int(jm["tokens"])
        compare_grads(tree, jg)

    @pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v2-236b"])
    def test_remat_gives_the_same_grads(self, arch):
        jcfg, cfg, jp, toks = _lm_case(arch, remat=True)
        jg = jax.grad(lambda p: JL.lm_loss(p, {"tokens": jnp.asarray(toks)},
                                           jcfg)[0])(jp)
        tree = trainable(TL.param_tree(
            TL.load_jax_params(to_np(jp), cfg, device="cpu")))
        TL.lm_loss(TL.lm_view(tree, cfg), {"tokens": t(toks)})[0].backward()
        compare_grads(tree, jg)

    def test_module_grads_equal_the_view_path(self):
        """An ``LM`` module trains after ``requires_grad_``; its layers'
        gradients, stacked, are the view path's."""
        _, cfg, jp, toks = _lm_case("qwen3-moe-235b-a22b")
        lm = TL.load_jax_params(to_np(jp), cfg, device="cpu")
        tree = trainable(TL.param_tree(lm))
        TL.lm_loss(TL.lm_view(tree, cfg), {"tokens": t(toks)})[0].backward()
        lm.requires_grad_(True)
        TL.lm_loss(lm, {"tokens": t(toks)})[0].backward()
        for layer in range(len(lm.layers)):
            got = lm.layers[layer].attn.wq.grad
            torch.testing.assert_close(
                got, tree["layers"]["attn"]["wq"].grad[layer], rtol=1e-6,
                atol=1e-7)
            torch.testing.assert_close(
                lm.layers[layer].moe.router.grad,
                tree["layers"]["moe"]["router"].grad[layer], rtol=1e-6,
                atol=1e-7)
        torch.testing.assert_close(lm.embed.grad, tree["embed"].grad,
                                   rtol=1e-6, atol=1e-7)

    def test_serving_entries_take_no_gradient(self):
        """``lm_forward`` / ``prefill`` keep ``inference_mode`` on a
        trainable model."""
        _, cfg, jp, toks = _lm_case("starcoder2-3b")
        lm = TL.load_jax_params(to_np(jp), cfg, device="cpu")
        lm.requires_grad_(True)
        logits = TL.lm_forward(lm, t(toks))
        assert not logits.requires_grad and logits.is_inference()
        last, _ = TL.prefill(lm, t(toks))
        assert not last.requires_grad


# ----------------------------------------------------- recsys / EGNN loss --

def _recsys_batch(cfg, batch, seed):
    return next(JS.recsys_batch_stream(
        np.random.default_rng(seed), cfg.family, batch,
        n_sparse=cfg.n_sparse, multi_hot=cfg.multi_hot,
        vocab=cfg.vocab_per_field, n_dense=cfg.n_dense, seq_len=cfg.seq_len))


class TestRecsysLoss:
    @pytest.mark.parametrize("arch", RECSYS_ARCHS)
    def test_loss_and_grads_match_reference(self, arch):
        cfg = get_arch(arch).SMOKE_CONFIG
        jcfg = j_get_arch(arch).SMOKE_CONFIG
        jp = JR.recsys_init(jax.random.PRNGKey(0), jcfg)
        b = _recsys_batch(cfg, 16, 1)
        (jl, jm), jg = jax.value_and_grad(
            lambda p: JR.recsys_loss(p, jax.tree.map(jnp.asarray, b), jcfg),
            has_aux=True)(jp)
        tree = trainable(TR.param_tree(
            TR.load_jax_params(to_np(jp), cfg, device="cpu")))
        loss, m = TR.recsys_loss(tree, {k: t(v) for k, v in b.items()}, cfg)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]))
        compare_grads(tree, jg)

    def test_param_tree_shares_storage(self):
        cfg = get_arch("dlrm-rm2").SMOKE_CONFIG
        p = TR.recsys_init(cfg, device="cpu")
        tree = TR.param_tree(p)
        assert tree["tables"].data_ptr() == p["tables"].data_ptr()
        assert tree["bot_mlp"][0]["w"].data_ptr() == p["bot_mlp"].w[0].data_ptr()


def _egnn_graphs(cfg, kind):
    """(JAX Graph, port Graph) drawn from the same seed."""
    if kind == "random":
        return (JG.random_graph(np.random.default_rng(3), 64, 256,
                                cfg.d_feat_in, n_classes=cfg.n_classes),
                TG.random_graph(np.random.default_rng(3), 64, 256,
                                cfg.d_feat_in, n_classes=cfg.n_classes,
                                device="cpu"))
    if kind == "molecules":
        return (JG.batched_molecules(np.random.default_rng(4), 5, 10, 24,
                                     cfg.d_feat_in, n_classes=cfg.n_classes),
                TG.batched_molecules(np.random.default_rng(4), 5, 10, 24,
                                     cfg.d_feat_in, n_classes=cfg.n_classes,
                                     device="cpu"))
    rng = np.random.default_rng(5)
    n = 300
    s = rng.integers(0, n, 2400).astype(np.int32)
    r = rng.integers(0, n, 2400).astype(np.int32)
    feats = rng.normal(size=(n, cfg.d_feat_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    coords = rng.normal(size=(n, 3)).astype(np.float32)
    kw = dict(node_budget=12 * 13, edge_budget=12 * 12)
    return (JG.sampled_subgraph(np.random.default_rng(6), JG.CSRGraph(n, s, r),
                                feats, labels, coords, 12, (4, 2), **kw),
            TG.sampled_subgraph(np.random.default_rng(6), TG.CSRGraph(n, s, r),
                                feats, labels, coords, 12, (4, 2),
                                device="cpu", **kw))


class TestEGNNLoss:
    @pytest.mark.parametrize("kind", ["random", "molecules", "sampled"])
    def test_loss_and_grads_match_reference(self, kind):
        cfg = get_arch("egnn").SMOKE_CONFIG
        jcfg = j_get_arch("egnn").SMOKE_CONFIG
        jp = JE.egnn_init(jax.random.PRNGKey(1), jcfg)
        jgraph, tgraph = _egnn_graphs(cfg, kind)
        (jl, jm), jg = jax.value_and_grad(
            lambda p: JE.egnn_loss(p, jgraph, jcfg), has_aux=True)(jp)
        tree = trainable(TE.param_tree(
            TE.load_jax_params(to_np(jp), cfg, device="cpu")))
        loss, m = TE.egnn_loss(tree, tgraph, cfg)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]))
        assert int(m["n"]) == int(jm["n"])
        compare_grads(tree, jg)

    def test_chunked_messages_give_the_same_grads(self, monkeypatch):
        """Edge MLPs over chunks of the sorted edges (autograd through the
        preallocated buffers) give the one-chunk gradients."""
        cfg = get_arch("egnn").SMOKE_CONFIG
        params = TE.egnn_init(cfg, seed=2, device="cpu")
        _, g = _egnn_graphs(cfg, "random")

        def grads():
            tree = trainable(TE.param_tree(params))
            TE.egnn_loss(tree, g, cfg)[0].backward()
            out = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                   for p in _leaves(tree)[0]]
            for p in _leaves(tree)[0]:
                p.grad = None
                p.requires_grad_(False)
            return out

        whole = grads()
        monkeypatch.setattr(TE, "EDGE_CHUNK_BYTES", 7 * (2 * 16 + 1) * 4)
        for a, b in zip(grads(), whole):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- backward plains --

ATTN_CASES = [  # b, hq, hkv, sq, skv, dh, causal, window
    (2, 4, 2, 24, 24, 16, True, 0),
    (1, 6, 2, 9, 30, 8, True, 0),          # Sq < Skv, aligned to the end
    (1, 4, 1, 20, 20, 16, True, 5),        # window, group 4
    (2, 2, 2, 12, 17, 8, False, 0),
    (1, 3, 3, 15, 15, 8, False, 4),        # window without causal
    (1, 12, 1, 16, 21, 8, True, 6),        # group 12, Sq < Skv, window
]


def _attn_inputs(b, hq, hkv, sq, skv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh),
                      (b, hq, sq, dh))]


class TestFlashBackwardPlain:
    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_matches_chunked_attention_vjp(self, case):
        b, hq, hkv, sq, skv, dh, causal, window = case
        q, k, v, do = _attn_inputs(b, hq, hkv, sq, skv, dh)
        _, vjp = jax.vjp(lambda q_, k_, v_: JA.chunked_attention(
            q_, k_, v_, causal=causal, window=window, block_q=8, block_k=8),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        win = window or None
        got = tfa.flash_attention_backward_plain(t(q), t(k), t(v), t(do),
                                                 causal=causal, window=win)
        for name, g, w in zip("qkv", got, want):
            grad_close(g.numpy(), w, "d" + name)

    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_given_forward_lse_matches_chunked_attention_vjp(self, case):
        """Given the plain forward's log-sum-exp (what the kernels write),
        as the card's backward is, instead of computing its own."""
        b, hq, hkv, sq, skv, dh, causal, window = case
        q, k, v, do = _attn_inputs(b, hq, hkv, sq, skv, dh, 3)
        _, vjp = jax.vjp(lambda q_, k_, v_: JA.chunked_attention(
            q_, k_, v_, causal=causal, window=window, block_q=8, block_k=8),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        win = window or None
        _, lse = tfa.flash_attention_plain(t(q), t(k), t(v), causal=causal,
                                           window=win, return_lse=True)
        got = tfa.flash_attention_backward_plain(t(q), t(k), t(v), t(do), lse,
                                                 causal=causal, window=win)
        for name, g, w in zip("qkv", got, want):
            grad_close(g.numpy(), w, "d" + name)
        again = tfa.flash_attention_backward_plain(t(q), t(k), t(v), t(do),
                                                   causal=causal, window=win)
        assert all(torch.equal(a, b) for a, b in zip(got, again))

    @pytest.mark.parametrize("case", ATTN_CASES + [(1, 2, 2, 10, 4, 8, True, 0)])
    def test_matches_autograd_of_plain_forward(self, case):
        """Also Sq > Skv, where the first rows keep no key (zero gradient),
        and through ``ops.flash_attention``'s autograd ``Function``."""
        b, hq, hkv, sq, skv, dh, causal, window = case
        q, k, v, do = (t(a) for a in _attn_inputs(b, hq, hkv, sq, skv, dh, 1))
        win = window or None
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = tfa.flash_attention_plain(*leaves, causal=causal, window=win)
        o.backward(do)
        got = tfa.flash_attention_backward_plain(q, k, v, do, causal=causal,
                                                 window=win)
        fn = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ops.flash_attention(*fn, causal=causal, window=win).backward(do)
        for g, a, f in zip(got, leaves, fn):
            grad_close(g.numpy(), a.grad.numpy())
            assert torch.equal(f.grad, g)

    def test_scale_and_bf16(self):
        q, k, v, do = (t(a) for a in _attn_inputs(1, 2, 1, 12, 12, 16, 2))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = tfa.flash_attention_plain(*leaves, causal=True, scale=0.3)
        o.backward(do)
        got = tfa.flash_attention_backward_plain(q, k, v, do, causal=True,
                                                 scale=0.3)
        for g, a in zip(got, leaves):
            grad_close(g.numpy(), a.grad.numpy())
        qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
        gb = tfa.flash_attention_backward_plain(qb, kb, vb, dob, causal=True)
        assert all(g.dtype == torch.bfloat16 for g in gb)


# bf16 at head dim 256 (route ``bwd_wgmma`` on the card): b, hq, hkv, sq,
# skv, causal, window — Gemma3's group 2 with a window off the 8-row
# chunks, and Sq < Skv causal
DH256_ATTN_CASES = [(1, 4, 2, 20, 20, True, 6), (1, 4, 2, 11, 19, True, 0)]
# The bf16 results against the float32 VJP: one bf16 rounding of each
# gradient (2 ** -9 of it) and another float32 summation order, within 8e-3
# of the largest |VJP| (``chip_smoke.py``'s bf16 tolerance on the card).
BF16_GRAD_TOL = 8e-3


def _bf16_close(got, want, what):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert got.dtype == torch.bfloat16, what
    err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
    assert err <= BF16_GRAD_TOL, (what, err)


def _bf16_values(a):
    """``a`` rounded to bf16, as float32 (both packages' inputs)."""
    return t(a).to(torch.bfloat16).float().numpy()


class TestFlashBackwardPlainDh256:
    @pytest.mark.parametrize("case", DH256_ATTN_CASES)
    def test_bf16_matches_chunked_attention_vjp(self, case):
        """bf16 q, k, v, dO at head dim 256 through the plain backward,
        against ``jax.vjp`` of the reference's ``chunked_attention`` on the
        same values in float32."""
        b, hq, hkv, sq, skv, causal, window = case
        q, k, v, do = (_bf16_values(a) for a in
                       _attn_inputs(b, hq, hkv, sq, skv, 256, 5))
        _, vjp = jax.vjp(lambda q_, k_, v_: JA.chunked_attention(
            q_, k_, v_, causal=causal, window=window, block_q=8, block_k=8),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        got = tfa.flash_attention_backward_plain(
            *(t(a).to(torch.bfloat16) for a in (q, k, v, do)), causal=causal,
            window=window or None)
        for name, g, w in zip("qkv", got, want):
            _bf16_close(g, w, "d" + name)

    def test_mla_padded_call_matches_unpadded_vjp(self):
        """MLA's call as the port makes it (``layers/mla.py``): q and k of
        192 and v of 128 zero-padded to 256, group 1, scale 192^-0.5, bf16;
        the gradients' first 192 / 128 columns against ``jax.vjp`` of
        ``chunked_attention`` on the unpadded tensors (whose own scale is
        192^-0.5), and the padded columns' gradients exactly 0."""
        import torch.nn.functional as F

        rng = np.random.default_rng(11)
        b, h, s = 1, 3, 18
        q, k, v, do = (_bf16_values(rng.normal(size=(b, h, s, d)).astype(
            np.float32)) for d in (192, 192, 128, 128))
        _, vjp = jax.vjp(lambda q_, k_, v_: JA.chunked_attention(
            q_, k_, v_, causal=True, window=0, block_q=8, block_k=8),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        qp, kp = (F.pad(t(a), (0, 64)).to(torch.bfloat16) for a in (q, k))
        vp, dop = (F.pad(t(a), (0, 128)).to(torch.bfloat16) for a in (v, do))
        dq, dk, dv = tfa.flash_attention_backward_plain(
            qp, kp, vp, dop, causal=True, scale=192 ** -0.5)
        assert dq.shape == dk.shape == dv.shape == (b, h, s, 256)
        for name, g, w, d in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                 (192, 192, 128)):
            _bf16_close(g[..., :d], w, name)
            assert not g[..., d:].any(), name


class TestEmbeddingBagBackwardPlain:
    @pytest.mark.parametrize("f,v,d,b,l", [(3, 20, 8, 10, 4), (1, 5, 3, 7, 1),
                                           (2, 50, 16, 30, 6)])
    def test_matches_embed_fields_vjp(self, f, v, d, b, l):
        """Padding (-1) adds nothing and ids >= V, which the forward reads
        as row V - 1, get nothing either, as in ``jax.grad``."""
        rng = np.random.default_rng(f * v + l)
        tables = rng.normal(size=(f, v, d)).astype(np.float32)
        ids = rng.integers(-1, v + 3, (b, f, l)).astype(np.int32)
        ids[0, 0] = v + 7
        d_out = rng.normal(size=(b, f, d)).astype(np.float32)
        _, vjp = jax.vjp(lambda tb: JR.embed_fields(tb, jnp.asarray(ids)),
                         jnp.asarray(tables))
        want, = vjp(jnp.asarray(d_out))
        got = teb.embedding_bag_backward_plain(t(d_out), t(ids), v, "sum")
        grad_close(got.numpy(), want)
        tab = t(tables).requires_grad_(True)
        ops.embedding_bag(tab, t(ids)).backward(t(d_out))
        assert torch.equal(tab.grad, got)

    @pytest.mark.parametrize("mode", ["sum", "mean"])
    def test_matches_autograd_of_plain_forward(self, mode):
        rng = np.random.default_rng(12)
        f, v, d, b, l = 3, 9, 5, 11, 4
        ids = t(rng.integers(-1, v, (b, f, l)).astype(np.int32))
        ids[1] = -1                                      # all-padding bags
        d_out = t(rng.normal(size=(b, f, d)).astype(np.float32))
        tab = t(rng.normal(size=(f, v, d)).astype(np.float32))
        tab.requires_grad_(True)
        teb.embedding_bag_plain(tab, ids, mode=mode).backward(d_out)
        got = teb.embedding_bag_backward_plain(d_out, ids, v, mode)
        grad_close(got.numpy(), tab.grad.numpy())

    def test_bf16_tables_get_a_bf16_gradient(self):
        tab = torch.randn(2, 6, 4).to(torch.bfloat16).requires_grad_(True)
        ids = torch.randint(-1, 6, (3, 2, 2), dtype=torch.int32)
        ops.embedding_bag(tab, ids).sum().backward()
        assert tab.grad.dtype == torch.bfloat16


class TestSegmentSumBackwardPlain:
    @pytest.mark.parametrize("e,n,d", [(300, 40, 8), (50, 60, 3), (200, 7, 1)])
    def test_matches_segment_sum_vjp(self, e, n, d):
        """Empty segments and ids outside [0, N) (padding: no gradient)."""
        rng = np.random.default_rng(e + n)
        seg = rng.integers(-1, n + 2, e).astype(np.int32)
        data = rng.normal(size=(e, d)).astype(np.float32)
        d_out = rng.normal(size=(n, d)).astype(np.float32)
        _, vjp = jax.vjp(lambda x: jax.ops.segment_sum(
            x, jnp.asarray(seg), num_segments=n), jnp.asarray(data))
        want, = vjp(jnp.asarray(d_out))
        order, seg_s, indptr = tss.sort_by_segment(t(seg), n)
        got = tss.sorted_segment_sum_backward_plain(t(d_out), seg_s, indptr)
        back = torch.empty_like(got)
        back[order] = got
        grad_close(back.numpy(), want)

    def test_matches_autograd_of_plain_forward(self):
        rng = np.random.default_rng(13)
        e, n, d = 400, 50, 6
        seg = t(rng.integers(0, n + 1, e).astype(np.int32))
        order, seg_s, indptr = tss.sort_by_segment(seg, n)
        data = t(rng.normal(size=(e, d)).astype(np.float32))[order]
        d_out = t(rng.normal(size=(n, d)).astype(np.float32))
        x = data.clone().requires_grad_(True)
        tss.sorted_segment_sum_plain(x, seg_s, indptr,
                                     num_segments=n).backward(d_out)
        got = tss.sorted_segment_sum_backward_plain(d_out, seg_s, indptr)
        grad_close(got.numpy(), x.grad.numpy())
        y = data.clone().requires_grad_(True)
        ops.sorted_segment_sum(y, seg_s, indptr, num_segments=n).backward(d_out)
        assert torch.equal(y.grad, got)
        z = data[:, 0].clone().requires_grad_(True)
        ops.sorted_segment_sum(z, seg_s, indptr,
                               num_segments=n).backward(d_out[:, 0])
        assert torch.equal(z.grad, got[:, 0])
