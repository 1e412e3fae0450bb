"""The port's other LM families against the JAX package, on the CPU:
StarCoder2 (plain GELU FFN), Gemma3 (local:global attention with ring
caches), Qwen3-MoE (routed experts) and DeepSeek-V2 (MLA + MoE with a dense
first layer), at their ``SMOKE_CONFIG``s, and the registry that names
them.  The layers they add are in ``test_torch_lm_layers.py``.

The same seeded numpy inputs and the same weights — the JAX package's
``init_lm`` pytree carried through ``load_jax_params`` — go through both
packages.  Tolerance: float32 ``rtol=atol=2e-4`` (XLA and torch sum in
other orders); bfloat16 ``rtol=atol=5e-2``, as ``test_torch_lm.py``;
generated token ids, cache key sets, MoE routing (experts, ranks, drops)
equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro import configs as JCFG
from repro.models import lm as JLM
from repro.rag import RAGPipeline as JRAGPipeline
from repro.rag.pipeline import mean_pool_embedder as j_embedder

from repro_torch import configs as TCFG
from repro_torch.models import lm as TLM
from repro_torch.rag import RAGPipeline, mean_pool_embedder

TOL = 2e-4
BF16_TOL = 5e-2
KEY = jax.random.PRNGKey(0)
FAMILIES = ["starcoder2-3b", "gemma3-4b", "qwen3-moe-235b-a22b",
            "deepseek-v2-236b"]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def np_params(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


# ============================================================ configs ====

class TestConfigs:
    def test_registry_matches_reference(self):
        assert TCFG.list_archs() == JCFG.list_archs()
        assert TCFG.LM_ARCHS == JCFG.LM_ARCHS
        assert [TCFG.family_of(a) for a in TCFG.list_archs()] == \
            [JCFG.family_of(a) for a in JCFG.list_archs()]

    @pytest.mark.parametrize("arch", JCFG.list_archs())
    def test_configs_and_shapes_copy_the_reference(self, arch):
        tm, jm = TCFG.get_arch(arch), JCFG.get_arch(arch)
        for name in ("CONFIG", "SMOKE_CONFIG"):
            assert dataclasses.asdict(getattr(tm, name)) == \
                dataclasses.asdict(getattr(jm, name))
        assert {k: dataclasses.asdict(v) for k, v in tm.SHAPES.items()} == \
            {k: dataclasses.asdict(v) for k, v in jm.SHAPES.items()}
        cfg = tm.CONFIG
        if arch in TCFG.LM_ARCHS:
            assert cfg.param_count() == jm.CONFIG.param_count()
            assert cfg.active_param_count() == jm.CONFIG.active_param_count()

    def test_all_archs_resolvable(self):
        """The port's twin of tests/test_archs.py."""
        assert len(TCFG.list_archs()) == 10
        for a in TCFG.list_archs():
            mod = TCFG.get_arch(a)
            assert hasattr(mod, "CONFIG") and hasattr(mod, "SMOKE_CONFIG")
            assert hasattr(mod, "SHAPES") and len(mod.SHAPES) == 4

    def test_param_counts_match_published_scale(self):
        expect = {
            "starcoder2-3b": (2.5e9, 4e9),
            "gemma3-4b": (3e9, 5.5e9),
            "mistral-nemo-12b": (10e9, 14e9),
            "deepseek-v2-236b": (200e9, 260e9),
            "qwen3-moe-235b-a22b": (210e9, 260e9),
        }
        for arch, (lo, hi) in expect.items():
            n = TCFG.get_arch(arch).CONFIG.param_count()
            assert lo <= n <= hi, f"{arch}: {n / 1e9:.1f}B"
        ds = TCFG.get_arch("deepseek-v2-236b").CONFIG
        assert 15e9 <= ds.active_param_count() <= 35e9
        qw = TCFG.get_arch("qwen3-moe-235b-a22b").CONFIG
        assert 15e9 <= qw.active_param_count() <= 30e9

    @pytest.mark.parametrize("long_ok", [False, True])
    def test_lm_shapes(self, long_ok):
        from repro.configs.shapes import lm_shapes as j_lm_shapes
        from repro_torch.configs.shapes import lm_shapes
        got = lm_shapes(long_ok=long_ok, skip_reason="x" if long_ok else "")
        want = j_lm_shapes(long_ok=long_ok, skip_reason="x" if long_ok else "")
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.items()}


# ============================================================ the LMs ====

@pytest.fixture(scope="module", params=FAMILIES)
def carried(request):
    cfg = TCFG.get_arch(request.param).SMOKE_CONFIG
    jcfg = JCFG.get_arch(request.param).SMOKE_CONFIG
    params = JLM.init_lm(KEY, jcfg)
    lm = TLM.load_jax_params(np_params(params), cfg, device="cpu")
    return cfg, jcfg, params, lm


def _close_cache(got, want):
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        close(got[name], want[name])


class TestFamilies:
    def test_load_jax_params_carries_every_leaf(self, carried):
        cfg, _, params, lm = carried
        n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
        assert sum(p.numel() for p in lm.parameters()) == n_jax
        n_dense = cfg.moe.first_k_dense if cfg.moe else 0
        assert len(lm.dense_layers) == n_dense
        assert len(lm.blocks()) == cfg.n_layers
        last = lm.layers[-1]
        if cfg.moe is not None:
            assert last.ffn is None
            close(last.moe.w_in, params["layers"]["moe"]["w_in"][-1], 0)
            assert last.moe.router.dtype == torch.float32
        if cfg.mla is not None:
            close(last.attn.wkv_b, params["layers"]["attn"]["wkv_b"][-1], 0)
            close(lm.dense_layers[0].ffn.w_gate,
                  params["dense_layers"]["ffn"]["w_gate"][0], 0)

    def test_lm_forward_logits(self, carried):
        cfg, jcfg, params, lm = carried
        toks = np.random.default_rng(20).integers(0, cfg.vocab, (2, 21))
        want, _ = JLM.lm_forward(params, jnp.asarray(toks), jcfg)
        got = TLM.lm_forward(lm, torch.from_numpy(toks))
        assert got.dtype == torch.float32
        close(got, want)

    def test_prefill_caches_both_layouts(self, carried):
        """Without a decode budget: the JAX package's prefill layout; with
        one: its ``prefill_to_decode_cache`` (ring contents included),
        written directly; and the port's own conversion of the first into
        the second."""
        cfg, jcfg, params, lm = carried
        toks = np.random.default_rng(21).integers(0, cfg.vocab, (2, 19))
        want, wc = JLM.prefill(params, jnp.asarray(toks), jcfg)
        got, gc = TLM.prefill(lm, torch.from_numpy(toks))
        close(got, want)
        _close_cache(gc, wc)
        wd = JLM.prefill_to_decode_cache(jcfg, wc, 19, 24)
        got, gd = TLM.prefill(lm, torch.from_numpy(toks), decode_len=24)
        close(got, want)
        _close_cache(gd, wd)
        _close_cache(TLM.prefill_to_decode_cache(cfg, gc, 19, 24), wd)
        _close_cache(TLM.init_cache(cfg, 2, 24, device="cpu"),
                     JLM.init_cache(jcfg, 2, 24))

    def test_decode_steps(self, carried):
        """Four steps from a prefill of 14 (Gemma3's rings of 16 wrap at
        step 2): logits each step and every cache at the end."""
        cfg, jcfg, params, lm = carried
        rng = np.random.default_rng(22)
        toks = rng.integers(0, cfg.vocab, (2, 14))
        steps = rng.integers(0, cfg.vocab, (2, 4))
        _, wc = JLM.prefill(params, jnp.asarray(toks), jcfg)
        wc = JLM.prefill_to_decode_cache(jcfg, wc, 14, 18)
        _, gc = TLM.prefill(lm, torch.from_numpy(toks), decode_len=18)
        for i in range(4):
            tok = steps[:, i:i + 1]
            want, wc = JLM.decode_step(params, wc, jnp.asarray(tok), 14 + i,
                                       jcfg)
            got, gc = TLM.decode_step(lm, gc, torch.from_numpy(tok), 14 + i)
            close(got, want)
        _close_cache(gc, wc)

    def test_decode_from_empty_cache(self, carried):
        """tests/test_archs.py's decode smoke: a step at 0 on init_cache."""
        cfg, jcfg, params, lm = carried
        tok = np.random.default_rng(23).integers(0, cfg.vocab, (2, 1))
        want, wc = JLM.decode_step(params, JLM.init_cache(jcfg, 2, 8),
                                   jnp.asarray(tok), 0, jcfg)
        got, gc = TLM.decode_step(lm, TLM.init_cache(cfg, 2, 8, device="cpu"),
                                  torch.from_numpy(tok), 0)
        close(got, want)
        _close_cache(gc, wc)


def _decode_matches_forward(cfg, S=12, atol=5e-4, impl="chunked"):
    """The port's twin of tests/test_models_consistency.py."""
    lm = TLM.init_lm(cfg, seed=7, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab, (2, S)))
    full = TLM.lm_forward(lm, toks, impl=impl)
    _, pc = TLM.prefill(lm, toks[:, :S - 1], impl=impl)
    dc = TLM.prefill_to_decode_cache(cfg, pc, S - 1, S)
    dl, _ = TLM.decode_step(lm, dc, toks[:, S - 1:], S - 1, impl=impl)
    err = float((dl - full[:, -1]).abs().max())
    assert err < atol, err


class TestConsistency:
    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_decode_matches_forward_dense(self, impl):
        _decode_matches_forward(TCFG.get_arch("starcoder2-3b").SMOKE_CONFIG,
                                impl=impl)

    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_decode_matches_forward_gqa_swiglu(self, impl):
        _decode_matches_forward(
            TCFG.get_arch("mistral-nemo-12b").SMOKE_CONFIG, impl=impl)

    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_decode_matches_forward_local_global(self, impl):
        _decode_matches_forward(TCFG.get_arch("gemma3-4b").SMOKE_CONFIG,
                                S=20, impl=impl)

    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_decode_matches_forward_mla(self, impl):
        cfg = dataclasses.replace(
            TCFG.get_arch("deepseek-v2-236b").SMOKE_CONFIG, moe=None)
        _decode_matches_forward(cfg, impl=impl)

    def test_multi_step_greedy_decode_matches_forward(self):
        """Decode 4 tokens greedily == the teacher-forced forward argmax."""
        cfg = TCFG.get_arch("starcoder2-3b").SMOKE_CONFIG
        lm = TLM.init_lm(cfg, seed=7, device="cpu")
        prompt = torch.from_numpy(
            np.random.default_rng(7).integers(0, cfg.vocab, (2, 8)))
        logits, cache = TLM.prefill(lm, prompt, decode_len=12)
        toks = logits.argmax(-1)[:, None]
        seq = [prompt, toks]
        for i in range(3):
            lg, cache = TLM.decode_step(lm, cache, toks, 8 + i)
            toks = lg.argmax(-1)[:, None]
            seq.append(toks)
        decoded = torch.cat(seq, 1)
        full = TLM.lm_forward(lm, decoded[:, :-1])
        assert torch.equal(decoded[:, 8:], full[:, 7:].argmax(-1))

    @pytest.mark.parametrize("arch", FAMILIES)
    def test_init_lm_serves_bf16(self, arch):
        """Each family at its smoke widths in bf16 weights: float32 logits,
        bf16 caches in the decode layout, a decode step."""
        cfg = dataclasses.replace(TCFG.get_arch(arch).SMOKE_CONFIG,
                                  param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
        lm = TLM.init_lm(cfg, seed=0, device="cpu")
        toks = torch.randint(1, cfg.vocab, (2, 20),
                             generator=torch.Generator().manual_seed(0))
        logits, cache = TLM.prefill(lm, toks, decode_len=22)
        assert logits.dtype == torch.float32
        assert all(c.dtype == torch.bfloat16 for c in cache.values())
        lg, _ = TLM.decode_step(lm, cache, logits.argmax(-1)[:, None], 20)
        assert lg.shape == (2, cfg.vocab) and bool(torch.isfinite(lg).all())


class TestRAGGemma3:
    def test_serve_matches_reference_past_the_window(self):
        """RAGPipeline.serve on Gemma3's smoke config with prompts of 26
        tokens (its window is 16): retrieval and generated tokens equal."""
        jcfg = JCFG.get_arch("gemma3-4b").SMOKE_CONFIG
        cfg = TCFG.get_arch("gemma3-4b").SMOKE_CONFIG
        params = JLM.init_lm(KEY, jcfg)
        lm = TLM.load_jax_params(np_params(params), cfg, device="cpu")
        rng = np.random.default_rng(0)
        docs = rng.integers(1, cfg.vocab, (30, 20)).astype(np.int32)
        jdb = j_embedder(params, jcfg)(jnp.asarray(docs))
        jpipe = JRAGPipeline(params, jcfg, jdb, jnp.asarray(docs),
                             d_start=32, k0=8)
        tpipe = RAGPipeline(lm, mean_pool_embedder(lm)(docs), docs,
                            device="cpu", d_start=32, k0=8)
        q = docs[[3, 11, 29], :6]
        want = jpipe.serve(jnp.asarray(q), max_new_tokens=6)
        got = tpipe.serve(q, max_new_tokens=6)
        np.testing.assert_array_equal(got["retrieved"], want["retrieved"])
        np.testing.assert_array_equal(got["generated"].numpy(),
                                      np.asarray(want["generated"]))
