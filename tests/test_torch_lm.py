"""The port's LM layers, flash-attention plain version and LM against the
JAX package, on the CPU.

The same seeded numpy inputs — and, for the modules and the LM, the same
weights, carried from the JAX package's ``init_lm`` pytree through
``load_jax_params`` — go through both packages.  The JAX flash kernel runs
in interpret mode.  The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.

Tolerance: float32 ``rtol=atol=2e-4`` (XLA and torch sum in other orders;
the flash kernel's tiles rescale the running sum at other points than a
dense softmax); bfloat16 ``rtol=atol=5e-2``, as the JAX package's own
``TestFlashAttention.test_bf16``; generated token ids equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.configs.base import LMConfig as JLMConfig
from repro.configs.mistral_nemo_12b import SMOKE_CONFIG as J_SMOKE
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.layers import attention as JA
from repro.layers import common as JC
from repro.layers import rope as JR
from repro.models import lm as JLM

from repro_torch.configs.base import LMConfig
from repro_torch.configs.mistral_nemo_12b import SMOKE_CONFIG
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.layers import attention as TA
from repro_torch.layers import common as TC
from repro_torch.layers import rope as TR
from repro_torch.models import lm as TLM

RTOL = ATOL = 2e-4
BF16_TOL = 5e-2
KEY = jax.random.PRNGKey(0)


def close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def np_params(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


class TestConfig:
    def test_smoke_config_copies_the_reference(self):
        assert dataclasses.asdict(SMOKE_CONFIG) == dataclasses.asdict(J_SMOKE)
        assert SMOKE_CONFIG.param_count() == J_SMOKE.param_count()


class TestLayers:
    @pytest.mark.parametrize("shape", [(2, 5, 32), (3, 128)])
    def test_rmsnorm(self, shape):
        rng = np.random.default_rng(1)
        x = rng.normal(size=shape).astype(np.float32)
        scale = rng.normal(size=shape[-1:]).astype(np.float32) * 0.1
        want = JC.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
        close(TC.rmsnorm(t(x), t(scale), 1e-6), want)

    def test_rmsnorm_bf16_casts_back(self):
        x = torch.randn(4, 16).to(torch.bfloat16)
        assert TC.rmsnorm(x, torch.zeros(16)).dtype == torch.bfloat16

    @pytest.mark.parametrize("theta", [1e4, 1e6])
    def test_apply_rope_interleaved_pairs(self, theta):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 3, 9, 16)).astype(np.float32)
        pos = np.arange(9) + 5
        want = JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        close(TR.apply_rope(t(x), torch.from_numpy(pos), theta), want)

    @pytest.mark.parametrize("ffn_type", ["swiglu", "mlp"])
    def test_ffn_apply(self, ffn_type):
        rng = np.random.default_rng(3)
        p = JC.ffn_init(KEY, 32, 64, ffn_type, jnp.float32)
        x = rng.normal(size=(2, 7, 32)).astype(np.float32)
        want = JC.ffn_apply(p, jnp.asarray(x), ffn_type)
        tp = TC.FFN(t(p["w_in"]), t(p["w_out"]),
                    t(p["w_gate"]) if "w_gate" in p else None)
        close(TC.ffn_apply(tp, t(x), ffn_type), want)

    def test_dense_init_is_seeded_truncated_fan_in(self):
        g = torch.Generator().manual_seed(0)
        w = TC.dense_init(g, 400, 300, torch.float32)
        assert w.abs().max() <= 3 * 400 ** -0.5 + 1e-7
        g2 = torch.Generator().manual_seed(0)
        assert torch.equal(w, TC.dense_init(g2, 400, 300, torch.float32))


# (b, hq, hkv, sq, skv, dh, causal, window): the cases of
# tests/test_kernels.py::TestFlashAttention, then a decode step over a longer
# kv and rows with nothing to attend (sq > skv under causal)
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, True, None),
    (2, 4, 2, 64, 64, 32, False, None),     # GQA
    (1, 2, 2, 50, 70, 32, True, None),      # uneven + decode-aligned
    (1, 2, 2, 96, 96, 64, True, 16),        # sliding window
    (1, 4, 1, 1, 128, 64, False, None),     # single-token decode (MQA)
    (1, 2, 2, 33, 65, 16, True, 8),         # padding both axes + window
    (2, 8, 2, 1, 77, 16, True, None),       # decode step, GQA
    (1, 4, 2, 40, 24, 32, True, None),      # 16 rows with nothing to attend
]


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", FLASH_CASES)
    def test_matches_pallas_interpret(self, b, hq, hkv, sq, skv, dh, causal,
                                      window):
        rng = np.random.default_rng(b * 1000 + sq + skv)
        q = rng.normal(size=(b, hq, sq, dh)).astype(np.float32)
        k = rng.normal(size=(b, hkv, skv, dh)).astype(np.float32)
        v = rng.normal(size=(b, hkv, skv, dh)).astype(np.float32)
        want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, block_q=32,
                            block_k=32, interpret=True)
        before = tfa.launches
        got = ops.flash_attention(t(q), t(k), t(v), causal=causal,
                                  window=window)
        assert tfa.launches == before          # the CPU never launches
        assert got.shape == (b, hq, sq, dh) and got.dtype == torch.float32
        close(got, want)
        if sq > skv and causal:                 # nothing to attend: 0, not NaN
            assert torch.equal(got[:, :, :sq - skv],
                               torch.zeros_like(got[:, :, :sq - skv]))

    def test_bf16(self):
        rng = np.random.default_rng(7)
        qkv = [rng.normal(size=(1, 2, 32, 32)).astype(np.float32)
               for _ in range(3)]
        want = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in qkv),
                            causal=True, block_q=16, block_k=16,
                            interpret=True)
        got = ops.flash_attention(*(t(a).to(torch.bfloat16) for a in qkv),
                                  causal=True)
        assert got.dtype == torch.bfloat16
        close(got.float(), np.asarray(want, np.float32), BF16_TOL)

    def test_strided_cache_prefix(self):
        """Decode reads k_cache[:, :, :pos + 1]: a strided view."""
        rng = np.random.default_rng(8)
        q = t(rng.normal(size=(2, 4, 1, 16)))
        kc = t(rng.normal(size=(2, 2, 40, 16)))
        vc = t(rng.normal(size=(2, 2, 40, 16)))
        got = ops.flash_attention(q, kc[:, :, :13], vc[:, :, :13], causal=True)
        want = ops.flash_attention(q, kc[:, :, :13].contiguous(),
                                   vc[:, :, :13].contiguous(), causal=False)
        close(got, want, 1e-6)


def _attn(rng, d_model, hq, hkv, dh):
    p = JA.attn_init(KEY, d_model, hq, hkv, dh, jnp.float32)
    tp = TA.Attention(t(p["wq"]), t(p["wk"]), t(p["wv"]), t(p["wo"]))
    return p, tp


class TestAttention:
    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_mha_forward(self, impl):
        rng = np.random.default_rng(10)
        p, tp = _attn(rng, 64, 8, 2, 16)
        x = rng.normal(size=(2, 11, 64)).astype(np.float32)
        want, (wk, wv) = JA.mha_forward(
            p, jnp.asarray(x), n_heads=8, n_kv_heads=2, d_head=16,
            rope_theta=1e4, impl="dense", return_kv=True)
        got, (gk, gv) = TA.mha_forward(
            tp, t(x), n_heads=8, n_kv_heads=2, d_head=16, rope_theta=1e4,
            impl=impl, return_kv=True)
        close(got, want)
        close(gk, wk)
        close(gv, wv)

    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_mha_decode_writes_cache_in_place(self, impl):
        rng = np.random.default_rng(11)
        p, tp = _attn(rng, 64, 8, 2, 16)
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        kc = rng.normal(size=(2, 2, 12, 16)).astype(np.float32)
        vc = rng.normal(size=(2, 2, 12, 16)).astype(np.float32)
        want, wk, wv = JA.mha_decode(
            p, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), pos=7,
            n_heads=8, n_kv_heads=2, d_head=16, rope_theta=1e4)
        tk, tv = t(kc), t(vc)
        got, gk, gv = TA.mha_decode(tp, t(x), tk, tv, pos=7, n_heads=8,
                                    n_kv_heads=2, d_head=16, rope_theta=1e4,
                                    impl=impl)
        assert gk is tk and gv is tv
        close(got, want)
        close(tk, wk)
        close(tv, wv)

    def test_dense_and_decode_attention(self):
        rng = np.random.default_rng(12)
        q = rng.normal(size=(1, 4, 1, 16)).astype(np.float32)
        kc = rng.normal(size=(1, 2, 20, 16)).astype(np.float32)
        vc = rng.normal(size=(1, 2, 20, 16)).astype(np.float32)
        for window, ring, pos in ((0, False, 9), (5, False, 12), (0, True, 25)):
            want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), pos=pos,
                                       window=window, ring=ring)
            got = TA.decode_attention(t(q), t(kc), t(vc), pos=pos,
                                      window=window, ring=ring)
            close(got, want)
        qs = rng.normal(size=(1, 4, 10, 16)).astype(np.float32)
        want = JA.dense_attention(jnp.asarray(qs), jnp.asarray(kc),
                                  jnp.asarray(vc), causal=True, window=6)
        close(TA.dense_attention(t(qs), t(kc), t(vc), causal=True, window=6),
              want)


TIED_MLP = LMConfig(name="tied-mlp", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=4, d_head=16, d_ff=96, vocab=300,
                    ffn_type="mlp", tie_embeddings=True,
                    param_dtype="float32", compute_dtype="float32",
                    remat=False)


def _jcfg(cfg):
    return JLMConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module", params=["smoke", "tied_mlp"])
def carried(request):
    cfg = SMOKE_CONFIG if request.param == "smoke" else TIED_MLP
    jcfg = _jcfg(cfg)
    params = JLM.init_lm(KEY, jcfg)
    lm = TLM.load_jax_params(np_params(params), cfg, device="cpu")
    return cfg, jcfg, params, lm


class TestLM:
    def test_load_jax_params(self, carried):
        cfg, _, params, lm = carried
        assert len(lm.layers) == cfg.n_layers
        close(lm.layers[1].attn.wk, params["layers"]["attn"]["wk"][1], 0)
        if cfg.tie_embeddings:
            assert lm.lm_head is None
            assert torch.equal(lm.head, lm.embed.T)
        else:
            close(lm.head, params["lm_head"], 0)

    def test_lm_forward_logits(self, carried):
        cfg, jcfg, params, lm = carried
        toks = np.random.default_rng(20).integers(0, cfg.vocab, (2, 13))
        want, _ = JLM.lm_forward(params, jnp.asarray(toks), jcfg)
        got = TLM.lm_forward(lm, torch.from_numpy(toks))
        assert got.dtype == torch.float32
        close(got, want)

    def test_prefill_logits_and_cache(self, carried):
        cfg, jcfg, params, lm = carried
        toks = np.random.default_rng(21).integers(0, cfg.vocab, (2, 9))
        want, wc = JLM.prefill(params, jnp.asarray(toks), jcfg)
        got, gc = TLM.prefill(lm, torch.from_numpy(toks))
        close(got, want)
        assert set(gc) == {"k", "v"}
        close(gc["k"], wc["k"])
        close(gc["v"], wc["v"])

    def test_decode_steps(self, carried):
        cfg, jcfg, params, lm = carried
        rng = np.random.default_rng(22)
        toks = rng.integers(0, cfg.vocab, (2, 8))
        steps = rng.integers(0, cfg.vocab, (2, 4))
        _, wc = JLM.prefill(params, jnp.asarray(toks), jcfg)
        wc = JLM.prefill_to_decode_cache(jcfg, wc, 8, 12)
        _, gc = TLM.prefill(lm, torch.from_numpy(toks))
        gc = TLM.prefill_to_decode_cache(cfg, gc, 8, 12)
        for i in range(4):
            tok = steps[:, i:i + 1]
            want, wc = JLM.decode_step(params, wc, jnp.asarray(tok), 8 + i,
                                       jcfg)
            got, gc = TLM.decode_step(lm, gc, torch.from_numpy(tok), 8 + i)
            close(got, want)
        close(gc["k"], wc["k"])
        close(gc["v"], wc["v"])

    def test_prefill_into_decode_cache(self, carried):
        """``prefill(decode_len=)`` gives the padded cache directly."""
        cfg, jcfg, params, lm = carried
        toks = np.random.default_rng(24).integers(0, cfg.vocab, (2, 8))
        want, wc = JLM.prefill(params, jnp.asarray(toks), jcfg)
        wc = JLM.prefill_to_decode_cache(jcfg, wc, 8, 12)
        got, gc = TLM.prefill(lm, torch.from_numpy(toks), decode_len=12)
        close(got, want)
        assert gc["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 12,
                                 cfg.d_head)
        close(gc["k"], wc["k"])
        close(gc["v"], wc["v"])
        with pytest.raises(ValueError, match="decode_len"):
            TLM.prefill(lm, torch.from_numpy(toks), decode_len=7)

    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_decode_matches_forward(self, carried, impl):
        """The port's twin of tests/test_models_consistency.py."""
        cfg, _, _, lm = carried
        s = 16
        toks = torch.from_numpy(
            np.random.default_rng(23).integers(0, cfg.vocab, (2, s)))
        full = TLM.lm_forward(lm, toks, impl=impl)
        _, pc = TLM.prefill(lm, toks[:, :s - 1], impl=impl)
        dc = TLM.prefill_to_decode_cache(cfg, pc, s - 1, s)
        dl, _ = TLM.decode_step(lm, dc, toks[:, s - 1:], s - 1, impl=impl)
        close(dl, full[:, -1], 1e-4)

    def test_init_cache_and_seeded_init(self):
        c = TLM.init_cache(SMOKE_CONFIG, 3, 10, device="cpu")
        assert c["k"].shape == (2, 3, 2, 10, 16) and not c["v"].any()
        a = TLM.init_lm(SMOKE_CONFIG, seed=5, device="cpu")
        b = TLM.init_lm(SMOKE_CONFIG, seed=5, device="cpu")
        assert torch.equal(a.layers[1].ffn.w_gate, b.layers[1].ffn.w_gate)
        assert a.embed.dtype == torch.float32
        assert torch.equal(a.layers[0].ln1, torch.zeros(128))

    def test_bf16_logits_are_float32(self):
        cfg = dataclasses.replace(SMOKE_CONFIG, param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
        lm = TLM.init_lm(cfg, seed=0, device="cpu")
        toks = torch.randint(0, cfg.vocab, (2, 6))
        logits, cache = TLM.prefill(lm, toks)
        assert logits.dtype == torch.float32
        assert cache["k"].dtype == torch.bfloat16
