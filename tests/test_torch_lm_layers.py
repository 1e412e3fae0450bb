"""The layers the port's other LM families add, against the JAX package,
on the CPU: the MoE dispatch (routing, capacity drops, the combine, the
aux loss), MLA (the padded flash prefill and the absorbed decode),
windowed and ring-cache attention, and ``layernorm``.

The same seeded numpy inputs and the same weights — the JAX package's
``*_init`` pytrees carried into the port — go through both packages.
Tolerance: float32 ``rtol=atol=2e-4`` (XLA and torch sum in other
orders); bfloat16 ``rtol=atol=5e-2``, as ``test_torch_lm.py``; MoE routing
(experts, slots, drops) equal.  The LMs themselves are in
``test_torch_lm_families.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.configs.base import MoEConfig as JMoEConfig
from repro.layers import attention as JA
from repro.layers import common as JC
from repro.layers import mla as JM
from repro.layers import moe as JE

from repro_torch import configs as TCFG
from repro_torch.configs.base import MLAConfig, MoEConfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.layers import attention as TA
from repro_torch.layers import common as TC
from repro_torch.layers import mla as TM
from repro_torch.layers import moe as TE

TOL = 2e-4
BF16_TOL = 5e-2
KEY = jax.random.PRNGKey(0)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


class TestLayernorm:
    @pytest.mark.parametrize("shape,eps", [((2, 5, 32), 1e-5), ((3, 128), 1e-6)])
    def test_matches_reference(self, shape, eps):
        rng = np.random.default_rng(1)
        x = rng.normal(size=shape).astype(np.float32) * 3 + 1
        scale = rng.normal(size=shape[-1:]).astype(np.float32)
        bias = rng.normal(size=shape[-1:]).astype(np.float32)
        want = JC.layernorm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), eps)
        close(TC.layernorm(t(x), t(scale), t(bias), eps), want)

    def test_bf16(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(4, 64)).astype(np.float32)
        scale = rng.normal(size=64).astype(np.float32)
        bias = rng.normal(size=64).astype(np.float32)
        want = JC.layernorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                            jnp.asarray(bias))
        got = TC.layernorm(t(x, torch.bfloat16), t(scale), t(bias))
        assert got.dtype == torch.bfloat16
        close(got.float(), np.asarray(want, np.float32), BF16_TOL)


def _moe(cfg, d_model, ffn_type, dtype=jnp.float32):
    p = JE.moe_init(KEY, d_model, JMoEConfig(**dataclasses.asdict(cfg)),
                    ffn_type, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    sh = p.get("shared")
    tp = TE.MoE(t(p["router"]), t(p["w_in"], tdt), t(p["w_out"], tdt),
                t(p["w_gate"], tdt) if "w_gate" in p else None,
                TC.FFN(t(sh["w_in"], tdt), t(sh["w_out"], tdt),
                       t(sh["w_gate"], tdt) if "w_gate" in sh else None)
                if sh is not None else None)
    return p, tp


# (cfg, ffn_type, tokens): no drops, drops, shared experts, GELU experts
MOE_CASES = [
    (MoEConfig(n_experts=8, top_k=2, d_ff_expert=24, capacity_factor=8.0),
     "swiglu", 40),
    (MoEConfig(n_experts=8, top_k=2, d_ff_expert=24, capacity_factor=0.5),
     "swiglu", 64),
    (MoEConfig(n_experts=6, top_k=3, d_ff_expert=16, n_shared_experts=2,
               d_ff_shared=12, router_norm_topk=False), "swiglu", 33),
    (MoEConfig(n_experts=4, top_k=1, d_ff_expert=16, capacity_factor=1.0),
     "mlp", 50),
]


class TestMoE:
    @pytest.mark.parametrize("cfg,ffn_type,n", MOE_CASES)
    def test_moe_apply_matches(self, cfg, ffn_type, n):
        p, tp = _moe(cfg, 32, ffn_type)
        x = np.random.default_rng(n).normal(size=(n, 32)).astype(np.float32)
        want, waux = JE.moe_apply(p, jnp.asarray(x), JMoEConfig(
            **dataclasses.asdict(cfg)), ffn_type)
        got, aux = TE.moe_apply(tp, t(x), cfg, ffn_type)
        close(got, want)
        close(aux, waux)
        # (B, S, D) in, the same shape out
        got3, _ = TE.moe_apply(tp, t(x).reshape(1, n, 32), cfg, ffn_type)
        assert got3.shape == (1, n, 32)
        close(got3.reshape(n, 32), want)

    @pytest.mark.parametrize("cfg,ffn_type,n", MOE_CASES)
    def test_dispatch_routes_and_drops_as_reference(self, cfg, ffn_type, n):
        """Which (token, expert) pairs land in which slot, and which are
        dropped at the capacity, equal the JAX package's."""
        p, tp = _moe(cfg, 32, ffn_type)
        x = np.random.default_rng(n).normal(size=(n, 32)).astype(np.float32)
        logits = x @ np.asarray(p["router"])
        jbuf, (e_s, slot, tok_s, gate_s, keep, cap), jft, jfp = \
            JE._dispatch_local(jnp.asarray(x), jnp.asarray(logits),
                               JMoEConfig(**dataclasses.asdict(cfg)))
        buf, info, ft, fp = TE._dispatch_local(t(x), t(logits), cfg)
        experts, order, te_s, tslot, tkeep, tgate, tcap = info
        assert tcap == cap and buf.shape == tuple(jbuf.shape)
        np.testing.assert_array_equal(te_s.numpy(), np.asarray(e_s))
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
        np.testing.assert_array_equal((order // cfg.top_k).numpy(),
                                      np.asarray(tok_s))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
        close(tgate, gate_s)
        close(buf, jbuf)
        close(ft, jft)
        close(fp, jfp)
        if cfg.capacity_factor < 1:
            assert not bool(tkeep.all())        # this case drops tokens

    def test_bf16(self):
        cfg = MOE_CASES[2][0]
        p, tp = _moe(cfg, 32, "swiglu", jnp.bfloat16)
        x = np.random.default_rng(5).normal(size=(2, 9, 32)).astype(np.float32)
        want, _ = JE.moe_apply(p, jnp.asarray(x, jnp.bfloat16),
                               JMoEConfig(**dataclasses.asdict(cfg)), "swiglu")
        got, _ = TE.moe_apply(tp, t(x, torch.bfloat16), cfg, "swiglu")
        assert got.dtype == torch.bfloat16
        close(got.float(), np.asarray(want, np.float32), BF16_TOL)

    def test_moe_aux_loss_encourages_balance(self):
        """The port's twin of tests/test_models_consistency.py: uniform-ish
        routing gives an aux loss near its minimum, coef * k."""
        cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                        aux_loss_coef=1.0)
        p = TE.moe_init(torch.Generator().manual_seed(7), 32, cfg, "swiglu",
                        torch.float32)
        x = torch.randn((256, 32), generator=torch.Generator().manual_seed(7))
        _, aux = TE.moe_apply(p, x, cfg, "swiglu")
        assert cfg.top_k * 0.99 <= float(aux) < cfg.top_k * 3.0

    def test_moe_capacity_drops_bounded(self):
        """With generous capacity the MoE equals the dense mixture of each
        token's top-2 experts (the port's twin of the JAX package's)."""
        cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=8.0)
        p = TE.moe_init(torch.Generator().manual_seed(7), 16, cfg, "swiglu",
                        torch.float32)
        x = torch.randn((32, 16), generator=torch.Generator().manual_seed(8))
        y, _ = TE.moe_apply(p, x, cfg, "swiglu")
        probs = torch.softmax(x @ p.router, -1)
        gv, ge = torch.topk(probs, 2, dim=-1)
        gv = gv / gv.sum(-1, keepdim=True)
        ref = torch.zeros_like(x)
        for i in range(32):
            for j in range(2):
                e = int(ge[i, j])
                h = x[i] @ p.w_in[e]
                g = torch.nn.functional.silu(x[i] @ p.w_gate[e]) * h
                ref[i] += gv[i, j] * (g @ p.w_out[e])
        close(y, ref.numpy())

    def test_init_is_seeded_and_shaped(self):
        cfg = MOE_CASES[2][0]
        a = TE.moe_init(torch.Generator().manual_seed(1), 32, cfg, "swiglu",
                        torch.bfloat16)
        b = TE.moe_init(torch.Generator().manual_seed(1), 32, cfg, "swiglu",
                        torch.bfloat16)
        assert a.w_in.shape == (6, 32, 16) and a.w_out.shape == (6, 16, 32)
        assert a.router.dtype == torch.float32 and a.w_in.dtype == torch.bfloat16
        assert a.shared.w_in.shape == (32, 24)
        assert torch.equal(a.w_gate, b.w_gate)
        assert float(a.w_in.float().abs().max()) <= 3 * 32 ** -0.5 + 1e-2


MLA_CFGS = [
    MLAConfig(q_lora_rank=24, kv_lora_rank=16, d_nope=16, d_rope=8, d_v=16),
    MLAConfig(q_lora_rank=0, kv_lora_rank=32, d_nope=32, d_rope=16, d_v=24),
]


def _mla(cfg, d_model, h, dtype=jnp.float32):
    from repro.configs.base import MLAConfig as JMLA
    p = JM.mla_init(KEY, d_model, h, JMLA(**dataclasses.asdict(cfg)), dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = TM.MLA(**{k: t(v, torch.float32 if k.endswith("norm") else tdt)
                   for k, v in p.items()})
    return p, tp, JMLA(**dataclasses.asdict(cfg))


class TestMLA:
    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    @pytest.mark.parametrize("ci", [0, 1])
    def test_mla_forward(self, ci, impl):
        cfg = MLA_CFGS[ci]
        p, tp, jcfg = _mla(cfg, 48, 4)
        x = np.random.default_rng(30 + ci).normal(size=(2, 11, 48)).astype(
            np.float32)
        want = JM.mla_forward(p, jnp.asarray(x), n_heads=4, cfg=jcfg,
                              rope_theta=1e4, impl="dense")
        before = tfa.launches
        got, (ckv, krope) = TM.mla_forward(tp, t(x), n_heads=4, cfg=cfg,
                                           rope_theta=1e4, impl=impl,
                                           return_cache=True)
        assert tfa.launches == before          # the CPU never launches
        close(got, want)
        # the cache entries are what the JAX package's prefill caches
        kv_a = jnp.asarray(x) @ p["wkv_a"]
        r = cfg.kv_lora_rank
        close(ckv, JC.rmsnorm(kv_a[..., :r], p["kv_norm"]))
        close(krope, JA.apply_rope(kv_a[:, None, :, r:], jnp.arange(11),
                                   1e4)[:, 0])

    def test_padded_flash_call(self, monkeypatch):
        """Prefill hands the kernel q, k and v zero-padded to one head dim
        and the scale of the unpadded q / k dims."""
        from repro_torch.kernels import ops
        cfg = MLA_CFGS[1]
        _, tp, _ = _mla(cfg, 48, 4)
        calls = []

        def spy(q, k, v, *, causal=False, window=None, scale=None):
            calls.append((q.shape, k.shape, v.shape, scale, causal))
            return tfa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window, scale=scale)
        monkeypatch.setattr(ops, "flash_attention", spy)
        TM.mla_forward(tp, torch.zeros(1, 5, 48), n_heads=4, cfg=cfg)
        assert calls == [((1, 4, 5, 64),) * 3 + ((48) ** -0.5, True)]
        assert TM.padded_head_dim(cfg) == 64
        full = TCFG.get_arch("deepseek-v2-236b").CONFIG.mla
        assert TM.padded_head_dim(full) == 256
        with pytest.raises(ValueError, match="exceed"):
            TM.padded_head_dim(MLAConfig(0, 16, 256, 64, 128))

    @pytest.mark.parametrize("ci", [0, 1])
    def test_mla_decode_writes_cache_in_place(self, ci):
        cfg = MLA_CFGS[ci]
        p, tp, jcfg = _mla(cfg, 48, 4)
        rng = np.random.default_rng(40 + ci)
        ckv = rng.normal(size=(2, 10, cfg.kv_lora_rank)).astype(np.float32)
        kr = rng.normal(size=(2, 10, cfg.d_rope)).astype(np.float32)
        tc, tr = t(ckv), t(kr)
        jc, jr = jnp.asarray(ckv), jnp.asarray(kr)
        for pos in (0, 4, 9):
            x = rng.normal(size=(2, 1, 48)).astype(np.float32)
            want, jc, jr = JM.mla_decode(p, jnp.asarray(x), jc, jr, pos=pos,
                                         n_heads=4, cfg=jcfg, rope_theta=1e4)
            got, gc, gr = TM.mla_decode(tp, t(x), tc, tr, pos=pos, n_heads=4,
                                        cfg=cfg, rope_theta=1e4)
            assert gc is tc and gr is tr
            close(got, want)
            close(tc, jc)
            close(tr, jr)

    def test_bf16(self):
        cfg = MLA_CFGS[0]
        p, tp, jcfg = _mla(cfg, 48, 4, jnp.bfloat16)
        rng = np.random.default_rng(50)
        x = rng.normal(size=(2, 9, 48)).astype(np.float32)
        want = JM.mla_forward(p, jnp.asarray(x, jnp.bfloat16), n_heads=4,
                              cfg=jcfg, impl="dense")
        got = TM.mla_forward(tp, t(x, torch.bfloat16), n_heads=4, cfg=cfg)
        assert got.dtype == torch.bfloat16
        close(got.float(), np.asarray(want, np.float32), BF16_TOL)
        c = rng.normal(size=(2, 6, 16)).astype(np.float32)
        r = rng.normal(size=(2, 6, 8)).astype(np.float32)
        xd = rng.normal(size=(2, 1, 48)).astype(np.float32)
        want, _, _ = JM.mla_decode(p, jnp.asarray(xd, jnp.bfloat16),
                                   jnp.asarray(c, jnp.bfloat16),
                                   jnp.asarray(r, jnp.bfloat16), pos=3,
                                   n_heads=4, cfg=jcfg)
        got, _, _ = TM.mla_decode(tp, t(xd, torch.bfloat16),
                                  t(c, torch.bfloat16), t(r, torch.bfloat16),
                                  pos=3, n_heads=4, cfg=cfg)
        close(got.float(), np.asarray(want, np.float32), BF16_TOL)


def _attn(d_model, hq, hkv, dh, dtype=jnp.float32):
    p = JA.attn_init(KEY, d_model, hq, hkv, dh, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return p, TA.Attention(*(t(p[k], tdt) for k in ("wq", "wk", "wv", "wo")))


class TestWindowAndRing:
    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    @pytest.mark.parametrize("window", [1, 5, 40])
    def test_windowed_mha_forward(self, impl, window):
        p, tp = _attn(64, 8, 2, 16)
        x = np.random.default_rng(60).normal(size=(2, 23, 64)).astype(
            np.float32)
        want, (wk, wv) = JA.mha_forward(
            p, jnp.asarray(x), n_heads=8, n_kv_heads=2, d_head=16,
            window=window, rope_theta=1e4, impl="dense", return_kv=True)
        got, (gk, gv) = TA.mha_forward(
            tp, t(x), n_heads=8, n_kv_heads=2, d_head=16, window=window,
            rope_theta=1e4, impl=impl, return_kv=True)
        close(got, want)
        close(gk, wk)
        close(gv, wv)

    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_ring_decode_across_the_wrap(self, impl):
        """Steps 0-14 into a ring of 6: before, at and after the wrap the
        outputs and the ring's slots equal the JAX package's."""
        p, tp = _attn(64, 8, 2, 16)
        rng = np.random.default_rng(61)
        jk = jv = jnp.zeros((2, 2, 6, 16))
        tk, tv = torch.zeros(2, 2, 6, 16), torch.zeros(2, 2, 6, 16)
        for pos in range(15):
            x = rng.normal(size=(2, 1, 64)).astype(np.float32)
            want, jk, jv = JA.mha_decode(
                p, jnp.asarray(x), jk, jv, pos=pos, n_heads=8, n_kv_heads=2,
                d_head=16, window=6, rope_theta=1e4, ring=True)
            got, gk, gv = TA.mha_decode(
                tp, t(x), tk, tv, pos=pos, n_heads=8, n_kv_heads=2,
                d_head=16, window=6, rope_theta=1e4, ring=True, impl=impl)
            assert gk is tk and gv is tv
            close(got, want)
            close(tk, jk)
            close(tv, jv)

    @pytest.mark.parametrize("impl", ["chunked", "dense"])
    def test_windowed_decode_without_ring(self, impl):
        p, tp = _attn(64, 8, 2, 16)
        rng = np.random.default_rng(62)
        kc = rng.normal(size=(2, 2, 20, 16)).astype(np.float32)
        vc = rng.normal(size=(2, 2, 20, 16)).astype(np.float32)
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        want, wk, _ = JA.mha_decode(p, jnp.asarray(x), jnp.asarray(kc),
                                    jnp.asarray(vc), pos=14, n_heads=8,
                                    n_kv_heads=2, d_head=16, window=5,
                                    rope_theta=1e4)
        tk = t(kc)
        got, _, _ = TA.mha_decode(tp, t(x), tk, t(vc), pos=14, n_heads=8,
                                  n_kv_heads=2, d_head=16, window=5,
                                  rope_theta=1e4, impl=impl)
        close(got, want)
        close(tk, wk)

    def test_bf16(self):
        p, tp = _attn(64, 4, 2, 32, jnp.bfloat16)
        rng = np.random.default_rng(63)
        x = rng.normal(size=(1, 30, 64)).astype(np.float32)
        want = JA.mha_forward(p, jnp.asarray(x, jnp.bfloat16), n_heads=4,
                              n_kv_heads=2, d_head=32, window=7, impl="dense")
        got = TA.mha_forward(tp, t(x, torch.bfloat16), n_heads=4,
                             n_kv_heads=2, d_head=32, window=7)
        close(got.float(), np.asarray(want, np.float32), BF16_TOL)
        jk = jv = jnp.zeros((1, 2, 4, 32), jnp.bfloat16)
        tk = torch.zeros(1, 2, 4, 32, dtype=torch.bfloat16)
        tv = torch.zeros_like(tk)
        for pos in range(7):
            xd = rng.normal(size=(1, 1, 64)).astype(np.float32)
            want, jk, jv = JA.mha_decode(p, jnp.asarray(xd, jnp.bfloat16),
                                         jk, jv, pos=pos, n_heads=4,
                                         n_kv_heads=2, d_head=32, window=4,
                                         ring=True)
            got, _, _ = TA.mha_decode(tp, t(xd, torch.bfloat16), tk, tv,
                                      pos=pos, n_heads=4, n_kv_heads=2,
                                      d_head=32, window=4, ring=True)
            close(got.float(), np.asarray(want, np.float32), BF16_TOL)
        close(tk.float(), np.asarray(jk, np.float32), BF16_TOL)


