"""The split-kv decode arithmetic, the flash-attention dispatch rules and
the log-sum-exp the forward hands to the backward, on the CPU.

``decode_partials_plain`` / ``combine_partials`` spell out in plain PyTorch
what the CUDA split-kv decode kernel computes: a partial (m, l, acc) per
split of the key range, merged in split order.  The same seeded numpy
inputs go through that mirror, the JAX package's Pallas kernel (interpret
mode) and its ``flash_attention_ref``, with splits that keep no key (a
window left of them, rows with nothing to attend).  The kernel itself is
held against the plain version on the card in ``test_torch_cuda.py``.

Tolerance: float32 ``2e-4`` (the JAX package's own; the splits rescale at
other points than one softmax); bfloat16 ``5e-2``, as the JAX package's
``TestFlashAttention.test_bf16`` (p is rounded relative to each split's
max, the Pallas kernel's relative to its tile's).  The plain log-sum-exp
(``flash_attention_plain(..., return_lse=True)``) is held to
``jax.nn.logsumexp`` of the JAX reference's masked scores within ``1e-5``
(float32, another summation order), -inf on the same rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

TOL = 2e-4
BF16_TOL = 5e-2


def _qkv(seed, b, hq, hkv, sq, skv, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, dh)).astype(np.float32))


def _split(q, k, v, causal, window, split_keys, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    m, l, acc = tfa.decode_partials_plain(tq, tk, tv, causal=causal,
                                          window=window,
                                          split_keys=split_keys)
    return m, l, acc, tfa.combine_partials(m, l, acc, dtype)


# (b, hq, hkv, sq, skv, dh, causal, window, split_keys): decode steps of one
# row tile (sq * hq / hkv <= 64), one split and many, a ragged last split
SPLIT_CASES = [
    (2, 8, 2, 1, 77, 16, True, None, 16),      # 5 splits, last one short
    (1, 4, 1, 1, 128, 64, False, None, 64),    # MQA, 2 splits
    (2, 32, 8, 1, 300, 32, True, None, 64),    # Mistral's group of 4
    (1, 4, 4, 16, 90, 32, True, None, 32),     # 16 positions x 4 heads
    (1, 64, 1, 1, 40, 16, True, None, 8),      # a group of 64
    (1, 2, 2, 5, 200, 16, True, 24, 16),       # window: early splits empty
    (1, 4, 2, 1, 5, 16, True, None, 64),       # fewer keys than a split
]


class TestSplitKvMirror:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window,split_keys",
                             SPLIT_CASES)
    def test_matches_pallas_and_ref(self, b, hq, hkv, sq, skv, dh, causal,
                                    window, split_keys):
        q, k, v = _qkv(sq * 131 + skv, b, hq, hkv, sq, skv, dh)
        m, l, acc, got = _split(q, k, v, causal, window, split_keys)
        n_split = -(-skv // split_keys)
        assert m.shape == (n_split, b, hq, sq)
        assert acc.shape == (n_split, b, hq, sq, dh)
        want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, block_q=16,
                            block_k=16, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)

    def test_empty_splits_weigh_nothing(self):
        """A window that leaves the first splits without a key: they hold
        m = -1e30, l = 0, acc = 0, and the merge equals one dense softmax
        over the kept keys, finite everywhere."""
        q, k, v = _qkv(5, 1, 4, 2, 1, 300, 32)
        m, l, acc, got = _split(q, k, v, True, 80, 64)
        assert m.shape[0] == 5
        assert torch.all(m[:3] == tfa.MASKED) and torch.all(l[:3] == 0)
        assert not acc[:3].any()
        assert torch.all(l[3:] > 0)
        assert torch.isfinite(got).all()
        dense = tfa.flash_attention_plain(*(torch.from_numpy(a)
                                            for a in (q, k, v)),
                                          causal=True, window=80)
        torch.testing.assert_close(got, dense, rtol=TOL, atol=TOL)

    def test_nothing_to_attend_is_zero(self):
        """sq > skv under causal: the first sq - skv rows keep no key in
        any split and come out 0, not NaN; the others match Pallas."""
        q, k, v = _qkv(6, 1, 4, 2, 24, 16, 16)
        m, l, acc, got = _split(q, k, v, True, None, 8)
        assert torch.all(m[:, :, :, :8] == tfa.MASKED)
        assert torch.equal(got[:, :, :8], torch.zeros_like(got[:, :, :8]))
        want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, block_q=8, block_k=8,
                            interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)

    def test_bf16(self):
        q, k, v = _qkv(7, 2, 8, 2, 1, 150, 32)
        _, _, _, got = _split(q, k, v, True, None, 32, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        want = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            causal=True, block_q=16, block_k=16,
                            interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)

    def test_split_order_does_not_matter_beyond_rounding(self):
        """The merge is a weighted sum over splits: any split size gives
        the same output up to float32 rounding."""
        q, k, v = _qkv(8, 1, 8, 2, 1, 257, 16)
        outs = [_split(q, k, v, True, None, n)[3] for n in (8, 64, 128, 512)]
        for o in outs[1:]:
            torch.testing.assert_close(o, outs[0], rtol=1e-5, atol=1e-6)


bf16, f32 = torch.bfloat16, torch.float32


class TestDispatch:
    @pytest.mark.parametrize("dtype,dh,sq,rep,skv,kind", [
        (bf16, 128, 512, 4, 512, "prefill_wgmma"),    # the RAG prefill
        (bf16, 128, 1, 4, 543, "decode_splitkv"),     # the RAG decode step
        (f32, 128, 1, 4, 543, "decode_splitkv"),
        (bf16, 64, 17, 4, 17, "prefill_wgmma"),       # 68 rows: two tiles
        (bf16, 64, 16, 4, 16, "decode_splitkv"),      # 64 rows: one tile
        (bf16, 128, 1, 64, 300, "decode_splitkv"),    # a group of 64
        (bf16, 128, 2, 64, 300, "prefill_wgmma"),
        (f32, 128, 512, 4, 512, "fma"),               # float32 prefill
        (bf16, 32, 512, 4, 512, "fma"),               # head dims 16 / 32
        (bf16, 256, 512, 4, 512, "prefill_wgmma"),    # head dim 256
        (bf16, 16, 100, 1, 100, "fma"),
        (bf16, 128, 100, 1, 0, "fma"),                # no keys: no tensor map
        (f32, 256, 1, 8, 40, "decode_splitkv"),
        (f32, 256, 512, 4, 512, "fma"),               # float32 at dh 256
        (f32, 256, 2048, 2, 2048, "fma"),
        (bf16, 16, 512, 4, 512, "fma"),
        (bf16, 32, 2048, 2, 2048, "fma"),
        (bf16, 256, 2048, 2, 2048, "prefill_wgmma"),  # Gemma3's prefill
        (bf16, 256, 512, 1, 512, "prefill_wgmma"),    # MLA's padded prefill
        (bf16, 256, 33, 2, 33, "prefill_wgmma"),      # 66 rows: two tiles
        (bf16, 256, 1, 2, 2079, "decode_splitkv"),    # Gemma3's decode steps
        (bf16, 256, 1, 2, 1024, "decode_splitkv"),
        (bf16, 256, 32, 2, 32, "decode_splitkv"),     # 64 rows: one tile
        (bf16, 256, 100, 4, 0, "fma"),                # no keys
    ])
    def test_route(self, dtype, dh, sq, rep, skv, kind):
        assert tfa.route(dtype, dh, sq, rep, skv) == kind

    @pytest.mark.parametrize("b,hkv,skv,want", [
        (8, 8, 543, (9, 64)),        # the RAG decode: 576 blocks
        (8, 8, 513, (9, 64)),
        (8, 8, 1, (1, 64)),
        (1, 1, 0, (1, 64)),
        (2, 8, 544, (9, 64)),
        (1, 1, 10_000, (157, 64)),   # 528 blocks wanted, 157 runs of 64
        (64, 8, 4096, (2, 2048)),    # 512 pairs: two blocks each suffice
    ])
    def test_decode_splits(self, b, hkv, skv, want):
        n_split, split_keys = tfa.decode_splits(b, hkv, skv)
        assert (n_split, split_keys) == want
        assert split_keys % tfa.SPLIT_KEYS == 0
        assert (n_split - 1) * split_keys < max(skv, 1) <= n_split * split_keys

    def test_cpu_never_launches(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 4, 2, 1, 40, 16))
        before = (tfa.launches, dict(tfa.launches_by_kernel))
        got = ops.flash_attention(q, k, v, causal=True)
        assert (tfa.launches, tfa.launches_by_kernel) == before
        torch.testing.assert_close(
            got, tfa.flash_attention_plain(q, k, v, causal=True))


class TestPrefillPlan:
    """`prefill_plan`: the tensor-core prefill's tiles and shared memory by
    head dim, as ``csrc/flash_attention.cu`` builds them."""

    @pytest.mark.parametrize("dh", [64, 128, 256])
    def test_fits_shared_memory(self, dh):
        rows, keys, q_st, k_st, v_st, smem = tfa.prefill_plan(dh)
        assert dh in tfa.WGMMA_HEAD_DIMS
        assert rows == 128 and keys % 64 == 0 and min(q_st, k_st, v_st) >= 1
        assert smem <= tfa.SMEM_MAX == 232_448
        rings = (1024 + q_st * rows * 2 * dh + (k_st + v_st) * keys * 2 * dh
                 + 8 * 2 * (q_st + k_st + v_st + 1))
        # the output's staging tile (a Q tile) is there exactly when it fits
        staged = smem == rings + rows * 2 * dh
        assert staged == (rings + rows * 2 * dh <= tfa.SMEM_MAX)
        assert staged or smem == rings

    def test_dh64_dh128_keep_their_layout_dh256_fits(self):
        """Head dims 64 and 128 keep the layout they ran with before 256
        joined (128-key tiles, two stages of each ring, the staged output:
        115,824 and 230,512 bytes); 256 takes 64-key tiles, one Q stage
        and no staging tile."""
        assert tfa.prefill_plan(64) == (128, 128, 2, 2, 2, 115_824)
        assert tfa.prefill_plan(128) == (128, 128, 2, 2, 2, 230_512)
        assert tfa.prefill_plan(256) == (128, 64, 1, 2, 2, 197_728)

    def test_plan_matches_the_source(self):
        """The ``PF_PLAN`` table and the constants of ``pf`` in the CUDA
        source are the wrapper's; the kernel's launcher dispatches every
        head dim the route sends it."""
        import re

        from repro_torch.kernels import _build

        src = (_build.CSRC / "flash_attention.cu").read_text()
        table = {int(m[0]): tuple(int(x) for x in m[1:]) for m in re.findall(
            r"^PF_PLAN\((\d+), (\d+), (\d+), (\d+), (\d+)\)$", src,
            re.M)}
        assert table == tfa.PREFILL_PLANS
        assert set(table) == set(tfa.WGMMA_HEAD_DIMS)
        pf = src[src.index("namespace pf {"):]
        pf = pf[:pf.index("}  // namespace pf")]
        assert re.search(r"kRows = (\d+);", pf)[1] == str(tfa.PREFILL_ROWS)
        assert re.search(r"kSmemMax = (\d+);", pf)[1] == str(tfa.SMEM_MAX)
        entry = src[src.index("int flash_attention_launch("):]
        entry = entry[:entry.index("\n}\n")]
        cases = re.search(r"FA_CASE\((\d+)\) FA_CASE\((\d+)\) "
                          r"FA_CASE\((\d+)\)", entry)
        assert tuple(int(d) for d in cases.groups()) == tfa.WGMMA_HEAD_DIMS


    def test_forward_timing_checks_cover_the_route(self):
        """`launch/flash_fwd_time.py` holds each build against the plain
        version on every head dim of the route, on grids that the (batch,
        kv head) pairs alone fill (the rounds order) and on grids they do
        not; the line its docstring edits for the level-major order is in
        the source once."""
        from repro_torch.kernels import _build
        from repro_torch.launch import flash_fwd_time

        checks = flash_fwd_time.CHECKS
        assert {c[5] for c in checks} == set(tfa.WGMMA_HEAD_DIMS)
        assert any(c[0] * c[2] >= 132 for c in checks)
        assert any(c[0] * c[2] < 132 for c in checks)
        src = (_build.CSRC / "flash_attention.cu").read_text()
        assert src.count("  const int per = pairs >= grid ") == 1
        assert "const int per = pairs >= grid .*;$" in flash_fwd_time.__doc__


# b, hq, hkv, sq, skv, causal, window, scale: bf16 at head dim 256 on the
# shapes ``prefill_wgmma`` now takes — group 2 with a window and Sq != Skv,
# neither a multiple of 64; the window alone; MLA's group 1 with its scale
DH256_CASES = [
    (1, 4, 2, 40, 72, True, 24, None),
    (1, 4, 2, 70, 45, False, 30, None),
    (2, 2, 2, 80, 80, True, None, 192 ** -0.5),
]


class TestHeadDim256:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window,scale",
                             DH256_CASES)
    def test_bf16_plain_matches_pallas(self, b, hq, hkv, sq, skv, causal,
                                       window, scale):
        """The plain version (what ``prefill_wgmma`` is held to on the
        card) against the JAX package's Pallas kernel in interpret mode on
        the same bf16 values, within ``BF16_TOL`` (the JAX package's own
        bf16 tolerance: p is rounded relative to each one's running
        max)."""
        q, k, v = _qkv(sq * 7 + skv, b, hq, hkv, sq, skv, 256)
        assert tfa.route(bf16, 256, sq, hq // hkv, skv) == "prefill_wgmma"
        tq, tk, tv = (torch.from_numpy(a).to(bf16) for a in (q, k, v))
        got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  scale=scale)
        assert got.dtype == bf16 and got.shape == (b, hq, sq, 256)
        want = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            causal=causal, window=window, scale=scale,
                            block_q=16, block_k=16, interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)

    @pytest.mark.parametrize("dtype,tol", [(f32, TOL), (bf16, BF16_TOL)])
    def test_mla_padded_call_cut_to_dv(self, dtype, tol):
        """MLA's prefill call — q / k of 192 and v of 128 zero-padded to
        256 (``layers.mla.padded_head_dim``), the scale of 192 — cut back
        to 128 columns equals the plain version on the unpadded tensors
        (float32 within ``TOL``: only the order of the sums differs; bf16
        within ``BF16_TOL``); the padded columns come out 0."""
        import torch.nn.functional as F

        from repro_torch.configs import get_arch
        from repro_torch.layers.mla import padded_head_dim

        mla = get_arch("deepseek-v2-236b").CONFIG.mla
        dqk, dv = mla.d_nope + mla.d_rope, mla.d_v
        dh = padded_head_dim(mla)
        assert (dqk, dv, dh) == (192, 128, 256)
        rng = np.random.default_rng(17)
        q, k = (torch.from_numpy(rng.normal(size=(1, 3, 70, dqk)).astype(
            np.float32)).to(dtype) for _ in range(2))
        v = torch.from_numpy(rng.normal(size=(1, 3, 70, dv)).astype(
            np.float32)).to(dtype)
        assert tfa.route(dtype, dh, 70, 1, 70) == (
            "prefill_wgmma" if dtype == bf16 else "fma")
        out = ops.flash_attention(F.pad(q, (0, dh - dqk)),
                                  F.pad(k, (0, dh - dqk)),
                                  F.pad(v, (0, dh - dv)), causal=True,
                                  scale=dqk ** -0.5)
        assert not out[..., dv:].any()
        want = tfa.flash_attention_plain(q, k, v, causal=True,
                                         scale=dqk ** -0.5)
        torch.testing.assert_close(out[..., :dv].float(), want.float(),
                                   rtol=tol, atol=tol)


def _jax_masked_scores(q, k, causal, window):
    """The JAX reference's scores (``repro.kernels.ref.flash_attention_ref``:
    kv heads repeated, scale dh ** -0.5, queries aligned to the end of kv,
    -inf where masked)."""
    q, k = jnp.asarray(q), jnp.asarray(k)
    b, hq, sq, dh = q.shape
    k = jnp.repeat(k, hq // k.shape[1], axis=1)
    skv = k.shape[2]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) / (dh ** 0.5)
    qpos = jnp.arange(sq)[:, None] + (skv - sq)
    kpos = jnp.arange(skv)[None, :]
    mask = jnp.ones((sq, skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return jnp.where(mask[None, None], s, -jnp.inf)


# b, hq, hkv, sq, skv, dh, causal, window: groups 1, 4, 12; Sq != Skv both
# ways; windows with and without the causal mask; rows with no kept key
LSE_CASES = [
    (2, 4, 4, 24, 24, 16, True, None),
    (1, 8, 2, 9, 30, 16, True, None),
    (1, 12, 1, 20, 20, 8, True, 5),
    (1, 4, 1, 12, 17, 8, False, 6),
    (1, 24, 2, 16, 40, 8, False, None),
    (1, 4, 2, 10, 4, 8, True, None),       # Sq > Skv: six rows keep no key
    (1, 12, 4, 30, 30, 16, False, 1),      # a window of one key
]


class TestLogSumExp:
    @pytest.mark.parametrize("case", LSE_CASES)
    def test_plain_lse_matches_jax_logsumexp(self, case):
        b, hq, hkv, sq, skv, dh, causal, window = case
        q, k, v = _qkv(len(LSE_CASES) + sq * skv, b, hq, hkv, sq, skv, dh)
        want = np.asarray(jax.nn.logsumexp(
            _jax_masked_scores(q, k, causal, window), axis=-1))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        out, got = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                             window=window, return_lse=True)
        assert got.shape == (b, hq, sq) and got.dtype == torch.float32
        got = got.numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(got[~fin], want[~fin])
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
        assert torch.equal(out, tfa.flash_attention_plain(
            tq, tk, tv, causal=causal, window=window))
        # the wrapper on CPU tensors hands back the same pair, no launch
        before = (tfa.launches, dict(tfa.launches_by_kernel))
        out2, lse2 = tfa.flash_attention(tq, tk, tv, causal=causal,
                                         window=window, return_lse=True)
        assert (tfa.launches, tfa.launches_by_kernel) == before
        assert torch.equal(out2, out) and np.array_equal(lse2.numpy(), got)

    def test_scale_and_bf16(self):
        """A given scale, and bf16 inputs: lse is the float32 log-sum-exp
        of the float32 scores of the bf16 values."""
        q, k, v = _qkv(4, 1, 4, 2, 12, 12, 16)
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v))
        _, got = tfa.flash_attention_plain(tq, tk, tv, causal=True, scale=0.3,
                                           return_lse=True)
        s = _jax_masked_scores(tq.float().numpy(), tk.float().numpy(), True,
                               None) * (0.3 * 16 ** 0.5)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax.nn.logsumexp(s, axis=-1)),
                                   rtol=1e-5, atol=1e-5)
        assert got.dtype == torch.float32


class TestBackwardRoute:
    @pytest.mark.parametrize("dtype,dh,kind", [
        (bf16, 64, "bwd_wgmma"), (bf16, 128, "bwd_wgmma"),
        (bf16, 16, "bwd_fma"), (bf16, 32, "bwd_fma"), (bf16, 256, "bwd_wgmma"),
        (f32, 64, "bwd_fma"), (f32, 128, "bwd_fma"), (f32, 256, "bwd_fma"),
        (f32, 16, "bwd_fma"),
    ])
    def test_route(self, dtype, dh, kind):
        """The tensor-core backward exactly for bf16 at the prefill
        kernel's head dims (64, 128, 256); the FMA kernels otherwise."""
        assert tfa.backward_route(dtype, dh) == kind
        assert (kind == "bwd_wgmma") == (dtype == bf16
                                         and dh in tfa.BWD_WGMMA_HEAD_DIMS)
        assert set(tfa.bwd_launches_by_kernel) == {"bwd_wgmma", "bwd_fma"}

    def test_dh256_forward_on_wgmma_backward_on_fma(self):
        """bf16 at head dim 256 is on the tensor cores both ways: it
        prefills on ``prefill_wgmma`` and takes ``bwd_wgmma`` for its
        gradient; the two routes' head dims are the same."""
        assert 256 in tfa.WGMMA_HEAD_DIMS
        assert tfa.BWD_WGMMA_HEAD_DIMS == tfa.WGMMA_HEAD_DIMS == (64, 128, 256)
        assert tfa.route(bf16, 256, 2048, 2, 2048) == "prefill_wgmma"
        assert tfa.backward_route(bf16, 256) == "bwd_wgmma"
        assert tfa.backward_route(f32, 256) == "bwd_fma"
        for dh in tfa.BWD_WGMMA_HEAD_DIMS:
            assert dh in tfa.WGMMA_HEAD_DIMS
            assert tfa.backward_route(bf16, dh) == "bwd_wgmma"

    def test_fma_source_holds_what_the_route_sends_it(self):
        """``csrc/flash_attention_bwd.cu`` compiles the FMA kernels for
        both types at the head dims of its switch (16, 32) and for float32
        alone at 64, 128 and 256: every (dtype, head dim) that
        `backward_route` sends to ``bwd_fma`` is there, and bf16 at 64 /
        128 / 256 (``bwd_wgmma``'s) is not."""
        import re

        from repro_torch.kernels import _build

        src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
        body = src[src.index("cudaError_t launch_dh("):]
        body = body[:body.index("\n}\n")]
        both = {int(d) for d in re.findall(r"case (\d+): return launch<", body)}
        f32_only = {int(d) for d in re.findall(
            r"if \(a\.dh == (\d+)\) return launch<", body)}
        assert "std::is_same_v<T, float>" in body
        assert both == {16, 32} and f32_only == {64, 128, 256}
        for dh in tfa.HEAD_DIMS:
            assert (tfa.backward_route(bf16, dh) == "bwd_fma") == (dh in both)
            assert tfa.backward_route(f32, dh) == "bwd_fma"
            assert dh in both | f32_only

    def test_timing_script_covers_the_routes(self):
        """`launch/flash_bwd_time.py` checks and times each route only on
        calls the route takes: ``bwd_wgmma`` at Gemma3's windowed and
        global calls and MLA's padded call (its scale) at head dim 256
        beside StarCoder2's, ``bwd_fma`` in float32 and at head dim 32."""
        from repro_torch.launch.flash_bwd_time import CHECKS, SHAPES

        for route, cases in CHECKS.items():
            for case in cases:
                dtype = getattr(torch, (list(case[9:]) or ["bfloat16"])[0])
                assert tfa.backward_route(dtype, case[5]) == route, case
        for route, shapes in SHAPES.items():
            for b, hq, hkv, s, dh, window, scale, dtype in shapes.values():
                assert tfa.backward_route(getattr(torch, dtype), dh) == route
        wgmma = SHAPES["bwd_wgmma"]
        assert {n for n, v in wgmma.items() if v[4] == 256} == {
            "gemma3_window_dh256", "gemma3_global_dh256", "mla_padded_group1"}
        assert wgmma["gemma3_window_dh256"][5] == 1024
        assert wgmma["mla_padded_group1"][6] == 192 ** -0.5
        assert {c[5] for c in CHECKS["bwd_wgmma"]} == set(
            tfa.BWD_WGMMA_HEAD_DIMS)
        assert {c[5] for c in CHECKS["bwd_fma"]} >= {32, 256}

    @pytest.mark.parametrize("route,name", [
        ("bwd_fma", "no_range"), ("bwd_fma", "k_range"),
        ("bwd_fma", "touch_k"), ("bwd_fma", "prefetch_dq"),
        ("bwd_fma", "prefetch"), ("bwd_fma", "dkdv_range")])
    def test_timing_script_patches_match_the_kernel(self, route, name):
        """The patched copies `launch/flash_bwd_time.py` builds still find
        each text they replace, once, in the route's source."""
        from repro_torch.kernels import _build
        from repro_torch.launch.flash_bwd_time import PATCHES

        assert set(PATCHES["bwd_fma"]) == {"no_range", "k_range", "touch_k",
                                           "prefetch_dq", "prefetch",
                                           "dkdv_range"}
        stem = tfa._BWD_LIBS[route][0]
        src = (_build.CSRC / f"{stem}.cu").read_text()
        text = src
        for old, new in PATCHES[route][name]:
            assert text.count(old) == 1 and old != new
            text = text.replace(old, new)
        assert _build.patched(stem, PATCHES[route][name]) == text != src
        with pytest.raises(RuntimeError, match="no longer matches"):
            _build.patched(stem, [("no such text in the source", "")])


class TestBackwardPlan:
    """`backward_plan`: the tensor-core backward's tiles and each launch's
    shared memory by head dim, as ``csrc/flash_attention_bwd_wgmma.cu``
    builds them."""

    @pytest.mark.parametrize("dh", [64, 128, 256])
    def test_fits_shared_memory(self, dh):
        rows, roles, ring, cluster, order, smem_dq, smem_kv = \
            tfa.backward_plan(dh)
        assert dh in tfa.BWD_WGMMA_HEAD_DIMS
        assert rows == tfa.BACKWARD_ROWS == 64
        assert roles in (0, 1) and ring >= 2 and cluster in (1, 2)
        assert order in (0, 1)
        assert max(smem_dq, smem_kv) <= tfa.SMEM_MAX == 232_448
        tile = rows * 2 * dh
        # dQ: Q, dO and two K / V slots; dK / dV: K, V and the Q / dO ring
        assert smem_dq > 6 * tile and smem_kv > (2 + 2 * ring) * tile
        # by role the warpgroups share one step, so one 64 x 64 float32 P^T
        # exchange; else each warpgroup has two slots of its own
        assert smem_kv - (1024 + (2 + 2 * ring) * tile) > \
            (rows * rows * 4 if roles else 0)
        assert roles or ring == 4

    def test_dh64_dh128_keep_their_layout_dh256_splits_by_role(self):
        """Head dims 64 and 128 keep the plan they ran with before 256
        joined (each dK / dV warpgroup its own steps and two slots, clusters
        of two, blocks by tile; 50,200 / 84,008 and 99,352 / 165,928
        bytes); 256 splits each step by role over one two-slot ring, with
        no cluster, blocks by group, 197,656 / 215,080 bytes (ten 32 KB
        tiles would be 320 KB)."""
        assert tfa.backward_plan(64) == (64, 0, 4, 2, 0, 50_200, 84_008)
        assert tfa.backward_plan(128) == (64, 0, 4, 2, 0, 99_352, 165_928)
        assert tfa.backward_plan(256) == (64, 1, 2, 1, 1, 197_656, 215_080)
        assert 1024 + 10 * 64 * 2 * 256 > tfa.SMEM_MAX

    def test_plan_matches_the_source(self):
        """The ``BWD_PLAN`` table and the constants of the CUDA source are
        the wrapper's; the launcher dispatches every head dim the route
        sends it, and the plan entry reports each of them."""
        import re

        from repro_torch.kernels import _build

        src = (_build.CSRC / "flash_attention_bwd_wgmma.cu").read_text()
        table = {int(m[0]): tuple(int(x) for x in m[1:]) for m in re.findall(
            r"^BWD_PLAN\((\d+), (\d+), (\d+), (\d+), (\d+)\)$", src,
            re.M)}
        assert table == tfa.BACKWARD_PLANS
        assert set(table) == set(tfa.BWD_WGMMA_HEAD_DIMS)
        assert re.search(r"constexpr int kRows = (\d+);", src)[1] == \
            str(tfa.BACKWARD_ROWS)
        assert re.search(r"constexpr int kSmemMax = (\d+);", src)[1] == \
            str(tfa.SMEM_MAX)
        entry = src[src.index("int flash_attention_backward_wgmma_launch("):]
        entry = entry[:entry.index("\n}\n")]
        launched = re.findall(r"if \(a\.dh == (\d+)\) err = launch<(\d+)>",
                              entry)
        assert all(dh == inst for dh, inst in launched)
        assert {int(dh) for dh, _ in launched} == set(tfa.BWD_WGMMA_HEAD_DIMS)
        plan = src[src.index("int flash_bwd_plan("):]
        plan = plan[:plan.index("\n}\n")]
        cases = re.search(r"BWD_CASE\((\d+)\) BWD_CASE\((\d+)\) "
                          r"BWD_CASE\((\d+)\)", plan)
        assert tuple(int(d) for d in cases.groups()) == \
            tfa.BWD_WGMMA_HEAD_DIMS


class TestFlashAttentionFnLse:
    @pytest.mark.parametrize("case", LSE_CASES)
    def test_saves_lse_and_matches_autograd_of_plain(self, case):
        """On CPU tensors the autograd Function runs the plain forward,
        saves its log-sum-exp beside q, k and v, and its backward (given
        that lse) equals autograd of the plain forward."""
        b, hq, hkv, sq, skv, dh, causal, window = case
        q, k, v = _qkv(sq + skv, b, hq, hkv, sq, skv, dh)
        do = torch.from_numpy(np.random.default_rng(sq).normal(
            size=(b, hq, sq, dh)).astype(np.float32))
        fn = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = tfa.FlashAttentionFn.apply(*fn, causal, window, None)
        saved = out.grad_fn.saved_tensors
        assert len(saved) == 4
        _, lse = tfa.flash_attention_plain(*fn, causal=causal, window=window,
                                           return_lse=True)
        assert torch.equal(saved[3], lse)
        before = (tfa.bwd_launches, dict(tfa.bwd_launches_by_kernel))
        out.backward(do)
        assert (tfa.bwd_launches, tfa.bwd_launches_by_kernel) == before
        ref = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        tfa.flash_attention_plain(*ref, causal=causal,
                                  window=window).backward(do)
        for f, r in zip(fn, ref):
            torch.testing.assert_close(f.grad, r.grad, rtol=1e-4, atol=1e-5)
