"""The port's train step, loop and launcher against the JAX package's, on
the CPU.

* ``make_train_step`` for one step and with ``accum_steps=4`` against the
  JAX package's step from the same weights and batch (parameters after the
  step within ``2e-3``, the JAX package's own accumulation bound in
  ``tests/test_train_and_ckpt.py``: step 1 of AdamW is about sign(g), so
  a gradient near 0 may take either sign in another summation order).
* Mirrors of ``TestTrainLoop`` and ``TestRecsysTraining`` of
  ``tests/test_train_and_ckpt.py`` and of ``tests/test_archs.py``'s train
  steps.
* Resume across packages: a run of 10 steps of either package's
  ``TrainLoop`` resumes in the other at step 10 (``opt_state.step ==
  10``), whose step 11 matches the first run's own step 11.
* The launcher, ``python -m repro_torch.launch.train ... --device cpu``.
"""

import itertools
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax
import jax.numpy as jnp

from repro.configs.base import LMConfig as JLMConfig
from repro.data import lm_batch_stream as j_lm_stream
from repro.models import lm as JL
from repro.optim import adamw_init as j_adamw_init
from repro.train import TrainLoop as JTrainLoop
from repro.train import make_train_step as j_make_train_step

from repro_torch.checkpoint.ckpt import _leaves
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMConfig
from repro_torch.data.synth import lm_batch_stream, recsys_batch_stream
from repro_torch.models import egnn as TE
from repro_torch.models import graph as TG
from repro_torch.models import lm as TL
from repro_torch.models import recsys as TR
from repro_torch.optim import adamw_init
from repro_torch.train import TrainLoop, make_train_step
from repro_torch.train.loop import to_device

SRC = Path(__file__).resolve().parents[1] / "src"
TINY_KW = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
               d_head=16, d_ff=64, vocab=64, param_dtype="float32",
               compute_dtype="float32", remat=False)
J_TINY, TINY = JLMConfig(**TINY_KW), LMConfig(**TINY_KW)
STEP_TOL = 2e-3


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def tiny_tree(seed=0):
    """(JAX params, the port's param_tree of the same weights)."""
    jp = JL.init_lm(jax.random.PRNGKey(seed), J_TINY)
    return jp, TL.param_tree(TL.load_jax_params(to_np(jp), TINY,
                                                device="cpu"))


def port_lm_loss(p, b):
    return TL.lm_loss(TL.lm_view(p, TINY), b)


def assert_params_close(tree, jtree, tol=STEP_TOL):
    leaves, treedef = _leaves(tree)
    assert treedef == str(jax.tree.structure(jtree))
    for got, want in zip(leaves, jax.tree.leaves(jtree)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


class TestTrainStep:
    @pytest.mark.parametrize("accum", [1, 4])
    def test_step_matches_reference(self, accum):
        jp, tp = tiny_tree()
        batch = next(j_lm_stream(np.random.default_rng(0), TINY.vocab, 8, 16))
        jstep = j_make_train_step(lambda p, b: JL.lm_loss(p, b, J_TINY),
                                  accum_steps=accum, donate=False)
        jp2, jo2, jm = jstep(jp, j_adamw_init(jp),
                             jax.tree.map(jnp.asarray, batch))
        step = make_train_step(port_lm_loss, accum_steps=accum)
        tp2, to2, tm = step(tp, adamw_init(tp), to_device(batch, "cpu"))
        assert int(to2.step) == int(jo2.step) == 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert_params_close(tp2, jp2)
        for got, want in zip(_leaves(to2.mu)[0], jax.tree.leaves(jo2.mu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-3, atol=1e-7)

    def test_grad_accum_matches_full_batch(self):
        _, tp = tiny_tree()
        batch = to_device(next(lm_batch_stream(np.random.default_rng(0),
                                               TINY.vocab, 8, 16)), "cpu")
        s1 = make_train_step(port_lm_loss, accum_steps=1, donate=False)
        s4 = make_train_step(port_lm_loss, accum_steps=4, donate=False)
        p1, _, _ = s1(tp, adamw_init(tp), batch)
        p4, _, _ = s4(tp, adamw_init(tp), batch)
        for a, b in zip(_leaves(p1)[0], _leaves(p4)[0]):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=2e-3,
                                       atol=2e-3)

    def test_donate_updates_in_place(self):
        _, tp = tiny_tree()
        batch = to_device(next(lm_batch_stream(np.random.default_rng(1),
                                               TINY.vocab, 4, 8)), "cpu")
        embed = tp["embed"]
        before = embed.detach().clone()
        new, _, metrics = make_train_step(port_lm_loss)(tp, adamw_init(tp),
                                                        batch)
        assert new["embed"] is embed and not torch.equal(embed, before)
        assert not metrics["loss"].requires_grad


def _reference_loop(ckpt_dir, steps_data):
    return JTrainLoop(
        lambda p, b: JL.lm_loss(p, b, J_TINY),
        lambda: JL.init_lm(jax.random.PRNGKey(0), J_TINY), steps_data,
        ckpt_dir=str(ckpt_dir), ckpt_every=5, log_every=100,
        base_lr=2e-3, warmup=5, total_steps=60)


def _port_loop(ckpt_dir, steps_data, prefetch=True):
    return TrainLoop(
        port_lm_loss, lambda: tiny_tree(1)[1], steps_data,
        ckpt_dir=None if ckpt_dir is None else str(ckpt_dir), ckpt_every=5,
        log_every=100, base_lr=2e-3, warmup=5, total_steps=60,
        prefetch=prefetch)


class TestTrainLoop:
    def test_lm_loss_decreases(self):
        rng = np.random.default_rng(0)
        loop = TrainLoop(port_lm_loss, lambda: tiny_tree()[1],
                         lm_batch_stream(rng, TINY.vocab, 8, 16),
                         log_every=5, base_lr=2e-3, warmup=5, total_steps=60)
        loop.run(60)
        first = loop.history[0]["loss"]
        last = np.mean([h["loss"] for h in loop.history[-3:]])
        assert last < first - 0.1, (first, last)
        assert loop.history[-1]["step_p95_ms"] >= loop.history[-1][
            "step_p50_ms"] > 0

    def test_restart_resumes_step(self, tmp_path):
        rng = np.random.default_rng(0)
        loop = _port_loop(tmp_path, lm_batch_stream(rng, TINY.vocab, 4, 8))
        loop.run(10)
        loop2 = _port_loop(tmp_path, lm_batch_stream(rng, TINY.vocab, 4, 8))
        assert loop2.start_step == 10
        assert int(loop2.state[1].step) == 10
        for a, b in zip(_leaves(loop.state)[0], _leaves(loop2.state)[0]):
            assert torch.equal(a.detach(), b)

    def test_interrupt_saves_an_emergency_checkpoint(self, tmp_path):
        def data():
            stream = lm_batch_stream(np.random.default_rng(0), TINY.vocab,
                                     4, 8)
            for i, b in enumerate(stream):
                if i == 3:
                    raise KeyboardInterrupt
                yield b

        loop = _port_loop(tmp_path, data(), prefetch=False)
        with pytest.raises(KeyboardInterrupt):
            loop.run(10)
        assert _port_loop(tmp_path, iter(())).start_step == 3

    def test_reference_run_resumes_in_the_port(self, tmp_path):
        """The reference runs 10 steps with checkpoints; the port resumes
        at step 10 and its step 11 is the reference's step 11."""
        _reference_loop(tmp_path / "j", j_lm_stream(
            np.random.default_rng(0), TINY.vocab, 4, 8)).run(10)
        shutil.copytree(tmp_path / "j", tmp_path / "p")
        ref = _reference_loop(tmp_path / "j", itertools.islice(
            j_lm_stream(np.random.default_rng(0), TINY.vocab, 4, 8), 10,
            None))
        port = _port_loop(tmp_path / "p", itertools.islice(
            lm_batch_stream(np.random.default_rng(0), TINY.vocab, 4, 8), 10,
            None))
        assert port.start_step == 10 and int(port.state[1].step) == 10
        assert port.state[1].step.dim() == 0
        assert_params_close(port.state[0], ref.state[0], tol=0)
        ref.run(11)
        port.run(11)
        assert int(port.state[1].step) == int(ref.state[1].step) == 11
        assert_params_close(port.state[0], ref.state[0], tol=1e-5)

    def test_port_run_resumes_in_the_reference(self, tmp_path):
        _port_loop(tmp_path / "p", lm_batch_stream(
            np.random.default_rng(0), TINY.vocab, 4, 8)).run(10)
        shutil.copytree(tmp_path / "p", tmp_path / "j")
        port = _port_loop(tmp_path / "p", itertools.islice(
            lm_batch_stream(np.random.default_rng(0), TINY.vocab, 4, 8), 10,
            None))
        ref = _reference_loop(tmp_path / "j", itertools.islice(
            j_lm_stream(np.random.default_rng(0), TINY.vocab, 4, 8), 10,
            None))
        assert ref.start_step == 10 and int(ref.state[1].step) == 10
        assert_params_close(port.state[0], ref.state[0], tol=0)
        port.run(11)
        ref.run(11)
        assert int(port.state[1].step) == int(ref.state[1].step) == 11
        assert_params_close(port.state[0], ref.state[0], tol=1e-5)


class TestRecsysTraining:
    @pytest.mark.parametrize("family", ["dlrm", "din"])
    def test_ctr_loss_decreases(self, family):
        arch = {"dlrm": "dlrm-rm2", "din": "din"}[family]
        cfg = get_arch(arch).SMOKE_CONFIG
        rng = np.random.default_rng(0)
        loop = TrainLoop(
            lambda p, b: TR.recsys_loss(p, b, cfg),
            lambda: TR.param_tree(TR.recsys_init(cfg, device="cpu")),
            recsys_batch_stream(rng, cfg.family, 128,
                                n_sparse=cfg.n_sparse or 6,
                                vocab=cfg.vocab_per_field,
                                n_dense=cfg.n_dense or 13,
                                seq_len=cfg.seq_len or 10),
            log_every=10, base_lr=5e-3, warmup=10, total_steps=150)
        loop.run(150)
        first = loop.history[0]["loss"]
        last = np.mean([h["loss"] for h in loop.history[-3:]])
        assert last < first - 0.003, (first, last)


def _one_train_step(loss_fn, params, batch):
    """(loss, the largest parameter change) of one AdamW step."""
    before = [p.detach().clone() for p in _leaves(params)[0]]
    step = make_train_step(loss_fn, base_lr=1e-3, warmup=0)
    new, _, metrics = step(params, adamw_init(params), batch)
    delta = max(float((a.detach() - b).abs().max())
                for a, b in zip(_leaves(new)[0], before))
    return metrics["loss"], delta


class TestArchTrainSteps:
    @pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-4b",
                                      "mistral-nemo-12b",
                                      "deepseek-v2-236b",
                                      "qwen3-moe-235b-a22b"])
    def test_lm_smoke(self, arch):
        cfg = get_arch(arch).SMOKE_CONFIG
        params = TL.param_tree(TL.init_lm(cfg, device="cpu"))
        batch = to_device(next(lm_batch_stream(np.random.default_rng(0),
                                               cfg.vocab, 2, 16)), "cpu")
        loss, delta = _one_train_step(
            lambda p, b: TL.lm_loss(TL.lm_view(p, cfg), b), params, batch)
        assert bool(torch.isfinite(loss)) and delta > 0

    @pytest.mark.parametrize("kind", ["full_graph", "molecules"])
    def test_egnn_smoke(self, kind):
        cfg = get_arch("egnn").SMOKE_CONFIG
        rng = np.random.default_rng(0)
        g = (TG.random_graph(rng, 64, 256, cfg.d_feat_in,
                             n_classes=cfg.n_classes, device="cpu")
             if kind == "full_graph" else
             TG.batched_molecules(rng, 8, 12, 24, cfg.d_feat_in,
                                  n_classes=cfg.n_classes, device="cpu"))
        params = TE.param_tree(TE.egnn_init(cfg, device="cpu"))
        loss, delta = _one_train_step(lambda p, b: TE.egnn_loss(p, b, cfg),
                                      params, g)
        assert bool(torch.isfinite(loss)) and delta > 0

    @pytest.mark.parametrize("arch", ["two-tower-retrieval", "din", "autoint",
                                      "dlrm-rm2"])
    def test_recsys_smoke(self, arch):
        cfg = get_arch(arch).SMOKE_CONFIG
        params = TR.param_tree(TR.recsys_init(cfg, device="cpu"))
        batch = to_device(next(recsys_batch_stream(
            np.random.default_rng(0), cfg.family, 32,
            n_sparse=cfg.n_sparse or 6, vocab=cfg.vocab_per_field,
            n_dense=cfg.n_dense or 13, seq_len=cfg.seq_len or 10)), "cpu")
        loss, delta = _one_train_step(
            lambda p, b: TR.recsys_loss(p, b, cfg), params, batch)
        assert bool(torch.isfinite(loss)) and delta > 0


class TestLauncher:
    def test_starcoder2_smoke_loss_falls(self):
        env = dict(os.environ, PYTHONPATH=str(SRC))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "starcoder2-3b", "--smoke", "--steps", "20", "--device", "cpu"],
            capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        losses = [float(x) for x in
                  re.findall(r"\[train\] step \d+: loss=(\S+)", out.stdout)]
        assert len(losses) == 2 and losses[1] < losses[0], out.stdout
        assert "[launch] done:" in out.stdout

    def test_help_names_the_single_device(self):
        env = dict(os.environ, PYTHONPATH=str(SRC))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--help"],
            capture_output=True, text=True, env=env, timeout=120)
        assert out.returncode == 0
        assert "--device" in out.stdout and "multi-device" in out.stdout
