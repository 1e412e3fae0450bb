"""The port's sharding logic against the JAX package's, and the elastic
training launcher across worlds.

  * ``ShardingCtx.spec`` / ``tree_shardings`` against ``repro``'s on
    ``jax.sharding.AbstractMesh`` meshes of 8, 4×2, 2×4, 16×16 and
    2×16×16 (names and sizes only, no devices, on either side);
  * DTensor placements (``sharding``) read back as the spec;
  * the five logical-axes trees for every registered config;
  * ``make_elastic_mesh``'s shape for world sizes 1-64 against
    ``repro.launch.mesh.make_elastic_mesh`` over as many stand-in devices;
  * the elastic rescale: a Qwen3-MoE smoke checkpoint written by a 4-rank
    ``torch.distributed.run`` launch (CPU, ``gloo``) resumes on 2 ranks,
    and in the JAX package's launcher.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jax_arch, list_archs
from repro.launch import mesh as jax_mesh
from repro.models import egnn as JE, lm as JL, recsys as JR
from repro.optim.adamw import opt_state_logical as jax_opt_logical
from repro.sharding.specs import make_ctx as jax_make_ctx
from repro_torch.configs import family_of, get_arch
from repro_torch.launch.mesh import elastic_shape
from repro_torch.models import egnn as PE, lm as PL, recsys as PR
from repro_torch.optim import adamw_init, opt_state_logical
from repro_torch.sharding import AbstractMesh as PortMesh, make_ctx

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")

MESHES = {
    "8": ((8,), ("data",)),
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _ctxs(name):
    shape, names = MESHES[name]
    return (jax_make_ctx(AbstractMesh(shape, names)),
            make_ctx(PortMesh(shape, names)))


def _norm(tree):
    """A logical / spec tree with lists and NamedTuples as plain lists."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list,)) or (isinstance(tree, tuple)
                                     and hasattr(tree, "_fields")):
        return [_norm(v) for v in tree]
    return tree


def _logical_cases():
    """(logical names, shape) pairs: every leaf of every LM config's
    param tree at its real shape, plus activation-like tensors."""
    out = []
    for arch in ("mistral-nemo-12b", "qwen3-moe-235b-a22b",
                 "deepseek-v2-236b", "gemma3-4b", "starcoder2-3b"):
        for which in ("CONFIG", "SMOKE_CONFIG"):
            cfg = getattr(jax_arch(arch), which)
            shapes = jax.eval_shape(
                lambda: JL.init_lm(jax.random.PRNGKey(0), cfg))
            logical = JL.lm_param_logical(cfg)
            flat_l = jax.tree.leaves(logical, is_leaf=lambda x: isinstance(
                x, tuple) and all(isinstance(e, (str, type(None))) for e in x))
            flat_s = jax.tree.leaves(shapes)
            out += [(l, tuple(s.shape)) for l, s in zip(flat_l, flat_s)]
    for shape in ((8, 17), (256, 4096), (3, 5), (32, 2048, 128),
                  (1, 4096, 8, 128), (512, 1)):
        for names in (("batch", "seq"), ("batch", None, "embed_act"),
                      ("rows", None), ("edges", None), ("nodes", "embed"),
                      ("batch", "kv_heads", "kv_seq", None),
                      ("cand", "vocab"), ("fields", "rows", None),
                      ("expert", "embed", "mlp"), ("heads", "heads"),
                      ("unknown", "batch")):
            if len(names) == len(shape):
                out.append((names, shape))
    return out


CASES = _logical_cases()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_equals_jax(mesh):
    jc, pc = _ctxs(mesh)
    for logical, shape in CASES:
        assert pc.spec(logical, shape) == tuple(jc.spec(logical, shape)), \
            (mesh, logical, shape)
        assert pc.spec(logical) == tuple(jc.spec(logical)), (mesh, logical)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_read_back_as_the_spec(mesh):
    """``sharding``'s ``Shard(i)`` / ``Replicate()`` per mesh dim say what
    the spec says: mesh axis a shards tensor dim i iff a is in entry i."""
    from torch.distributed.tensor import Replicate, Shard

    _, pc = _ctxs(mesh)
    names = MESHES[mesh][1]
    for logical, shape in CASES:
        spec = pc.spec(logical, shape)
        placements = pc.sharding(logical, shape)
        assert len(placements) == len(names)
        for a, pl in zip(names, placements):
            dims = [i for i, e in enumerate(spec)
                    if e == a or (isinstance(e, tuple) and a in e)]
            if dims:
                assert pl == Shard(dims[0])
            else:
                assert pl == Replicate()


def test_placements_refuse_an_axis_order_dtensor_cannot_hold():
    pc = make_ctx(PortMesh((2, 4), ("pod", "data")),
                  overrides={"rows": ("data", "pod")})
    assert pc.spec(("rows",), (16,)) == (("data", "pod"),)
    with pytest.raises(ValueError):
        pc.sharding(("rows",), (16,))


def test_no_mesh_is_replicated():
    from repro_torch.sharding import NULL_CTX
    assert NULL_CTX.spec(("batch", "embed"), (8, 8)) == ()
    assert NULL_CTX.sharding(("batch",)) is None
    x = np.zeros(3)
    assert NULL_CTX.constrain(x, ("batch",)) is x
    assert NULL_CTX.local_block(x, ("batch",)) is x


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen3-moe-235b-a22b",
                                  "deepseek-v2-236b"])
def test_tree_shardings_equal_jax(mesh, arch):
    """Over the smoke LM's param tree and its AdamW state: each leaf's
    placements are the JAX package's ``NamedSharding.spec`` for it."""
    jc, pc = _ctxs(mesh)
    jcfg = jax_arch(arch).SMOKE_CONFIG
    pcfg = get_arch(arch).SMOKE_CONFIG
    params = PL.param_tree(PL.init_lm(pcfg, seed=0, device="cpu"))
    shapes = jax.eval_shape(lambda: JL.init_lm(jax.random.PRNGKey(0), jcfg))
    jlog, plog = JL.lm_param_logical(jcfg), PL.lm_param_logical(pcfg)
    jsh = jc.tree_shardings(jlog, shapes)
    psh = pc.tree_shardings(plog, params)
    names = MESHES[mesh][1]

    def spec_of(placements):
        """The spec these placements encode (mesh-dim order)."""
        per_dim = {}
        for a, pl in zip(names, placements):
            if type(pl).__name__ == "Shard":
                per_dim.setdefault(pl.dim, []).append(a)
        n = max(per_dim, default=-1) + 1
        out = [None if i not in per_dim else
               (per_dim[i][0] if len(per_dim[i]) == 1 else tuple(per_dim[i]))
               for i in range(n)]
        return tuple(out)

    def walk(j, p):
        if isinstance(p, dict):
            assert set(j) == set(p)
            for k in p:
                walk(j[k], p[k])
        else:
            assert spec_of(p) == tuple(j.spec)

    walk(jsh, psh)
    opt = pc.tree_shardings(opt_state_logical(plog), adamw_init(params))
    assert opt.mu == psh and opt.nu == psh
    assert all(type(a).__name__ == "Replicate" for a in opt.step)


ALL_CONFIGS = [(arch, which) for arch in list_archs()
               for which in ("CONFIG", "SMOKE_CONFIG")]


@pytest.mark.parametrize("arch,which", ALL_CONFIGS)
def test_logical_trees_equal_jax(arch, which):
    """``lm_param_logical`` / ``cache_logical`` / ``recsys_param_logical``
    / ``egnn_param_logical`` and ``opt_state_logical`` over them, equal to
    the JAX package's for every registered config."""
    jcfg, pcfg = getattr(jax_arch(arch), which), getattr(get_arch(arch), which)
    fam = family_of(arch)
    if fam == "lm":
        jl, pl = JL.lm_param_logical(jcfg), PL.lm_param_logical(pcfg)
        assert _norm(PL.cache_logical(pcfg)) == _norm(JL.cache_logical(jcfg))
    elif fam == "gnn":
        jl, pl = JE.egnn_param_logical(jcfg), PE.egnn_param_logical(pcfg)
    else:
        # the function reads only the tree's structure: the JAX package's
        # abstract tree stands in for the full configs' tables
        shapes = jax.eval_shape(
            lambda: JR.recsys_init(jax.random.PRNGKey(0), jcfg))
        jl = JR.recsys_param_logical(jcfg, shapes)
        pl = PR.recsys_param_logical(pcfg, shapes)
    assert _norm(pl) == _norm(jl)
    assert _norm(opt_state_logical(pl)) == _norm(jax_opt_logical(jl))


@pytest.mark.parametrize("arch", list_archs())
def test_logical_trees_fit_the_param_trees(arch):
    """Each smoke config's logical tree has its `param_tree`'s structure,
    so ``tree_shardings`` maps one onto the other."""
    cfg = get_arch(arch).SMOKE_CONFIG
    fam = family_of(arch)
    if fam == "lm":
        params = PL.param_tree(PL.init_lm(cfg, seed=0, device="cpu"))
        logical = PL.lm_param_logical(cfg)
    elif fam == "gnn":
        params = PE.param_tree(PE.egnn_init(cfg, seed=0, device="cpu"))
        logical = PE.egnn_param_logical(cfg)
    else:
        params = PR.param_tree(PR.recsys_init(cfg, seed=0, device="cpu"))
        logical = PR.recsys_param_logical(cfg, params)
    pc = make_ctx(PortMesh((2, 4), ("data", "model")))
    out = pc.tree_shardings(logical, params)
    assert _norm(out) is not None


@pytest.mark.parametrize("n", range(1, 65))
def test_elastic_shape_equals_jax(n, monkeypatch):
    monkeypatch.setattr(jax_mesh.jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(jax_mesh, "make_mesh_compat",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    shape, axes = jax_mesh.make_elastic_mesh()
    assert axes == ("data", "model")
    assert elastic_shape(n) == shape
    for n_model in (1, 2, 3, 8):
        shape, _ = jax_mesh.make_elastic_mesh(n_model)
        assert elastic_shape(n, n_model) == shape


def _launch(args, n_ranks=None, env_extra=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    if n_ranks is None:
        cmd = [sys.executable, "-m"] + args
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n_ranks}", "-m"] + args
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def _losses(out):
    return [float(x) for x in re.findall(r"\[train\] step \d+: loss=(\S+)",
                                         out)]


def test_elastic_rescale_4_to_2_ranks_and_to_the_jax_package(tmp_path):
    ck = str(tmp_path / "ckpt")
    arch = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--ckpt-dir", ck]
    out4 = _launch(["repro_torch.launch.train", *arch, "--steps", "10",
                    "--device", "cpu"], n_ranks=4)
    lines = out4.strip().splitlines()
    assert lines[0] == "[launch] process group: gloo, world 4 (CPU ranks)"
    assert "[launch] elastic mesh: {'data': 1, 'model': 4}" in out4
    assert len(_losses(out4)) == 1 and np.isfinite(_losses(out4)).all()
    assert sorted(os.listdir(ck)) == ["step_00000010"]

    out2 = _launch(["repro_torch.launch.train", *arch, "--steps", "14",
                    "--device", "cpu"], n_ranks=2)
    assert "[launch] elastic mesh: {'data': 1, 'model': 2}" in out2
    assert "[train] restored checkpoint at step 10" in out2
    assert "step 14" in out2 and np.isfinite(_losses(out2)).all()

    out_jax = _launch(["repro.launch.train", *arch, "--steps", "16"])
    assert "[train] restored checkpoint at step 14" in out_jax
    assert np.isfinite(_losses(out_jax)).all()
