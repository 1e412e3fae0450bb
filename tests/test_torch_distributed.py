"""The multi-device paths of the PyTorch port against the JAX package's.

The JAX side runs in a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (as
``tests/test_distributed.py`` runs it) and writes npz; the port's side runs
as one world of 8 ``gloo`` CPU processes (``torch.multiprocessing.spawn``,
a ``file://`` rendezvous in the test's temporary directory, so parallel
test workers share no port) and writes one npz a rank.  Both draw every
input from the same numpy seeds; the two subprocesses run at once.

  * the corpus-sharded progressive search (N 4,096, D 128, Q 32, schedule
    (16, 128, 16)) in both modes on an 8-shard ``data`` mesh and on a
    (2, 4) ``('pod', 'data')`` mesh, a corpus of 8 rows whose results hold
    sentinels, and an uneven N;
  * the expert-parallel MoE on a (2, 4) ``('data', 'model')`` mesh, each
    rank holding only its experts (``ShardingCtx.held_blocks``, 1/ep of
    the expert bytes): output and aux against the JAX package's EP path,
    gradients reduced by placement (``collectives.reduce_gradients_``)
    against the port's one-device gradients of each slice (the ep-fold
    check), and a decode step under the ctx (the experts gathered whole)
    equal to one device;
  * Mistral-Nemo's smoke LM trained one step on a (4, 2) mesh against one
    process; Qwen3-MoE's smoke LM one step on a (2, 4) mesh with its
    experts held split: the gradients that reach AdamW and its clipping
    norm against one process.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 8

INPUTS = """
import numpy as np

def search_inputs(n=4096, d=128, nq=32, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    gt = rng.choice(n, nq, replace=False)
    q = db[gt] + 0.05 * rng.normal(size=(nq, d)).astype(np.float32)
    return db, q, gt

def prefix_norms(db, dims):
    return np.stack([(db[:, :k] ** 2).sum(1) for k in dims],
                    1).astype(np.float32)

MOE_D, MOE_E, MOE_K, MOE_F, MOE_SHARED = 64, 8, 2, 32, 32

def moe_inputs(seed=1):
    rng = np.random.default_rng(seed)
    d, e, f = MOE_D, MOE_E, MOE_F
    def w(*shape, fan):
        return (rng.normal(size=shape) * fan ** -0.5).astype(np.float32)
    p = {"router": w(d, e, fan=d), "w_in": w(e, d, f, fan=d),
         "w_gate": w(e, d, f, fan=d), "w_out": w(e, f, d, fan=f),
         "shared": {"w_in": w(d, MOE_SHARED, fan=d),
                    "w_gate": w(d, MOE_SHARED, fan=d),
                    "w_out": w(MOE_SHARED, d, fan=MOE_SHARED)}}
    x = rng.normal(size=(4, 16, d)).astype(np.float32)
    r = rng.normal(size=(4, 16, d)).astype(np.float32)
    return p, x, r
"""

JAX_SIDE = INPUTS + """
import sys
import jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.core import make_schedule, progressive_search, stage_dims
from repro.core.distributed import sharded_progressive_search
from repro.launch.mesh import make_mesh_compat
from repro.layers.moe import moe_apply
from repro.sharding.specs import make_ctx

out = {}
db, q, gt = search_inputs()
sched = make_schedule(16, 128, 16)
dims = stage_dims(sched)
sqp = prefix_norms(db, dims)
mesh8 = make_mesh_compat((8,), ("data",))
mesh24 = make_mesh_compat((2, 4), ("pod", "data"))
for name, mesh, axes in (("d8", mesh8, ("data",)),
                         ("pd24", mesh24, ("pod", "data"))):
    for mode in ("global", "local"):
        s, c = sharded_progressive_search(
            mesh, jnp.asarray(q), jnp.asarray(db), sched, db_axes=axes,
            sq_prefix=jnp.asarray(sqp), index_dims=dims, block_n=512,
            mode=mode)
        out[f"{name}_{mode}_s"], out[f"{name}_{mode}_i"] = s, c
s, c = progressive_search(jnp.asarray(q), jnp.asarray(db), sched,
                          sq_prefix=jnp.asarray(sqp), index_dims=dims,
                          block_n=512)
out["single_s"], out["single_i"] = s, c

tdb, tq, _ = search_inputs(n=8, nq=4, seed=2)
tsched = make_schedule(16, 128, 16, final_k=16)
tsqp = prefix_norms(tdb, stage_dims(tsched))
for mode in ("global", "local"):
    s, c = sharded_progressive_search(
        mesh8, jnp.asarray(tq), jnp.asarray(tdb), tsched,
        sq_prefix=jnp.asarray(tsqp), index_dims=stage_dims(tsched),
        block_n=512, mode=mode)
    out[f"tiny_{mode}_s"], out[f"tiny_{mode}_i"] = s, c

p, x, _ = moe_inputs()
cfg = MoEConfig(n_experts=MOE_E, top_k=MOE_K, d_ff_expert=MOE_F,
                n_shared_experts=1, d_ff_shared=MOE_SHARED,
                capacity_factor=8.0)
pj = jax.tree.map(jnp.asarray, p)
y, aux = moe_apply(pj, jnp.asarray(x), cfg, "swiglu")
out["moe_single_y"], out["moe_single_aux"] = y, aux
mesh = make_mesh_compat((2, 4), ("data", "model"))
ctx = make_ctx(mesh)
with mesh:
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg, "swiglu", ctx=ctx))(
        pj, jnp.asarray(x))
out["moe_ep_y"], out["moe_ep_aux"] = y, aux
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""

PORT_SIDE = INPUTS + """
import os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def search_part(res):
    from repro_torch.core import (make_schedule, progressive_search,
                                  stage_dims)
    from repro_torch.core.distributed import (build_sharded_search,
                                              sharded_progressive_search)
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.sharding import collectives as C

    db, q, gt = search_inputs()
    sched = make_schedule(16, 128, 16)
    dims = stage_dims(sched)
    sqp = prefix_norms(db, dims)
    mesh8 = make_mesh_compat((8,), ("data",), device_type="cpu")
    mesh24 = make_mesh_compat((2, 4), ("pod", "data"), device_type="cpu")
    for name, mesh, axes in (("d8", mesh8, ("data",)),
                             ("pd24", mesh24, ("pod", "data"))):
        for mode in ("global", "local"):
            before = C.calls["all_gather"]
            s, c = sharded_progressive_search(
                mesh, t(q), t(db), sched, db_axes=axes, sq_prefix=t(sqp),
                index_dims=dims, block_n=512, mode=mode)
            res[f"{name}_{mode}_s"], res[f"{name}_{mode}_i"] = s, c
            res[f"{name}_{mode}_gathers"] = C.calls["all_gather"] - before
    s, c = progressive_search(t(q), t(db), sched, sq_prefix=t(sqp),
                              index_dims=dims, block_n=512)
    res["single_s"], res["single_i"] = s, c
    res["offset_pd24"] = C.axis_index(mesh24, ("pod", "data")) * 512

    tdb, tq, _ = search_inputs(n=8, nq=4, seed=2)
    tsched = make_schedule(16, 128, 16, final_k=16)
    tsqp = prefix_norms(tdb, stage_dims(tsched))
    for mode in ("global", "local"):
        s, c = sharded_progressive_search(
            mesh8, t(tq), t(tdb), tsched, sq_prefix=t(tsqp),
            index_dims=stage_dims(tsched), block_n=512, mode=mode)
        res[f"tiny_{mode}_s"], res[f"tiny_{mode}_i"] = s, c
    try:
        build_sharded_search(mesh8, sched, 4095)
        res["uneven_raised"] = 0
    except ValueError:
        res["uneven_raised"] = 1


def moe_part(res):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.layers.common import FFN
    from repro_torch.layers.moe import MoE, moe_apply
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.specs import make_ctx, mesh_coordinate

    p, x, r = moe_inputs()
    cfg = MoEConfig(n_experts=MOE_E, top_k=MOE_K, d_ff_expert=MOE_F,
                    n_shared_experts=1, d_ff_shared=MOE_SHARED,
                    capacity_factor=8.0)

    def module():
        sh = p["shared"]
        m = MoE(t(p["router"]), t(p["w_in"]), t(p["w_out"]), t(p["w_gate"]),
                FFN(t(sh["w_in"]), t(sh["w_out"]), t(sh["w_gate"])))
        return m.requires_grad_(True)

    mesh = make_mesh_compat((2, 4), ("data", "model"), device_type="cpu")
    ctx = make_ctx(mesh)
    coord = mesh_coordinate(mesh)
    res["coord"] = np.asarray([coord["data"], coord["model"]])

    # the layer as a rank holds it: only its experts
    from repro_torch.layers.moe import moe_specs
    logical = moe_specs(cfg, "swiglu")
    whole = {"router": t(p["router"]), "w_in": t(p["w_in"]),
             "w_gate": t(p["w_gate"]), "w_out": t(p["w_out"]),
             "shared": {k: t(v) for k, v in p["shared"].items()}}
    held = ctx.held_blocks(logical, whole)
    axes = ctx.held_axes(logical, whole)
    experts = ("w_in", "w_gate", "w_out")
    res["held_expert_bytes"] = sum(held[k].numel() * held[k].element_size()
                                   for k in experts)
    res["whole_expert_bytes"] = sum(whole[k].numel() * 4 for k in experts)
    res["held_axes_ok"] = np.asarray(
        [axes[k] == frozenset({"model"}) for k in experts]
        + [axes["router"] == frozenset()]
        + [a == frozenset() for a in axes["shared"].values()])
    sh = held["shared"]
    m_ep = MoE(held["router"], held["w_in"], held["w_out"], held["w_gate"],
               FFN(sh["w_in"], sh["w_out"], sh["w_gate"])
               ).requires_grad_(True)
    x_l = ctx.local_block(t(x), ("batch", None, None)).clone()
    x_l.requires_grad_(True)
    r_l = ctx.local_block(t(r), ("batch", None, None))
    a2a = C.calls["all_to_all"]
    y, aux = moe_apply(m_ep, x_l, cfg, "swiglu", ctx=ctx)
    res["ep_all_to_all"] = C.calls["all_to_all"] - a2a
    res["ep_y"], res["ep_aux"] = y.detach(), aux.detach()
    names = [n for n, _ in m_ep.named_parameters()]
    ps = [w for _, w in m_ep.named_parameters()]
    gs = torch.autograd.grad((y * r_l).sum(), ps + [x_l])
    res["ep_grad_x"] = gs[-1]
    gs = [g.clone() for g in gs[:-1]]
    res["ep_raw_w_in"] = gs[names.index("w_in")].clone()
    split = [axes[n] if n in axes else frozenset() for n in names]
    C.reduce_gradients_(gs, split, mesh)
    for n, g in zip(names, gs):
        res[f"ep_meangrad_{n}"] = g
    # decode under the ctx: the local path gathers the experts whole
    with torch.no_grad():
        xd = t(x)[:, :1]
        gathers = C.calls["all_gather"]
        yd, auxd = moe_apply(m_ep, xd, cfg, "swiglu", ctx=ctx)
        res["decode_gathers"] = C.calls["all_gather"] - gathers
        y1d, aux1d = moe_apply(module(), xd, cfg, "swiglu")
        res["decode_equal"] = int(torch.equal(yd, y1d)
                                  and torch.equal(auxd, aux1d))
    try:
        moe_apply(m_ep, xd, cfg, "swiglu")
        res["slice_without_ctx_raised"] = 0
    except ValueError:
        res["slice_without_ctx_raised"] = 1
    try:
        moe_apply(module(), x_l.detach(), cfg, "swiglu", ctx=ctx)
        res["whole_on_mesh_raised"] = 0
    except ValueError:
        res["whole_on_mesh_raised"] = 1

    m_1 = module()
    x1 = t(x).clone().requires_grad_(True)
    y1, aux1 = moe_apply(m_1, x1, cfg, "swiglu")
    res["single_y"], res["single_aux"] = y1.detach(), aux1.detach()
    g1 = torch.autograd.grad((y1 * t(r)).sum(),
                             [w for _, w in m_1.named_parameters()] + [x1])
    for n, g in zip(names, g1[:-1]):
        res[f"single_grad_{n}"] = g
    res["single_grad_x"] = g1[-1]


def train_part(res):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import lm as LM
    from repro_torch.optim import adamw_init, opt_state_logical
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.specs import make_ctx
    from repro_torch.train.loop import make_train_step

    cfg = get_arch("mistral-nemo-12b").SMOKE_CONFIG
    mesh = make_mesh_compat((4, 2), ("data", "model"), device_type="cpu")
    ctx = make_ctx(mesh)
    params = LM.param_tree(LM.init_lm(cfg, seed=0, device="cpu"))
    opt = adamw_init(params)
    logical = LM.lm_param_logical(cfg)
    pshard = ctx.tree_shardings(logical, params)
    oshard = ctx.tree_shardings(opt_state_logical(logical), opt)
    # every leaf cut into this rank's block and joined again by DTensor
    rt = []

    def walk(log, pl, pr):
        if isinstance(log, dict):
            for k in log:
                walk(log[k], pl[k], pr[k])
            return
        blk = ctx.local_block(pr, log)
        full = DTensor.from_local(blk, mesh, pl).full_tensor()
        rt.append(bool(torch.equal(full, pr)))
        rt.append(blk.numel() < pr.numel() or
                  all(type(a).__name__ == "Replicate" for a in pl))

    walk(logical, pshard, params)
    res["placements_round_trip"] = np.asarray(rt)
    res["opt_step_placement"] = np.asarray(
        [type(a).__name__ == "Replicate" for a in oshard.step])
    res["mu_equals_param_placements"] = int(oshard.mu == pshard)

    rng = np.random.default_rng(3)
    tokens = t(rng.integers(0, cfg.vocab, (8, 17)).astype(np.int64))

    def loss_mesh(p, b):
        return LM.lm_loss(LM.lm_view(p, cfg), b, ctx=ctx)

    def loss_one(p, b):
        return LM.lm_loss(LM.lm_view(p, cfg), b)

    kw = dict(base_lr=1e-3, warmup=1, total_steps=10, donate=False)
    before = C.calls["all_reduce"]
    new, _, m = make_train_step(loss_mesh, ctx=ctx, **kw)(
        params, adamw_init(params), {"tokens": tokens})
    res["train_all_reduce"] = C.calls["all_reduce"] - before
    ref_params = LM.param_tree(LM.init_lm(cfg, seed=0, device="cpu"))
    ref, _, m1 = make_train_step(loss_one, **kw)(
        ref_params, adamw_init(ref_params), {"tokens": tokens})
    a, b = _leaves(new)[0], _leaves(ref)[0]
    res["train_max_diff"] = max(float((x - y).abs().max())
                                for x, y in zip(a, b))
    res["train_moved"] = max(float((x - y).abs().max())
                             for x, y in zip(a, _leaves(params)[0]))
    res["train_grad_norm"] = np.asarray([float(m["grad_norm"]),
                                         float(m1["grad_norm"])])
    from repro_torch.train.loop import TrainLoop
    try:
        TrainLoop(loss_mesh, lambda: ref_params, iter([]), prefetch=False,
                  ctx=ctx)
        res["train_loop_without_logical_raised"] = 0
    except ValueError:
        res["train_loop_without_logical_raised"] = 1


def train_moe_part(res):
    # Qwen3-MoE's smoke LM one step on a (2, 4) mesh, its experts held
    # split, against one process: the gradients AdamW receives (a spy on
    # the train step's adamw_update), its clipping norm, and the
    # parameters after the step, gathered whole.
    import dataclasses
    import repro_torch.train.loop as L
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import lm as LM
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.sharding.specs import NULL_CTX, held_logical, make_ctx

    cfg = get_arch("qwen3-moe-235b-a22b").SMOKE_CONFIG
    # no token dropped (each rank's capacity is of its own tokens) and no
    # aux term (each rank's is of its own tokens): the step's gradients
    # are then one process's, but for the EP wire's rounding
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0))
    mesh = make_mesh_compat((2, 4), ("data", "model"), device_type="cpu")
    ctx = make_ctx(mesh)
    params = LM.param_tree(LM.init_lm(cfg, seed=0, device="cpu"))
    logical = LM.lm_param_logical(cfg)
    shapes = L._tree_shapes(params)
    axes = ctx.held_axes(logical, params)
    held = ctx.held_blocks(logical, params)
    res["moe_lm_held_numel"] = sum(x.numel() for x in _leaves(held)[0])
    res["moe_lm_whole_numel"] = sum(x.numel() for x in _leaves(params)[0])
    split = _leaves(axes)[0]
    res["moe_train_split"] = np.asarray([bool(a) for a in split])
    log_leaves = []

    def walk(log):
        if isinstance(log, dict):
            for k in sorted(log):
                walk(log[k])
        else:
            log_leaves.append(log)

    walk(logical)
    rng = np.random.default_rng(5)
    tokens = t(rng.integers(0, cfg.vocab, (8, 17)).astype(np.int64))
    kw = dict(base_lr=1e-3, warmup=1, total_steps=10, donate=False)
    real = L.adamw_update

    def run(p, ctx_, axes_=None):
        seen = []

        def spy(pp, g, o, **k):
            seen.append(g)
            return real(pp, g, o, **k)

        L.adamw_update = spy
        try:
            new, _, m = L.make_train_step(
                lambda pp, b: LM.lm_loss(LM.lm_view(pp, cfg), b, ctx=ctx_),
                ctx=ctx_, held_axes=axes_, **kw)(
                p, adamw_init(p), {"tokens": tokens})
        finally:
            L.adamw_update = real
        return new, seen[0], float(m["grad_norm"])

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / max(float(torch.linalg.vector_norm(b)), 1e-30))

    ref, g_one, n_one = run(params, NULL_CTX)
    new, g_held, n_held = run(held, ctx, axes)
    res["moe_train_bf16_err_one"] = np.asarray([
        rel(gh, ctx.local_block(gr, held_logical(log)) if ax else gr)
        for gh, gr, ax, log in zip(_leaves(g_held)[0], _leaves(g_one)[0],
                                   split, log_leaves)])
    # the clipping norm is that of the whole gradient tree the ranks hold
    # parts of
    whole_g = ctx.gather_held(logical, g_held, shapes)
    res["moe_train_bf16_norms"] = np.asarray(
        [n_held, float(global_norm(whole_g)), n_one])
    gathered = ctx.gather_held(logical, new, shapes)
    res["moe_train_bf16_param_diff"] = max(
        float((a - b).abs().max()) for a, b in
        zip(_leaves(gathered)[0], _leaves(ref)[0]))


def main(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    res = {}
    search_part(res)
    moe_part(res)
    train_part(res)
    train_moe_part(res)
    dist.barrier()
    np.savez(f"{out}.{rank}.npz",
             **{k: (v.numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    init, out = sys.argv[1], sys.argv[2]
    mp.spawn(main, args=(%(world)d, init, out), nprocs=%(world)d)
    print("OK")
""" % {"world": WORLD}


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's npz, [the port's npz of each rank])."""
    d = tmp_path_factory.mktemp("torch_dist")
    (d / "jax_side.py").write_text(textwrap.dedent(JAX_SIDE))
    (d / "port_side.py").write_text(textwrap.dedent(PORT_SIDE))
    jax_out, port_out = str(d / "jax.npz"), str(d / "port")
    procs = [
        subprocess.Popen(
            [sys.executable, str(d / "jax_side.py"), jax_out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                     JAX_PLATFORMS="cpu")),
        subprocess.Popen(
            [sys.executable, str(d / "port_side.py"),
             f"file://{d / 'rendezvous'}", port_out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env()),
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    ranks = [dict(np.load(f"{port_out}.{r}.npz")) for r in range(WORLD)]
    return dict(np.load(jax_out)), ranks


def _same_up_to_ties(ids_a, s_a, ids_b, s_b, rtol=1e-5):
    """Ids equal wherever the two score rows hold no tie at that slot."""
    tie = np.zeros_like(ids_a, dtype=bool)
    for s in (s_a, s_b):
        srt = np.sort(s, axis=1)
        close = np.isclose(srt[:, 1:], srt[:, :-1], rtol=rtol, atol=0)
        near = np.zeros_like(s, dtype=bool)
        near[:, 1:] |= close
        near[:, :-1] |= close
        tie |= near
    return bool(((ids_a == ids_b) | tie).all()), int(tie.sum())


SEARCH_CASES = [(mesh, mode) for mesh in ("d8", "pd24")
                for mode in ("global", "local")]


@pytest.mark.parametrize("mesh,mode", SEARCH_CASES)
def test_sharded_search_equals_jax(runs, mesh, mode):
    ref, ranks = runs
    key = f"{mesh}_{mode}"
    for res in ranks:          # the result is replicated on every rank
        s, i = res[f"{key}_s"], res[f"{key}_i"]
        ok, _ = _same_up_to_ties(i, s, ref[f"{key}_i"], ref[f"{key}_s"])
        assert ok, (mesh, mode)
        np.testing.assert_allclose(s, ref[f"{key}_s"], rtol=1e-5, atol=1e-6)
        assert i.dtype == np.int32
    # one merge (one gather of scores and ids) a stage in 'global', one in
    # 'local'
    n_merges = 4 if mode == "global" else 1
    assert int(ranks[0][f"{key}_gathers"]) == n_merges


@pytest.mark.parametrize("mesh", ["d8", "pd24"])
def test_sharded_search_passes_the_reference_checks(runs, mesh):
    """``tests/test_distributed.py``'s own assertions, on the port: global
    top-1 agrees with one device in > 97% of queries; local accuracy is
    no lower."""
    _, ranks = runs
    res = ranks[0]
    _, _, gt = _search_gt()
    agree = (res[f"{mesh}_global_i"][:, 0] == res["single_i"][:, 0]).mean()
    assert agree > 0.97
    acc_l = (res[f"{mesh}_local_i"][:, 0] == gt).mean()
    acc_s = (res["single_i"][:, 0] == gt).mean()
    assert acc_l >= acc_s - 1e-9


def _search_gt():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(4096, 128)).astype(np.float32)
    gt = rng.choice(4096, 32, replace=False)
    return db, None, gt


def test_pod_data_offsets_follow_axis_index(runs):
    """On the (pod, data) mesh rank (p, d) holds rows from (4p + d) · 512,
    JAX's ``axis_index(('pod', 'data'))`` order."""
    _, ranks = runs
    assert sorted(int(r["offset_pd24"]) for r in ranks) == \
        [512 * i for i in range(8)]
    for rank, res in enumerate(ranks):
        assert int(res["offset_pd24"]) == 512 * rank


@pytest.mark.parametrize("mode", ["global", "local"])
def test_sentinels_identical(runs, mode):
    """8 rows, final k 16: half of every row is (+inf, -1) in both."""
    ref, ranks = runs
    s, i = ranks[0][f"tiny_{mode}_s"], ranks[0][f"tiny_{mode}_i"]
    rs, ri = ref[f"tiny_{mode}_s"], ref[f"tiny_{mode}_i"]
    assert np.array_equal(np.isinf(s), np.isinf(rs))
    assert np.array_equal(i == -1, ri == -1)
    assert (i == -1).sum() == 4 * 8
    assert np.all(np.isinf(s[i == -1]))
    fin = np.isfinite(s)
    np.testing.assert_allclose(s[fin], rs[fin], rtol=1e-5, atol=1e-6)
    assert np.array_equal(np.sort(i, 1), np.sort(ri, 1))


def test_uneven_corpus_raises(runs):
    _, ranks = runs
    assert all(int(r["uneven_raised"]) == 1 for r in ranks)


def _assemble(ranks, key):
    """The (4, 16, D) batch from the ranks' blocks: data rank d holds rows
    [2d, 2d + 2); every model rank holds the same block."""
    blocks = {}
    for res in ranks:
        d, m = (int(v) for v in res["coord"])
        blocks.setdefault(d, []).append(res[key])
    for d, bs in blocks.items():
        for b in bs[1:]:
            np.testing.assert_array_equal(b, bs[0])
    return np.concatenate([blocks[d][0] for d in sorted(blocks)])


# The port's EP output against the JAX package's: both round the exchanged
# buffers to bf16 at the same points, but their float32 products may round
# a value to the neighbouring bf16, so a slot may differ by one bf16 step
# (2^-8 relative) of its expert output.
MOE_EP_TOL = 2e-2


def test_moe_ep_equals_jax_ep(runs):
    ref, ranks = runs
    y = _assemble(ranks, "ep_y")
    scale = np.abs(ref["moe_ep_y"]).max()
    assert np.abs(y - ref["moe_ep_y"]).max() <= MOE_EP_TOL * scale
    for res in ranks:
        np.testing.assert_allclose(res["ep_aux"], ref["moe_ep_aux"],
                                   rtol=1e-6, atol=1e-9)
    assert int(ranks[0]["ep_all_to_all"]) == 2


def test_moe_ep_within_reference_bound_of_one_device(runs):
    """``tests/test_distributed.py``'s bound, 0.05, against one device
    (the port's and the JAX package's)."""
    ref, ranks = runs
    y = _assemble(ranks, "ep_y")
    assert np.abs(y - ranks[0]["single_y"]).max() < 0.05
    assert np.abs(y - ref["moe_single_y"]).max() < 0.05
    np.testing.assert_allclose(ranks[0]["single_y"], ref["moe_single_y"],
                               rtol=1e-5, atol=1e-5)


MOE_LEAVES = ["router", "w_in", "w_out", "w_gate", "shared.w_in",
              "shared.w_out", "shared.w_gate"]


EXPERT_LEAVES = ("w_in", "w_out", "w_gate")


@pytest.mark.parametrize("leaf", MOE_LEAVES)
def test_moe_ep_gradients_are_single_device(runs, leaf):
    """The ranks' gradients reduced by placement, times the 2 data ranks
    (each rank's loss sums its own rows), are the one-device gradient of
    the whole batch's loss — not ep (4) times it — within the bf16 wire's
    rounding: of the whole weight for a replicated leaf (the same on every
    rank), of the rank's slice for an expert leaf (the same on the ranks
    of one ``model`` coordinate)."""
    _, ranks = runs
    per = 8 // 4
    for res in ranks:
        m = int(res["coord"][1])
        same = [r for r in ranks if leaf not in EXPERT_LEAVES
                or int(r["coord"][1]) == m]
        for other in same:
            np.testing.assert_array_equal(res[f"ep_meangrad_{leaf}"],
                                          other[f"ep_meangrad_{leaf}"])
        g = 2 * res[f"ep_meangrad_{leaf}"]
        want = res[f"single_grad_{leaf}"]
        if leaf in EXPERT_LEAVES:
            want = want[m * per:(m + 1) * per]
        assert g.shape == want.shape
        err = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
        assert err < 1e-2, (leaf, err)


def test_moe_ep_fold_is_real_and_undone(runs):
    """Before the reduction, the owner of an expert holds ep copies'
    gradient: summed over the data ranks it is ep (4) times the one-device
    gradient of its slice, and no rank holds a gradient of another's
    experts."""
    _, ranks = runs
    want = ranks[0]["single_grad_w_in"]
    per = 8 // 4
    for m in range(4):
        owned = slice(m * per, (m + 1) * per)
        tot = sum(r["ep_raw_w_in"] for r in ranks if int(r["coord"][1]) == m)
        assert tot.shape == want[owned].shape
        err = (np.linalg.norm(tot - 4 * want[owned])
               / np.linalg.norm(4 * want[owned]))
        assert err < 1e-2, (m, err)


def test_moe_ep_input_gradients(runs):
    _, ranks = runs
    gx = _assemble(ranks, "ep_grad_x")
    want = ranks[0]["single_grad_x"]
    err = np.linalg.norm(gx - want) / np.linalg.norm(want)
    assert err < 1e-2, err


def test_train_step_on_mesh_equals_one_process(runs):
    """Mistral-Nemo's smoke LM, one step on a (4, 2) world, 2 rows of the
    batch a data rank: every rank's parameters within 1e-5 of the
    one-process step's, after one data-parallel all-reduce."""
    _, ranks = runs
    for res in ranks:
        assert float(res["train_max_diff"]) <= 1e-5
        assert float(res["train_moved"]) > 1e-4
        assert int(res["train_all_reduce"]) >= 1
        gn = res["train_grad_norm"]
        np.testing.assert_allclose(gn[0], gn[1], rtol=1e-4)


def test_train_loop_on_a_mesh_needs_the_logical_tree(runs):
    """``TrainLoop`` places the parameters by their logical axes on a mesh:
    without them it refuses to start."""
    _, ranks = runs
    for res in ranks:
        assert int(res["train_loop_without_logical_raised"]) == 1


def test_train_step_shardings_round_trip(runs):
    """``tree_shardings(lm_param_logical(cfg), params)``: each leaf cut to
    this rank's block (``local_block``) and joined by DTensor under its
    placements gives the leaf back; the moments take the parameters'
    placements and the step is replicated."""
    _, ranks = runs
    for res in ranks:
        assert res["placements_round_trip"].all()
        assert res["opt_step_placement"].all()
        assert int(res["mu_equals_param_placements"]) == 1


def test_moe_each_rank_holds_one_ep_th_of_the_experts(runs):
    _, ranks = runs
    for res in ranks:
        assert res["held_axes_ok"].all()
        assert int(res["held_expert_bytes"]) * 4 == \
            int(res["whole_expert_bytes"])


def test_moe_decode_under_the_ctx_equals_one_device(runs):
    _, ranks = runs
    for res in ranks:
        assert int(res["decode_equal"]) == 1
        assert int(res["decode_gathers"]) == 3          # w_in, w_gate, w_out
        assert int(res["slice_without_ctx_raised"]) == 1
        # the EP path takes only the rank's slice
        assert int(res["whole_on_mesh_raised"]) == 1


def test_moe_train_step_with_held_experts_equals_one_process(runs):
    """Qwen3-MoE smoke (capacity 8, no aux term: nothing that depends on a
    rank's share of the tokens), one step on (2, 4) with the experts held
    split (one ep-th of the MoE layers' numbers on each rank).  The
    clipping norm equals, to float32 sums, the norm of the whole gradient
    tree gathered from the ranks' parts.  Every gradient AdamW receives,
    each expert leaf its slice, is within 1e-1 of one process's (the bf16
    exchange rounds each layer's expert inputs and outputs, forward and
    backward, and the errors of two layers compound: 5.8e-2 at most, on an
    expert slice), the norm within 1e-2, and the parameters after the
    step, gathered whole, within twice the learning rate (AdamW's first
    step moves a weight by about lr times the sign of its gradient)."""
    _, ranks = runs
    for res in ranks:
        assert res["moe_train_split"].sum() == 3   # w_in, w_gate, w_out
        assert int(res["moe_lm_held_numel"]) < int(res["moe_lm_whole_numel"])
        assert res["moe_train_bf16_err_one"].max() < 1e-1
        held, gathered, one = res["moe_train_bf16_norms"]
        np.testing.assert_allclose(held, gathered, rtol=1e-5)
        np.testing.assert_allclose(held, one, rtol=1e-2)
        assert float(res["moe_train_bf16_param_diff"]) <= 2e-3
