"""The staged bf16 sharded search of the PyTorch port against the JAX
package's.

* Stage 0 on bf16 rows: the port's ``l2_topk`` (its plain version on the
  CPU, which the card's bf16 routes are held to) against the JAX package's
  Pallas ``l2_topk`` in interpret mode and its ``truncated_search``, on the
  same bf16 values: ``valid`` holes, k above the live rows, exact ties,
  dims 8 / 64 / 128.  Every product of two bf16 values is exact in
  float32, so the two differ only in the order of their float32 sums: a
  score is held within ``1e-5 · (||x||² + 2 Σ|q_i x_i|)`` of the other's,
  and ids are equal except where the scores tie within that bound.
* ``build_sharded_search_staged`` on 8 ``gloo`` ranks against the JAX
  package's on 8 host devices (a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on a ``data``
  and a ``('pod', 'data')`` mesh; ``tests/test_distributed.py``'s own
  check (top-1 agreement with the float32 sharded search above 0.95); a
  corpus of one row a shard, whose results hold sentinels; an uneven N.
* The two-tower ``retrieval_cand`` function (``launch/inputs.py``) at the
  smoke width, with the same weights in both packages, against the JAX
  package's cell function.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp

from repro.core import truncated as JT
from repro.kernels.distance_topk import l2_topk as pallas_l2_topk

from repro_torch.kernels import distance_topk, ops

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 8
REL = 1e-5


def _bf16_pair(rng, nq, n, d):
    """The same bf16 values as torch tensors and jax arrays."""
    q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32))
    db = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    q, db = q.to(torch.bfloat16), db.to(torch.bfloat16)
    return (q, db, jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(db.float().numpy()).astype(jnp.bfloat16))


def _bound(q, db, dim, sq):
    """(Q, N) tolerance of a score: 1e-5 · (||x||² + 2 Σ|q_i x_i|)."""
    qa = q[:, :dim].double().abs().numpy()
    xa = db[:, :dim].double().abs().numpy()
    return REL * (np.abs(np.asarray(sq, np.float64))[None, :]
                  + 2.0 * qa @ xa.T)


def assert_close_up_to_ties(got, want, bound):
    """Sentinels identical, scores within the bound of the wanted id, ids
    equal except where the two scores tie within that bound."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    assert gs.shape == ws.shape and gi.shape == wi.shape
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    np.testing.assert_array_equal(gi == -1, wi == -1)
    fin = np.isfinite(ws)
    rows = np.broadcast_to(np.arange(ws.shape[0])[:, None], ws.shape)
    tol = np.where(fin, bound[rows, np.where(fin, wi, 0)], 0.0)
    gap = np.abs(np.where(fin, gs, 0.0) - np.where(fin, ws, 0.0))
    assert (gap <= tol).all()
    differ = (gi != wi) & fin
    assert (gap[differ] <= tol[differ]).all(), \
        "ids differ where the scores do not tie"


class TestBf16StageZero:
    @pytest.mark.parametrize("dim", [8, 64, 128])
    @pytest.mark.parametrize("nq,n,k", [(8, 300, 16), (5, 130, 64)])
    def test_equals_pallas_and_truncated_search(self, dim, nq, n, k):
        rng = np.random.default_rng(dim * 100 + n)
        q, db, jq, jdb = _bf16_pair(rng, nq, n, 128)
        sq = (db[:, :dim].float() ** 2).sum(1)
        got = distance_topk.l2_topk(q, db, dim=dim, k=k)
        assert ops.truncated_search(q, db, dim=dim, k=k)[1].equal(got[1])
        bound = _bound(q, db, dim, sq.numpy())
        pallas = pallas_l2_topk(jq[:, :dim], jdb[:, :dim], k=k, block_q=8,
                                block_n=64, interpret=True)
        assert_close_up_to_ties(got, pallas, bound)
        trunc = JT.truncated_search(jq, jdb, dim=dim, k=k, block_n=64)
        assert_close_up_to_ties(got, trunc, bound)
        # precomputed norms: the same scores to the bound
        with_sq = distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=sq)
        assert_close_up_to_ties(with_sq, trunc, bound)

    @pytest.mark.parametrize("dim", [8, 64, 128])
    def test_valid_holes_and_k_above_the_live_rows(self, dim):
        rng = np.random.default_rng(dim)
        q, db, jq, jdb = _bf16_pair(rng, 6, 200, 128)
        valid = rng.random(200) < 0.1
        live = int(valid.sum())
        k = 64
        assert live < k
        sq = (db[:, :dim].float() ** 2).sum(1)
        got = distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=sq,
                                    valid=torch.from_numpy(valid))
        bound = _bound(q, db, dim, sq.numpy())
        trunc = JT.truncated_search(jq, jdb, dim=dim, k=k,
                                    db_sq_at_dim=jnp.asarray(sq.numpy()),
                                    valid=jnp.asarray(valid), block_n=64)
        assert_close_up_to_ties(got, trunc, bound)
        # the Pallas kernel has no mask: invalid rows get +inf norms
        masked = np.where(valid, sq.numpy(), np.inf).astype(np.float32)
        pallas = pallas_l2_topk(jq[:, :dim], jdb[:, :dim], k=k, block_q=8,
                                block_n=64, db_sq=jnp.asarray(masked),
                                interpret=True)
        assert_close_up_to_ties(got, pallas, bound)
        s, i = (np.asarray(x) for x in got)
        assert (i[:, live:] == -1).all() and np.isinf(s[:, live:]).all()
        assert valid[i[:, :live]].all()

    @pytest.mark.parametrize("dim", [8, 64, 128])
    def test_exact_ties_keep_the_lower_id(self, dim):
        """Row r + 100 repeats row r: equal scores, the lower id first, in
        both packages."""
        rng = np.random.default_rng(dim + 1)
        q, db, _, _ = _bf16_pair(rng, 4, 100, 128)
        db = torch.cat([db, db])
        jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
        jdb = jnp.asarray(db.float().numpy()).astype(jnp.bfloat16)
        s, i = distance_topk.l2_topk(q, db, dim=dim, k=32)
        assert (i[:, 0::2] + 100 == i[:, 1::2]).all()
        assert torch.equal(s[:, 0::2], s[:, 1::2])
        ts, ti = JT.truncated_search(jq, jdb, dim=dim, k=32, block_n=64)
        np.testing.assert_array_equal(np.asarray(ti)[:, 1::2] - 100,
                                      np.asarray(ti)[:, 0::2])
        sq = (db[:, :dim].float() ** 2).sum(1).numpy()
        assert_close_up_to_ties((s, i), (ts, ti), _bound(q, db, dim, sq))

    def test_mixed_dtypes_take_the_widened_product(self):
        """A float32 query against bf16 rows is scored as the JAX package
        scores it: both operands widened, exact products."""
        rng = np.random.default_rng(7)
        q, db, jq, jdb = _bf16_pair(rng, 3, 50, 16)
        s, _ = distance_topk.l2_topk(q.float(), db, dim=16, k=5)
        ts, _ = JT.truncated_search(jq.astype(jnp.float32), jdb, dim=16, k=5)
        np.testing.assert_allclose(s.numpy(), np.asarray(ts), rtol=1e-5,
                                   atol=1e-5)


INPUTS = """
import numpy as np

N, D, Q = 4096, 128, 32

def spectrum_inputs(seed=0):
    rng = np.random.default_rng(seed)
    scales = (1 + np.arange(D)) ** -0.3
    db = (rng.normal(size=(N, D)) * scales).astype(np.float32)
    gt = rng.choice(N, Q, replace=False)
    q = (db[gt] + 0.2 * scales
         * rng.normal(size=(Q, D)).astype(np.float32)).astype(np.float32)
    return db, q, gt

def staged_block(db, ds):
    # float32; each package casts it to bf16 (round to nearest even in
    # both, so the two blocks hold the same values)
    return np.ascontiguousarray(db[:, :ds])

def prefix_sq(db, ds):
    return (db[:, :ds] ** 2).sum(1, keepdims=True).astype(np.float32)

C_SMOKE = 4096

def tower_inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    nf = max(cfg.n_sparse // 2, 1)
    d = cfg.embed_dim
    def mlp(dims):
        return [{"w": (rng.normal(size=(a, b)) * a ** -0.5).astype(np.float32),
                 "b": (0.1 * rng.normal(size=(b,))).astype(np.float32)}
                for a, b in zip(dims, dims[1:])]
    def tables():
        return (0.1 * rng.normal(size=(nf, cfg.vocab_per_field, d))
                ).astype(np.float32)
    p = {"user_tables": tables(), "item_tables": tables(),
         "user_mlp": mlp((nf * d,) + cfg.tower_mlp),
         "item_mlp": mlp((nf * d,) + cfg.tower_mlp)}
    uids = rng.integers(0, cfg.vocab_per_field,
                        (8, nf, cfg.multi_hot)).astype(np.int32)
    emb = rng.normal(size=(C_SMOKE, cfg.tower_mlp[-1])).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return p, uids, emb
"""

JAX_SIDE = INPUTS + """
import sys
import jax, jax.numpy as jnp
from repro.configs import get_arch
from repro.core import make_schedule
from repro.core.distributed import (build_sharded_search_staged,
                                    sharded_progressive_search)
from repro.launch.mesh import make_mesh_compat
from repro.models import recsys as RS
from repro.sharding.specs import make_ctx

out = {}
db, q, gt = spectrum_inputs()
sched = make_schedule(32, 128, 32)
db0 = jnp.asarray(staged_block(db, 32)).astype(jnp.bfloat16)
sqp = jnp.asarray(prefix_sq(db, 32))
mesh8 = make_mesh_compat((8,), ("data",))
mesh24 = make_mesh_compat((2, 4), ("pod", "data"))
for name, mesh, axes in (("d8", mesh8, ("data",)),
                         ("pd24", mesh24, ("pod", "data"))):
    fn = build_sharded_search_staged(mesh, sched, N, db_axes=axes)
    s, c = jax.jit(fn)(jnp.asarray(q), db0, jnp.asarray(db), sqp)
    out[f"{name}_s"], out[f"{name}_i"] = s, c

tdb, tq, _ = spectrum_inputs(seed=2)
tdb, tq = tdb[:8], tq[:4]
tsched = make_schedule(16, 128, 16, final_k=16)
fn = build_sharded_search_staged(mesh8, tsched, 8)
s, c = jax.jit(fn)(jnp.asarray(tq),
                   jnp.asarray(staged_block(tdb, 16)).astype(jnp.bfloat16),
                   jnp.asarray(tdb), jnp.asarray(prefix_sq(tdb, 16)))
out["tiny_s"], out["tiny_i"] = s, c

cfg = get_arch("two-tower-retrieval").SMOKE_CONFIG
p, uids, emb = tower_inputs(cfg)
pj = jax.tree.map(jnp.asarray, p)
ctx = make_ctx(mesh8)
tt_sched = make_schedule(cfg.retrieval_d_start, cfg.tower_mlp[-1],
                         cfg.retrieval_k0)
search = build_sharded_search_staged(mesh8, tt_sched, C_SMOKE)
ds = tt_sched.stages[0].dim

def cell_fn(p, uids, db0, db, sqp):
    qq = RS.tower_user(p, uids, ctx).astype(jnp.float32)
    return search(qq, db0, db, sqp)

s, c = jax.jit(cell_fn)(pj, jnp.asarray(uids),
                        jnp.asarray(staged_block(emb, ds)).astype(jnp.bfloat16),
                        jnp.asarray(emb), jnp.asarray(prefix_sq(emb, ds)))
out["tt_s"], out["tt_i"] = s, c
out["tt_q"] = RS.tower_user(pj, jnp.asarray(uids))
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


def main(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.configs import get_arch
    from repro_torch.core import make_schedule
    from repro_torch.core.distributed import (build_sharded_search_staged,
                                              sharded_progressive_search)
    from repro_torch.kernels import distance_topk
    from repro_torch.launch.inputs import two_tower_retrieval
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import recsys as RS
    from repro_torch.sharding import collectives as C

    res = {}
    db, q, gt = spectrum_inputs()
    sched = make_schedule(32, 128, 32)
    db0 = t(staged_block(db, 32)).to(torch.bfloat16)
    sqp = t(prefix_sq(db, 32))
    mesh8 = make_mesh_compat((8,), ("data",), device_type="cpu")
    mesh24 = make_mesh_compat((2, 4), ("pod", "data"), device_type="cpu")
    for name, mesh, axes in (("d8", mesh8, ("data",)),
                             ("pd24", mesh24, ("pod", "data"))):
        fn = build_sharded_search_staged(mesh, sched, N, db_axes=axes)
        lo = C.axis_index(mesh, axes) * (N // 8)
        sl = slice(lo, lo + N // 8)
        before = C.calls["all_gather"]
        s, c = fn(t(q), db0[sl], t(db)[sl], sqp[sl])
        res[f"{name}_gathers"] = C.calls["all_gather"] - before
        res[f"{name}_s"], res[f"{name}_i"] = s, c
        s2, c2 = sharded_progressive_search(mesh, t(q), t(db), sched,
                                            db_axes=axes, block_n=512)
        res[f"{name}_f32_i"] = c2

    tdb, tq, _ = spectrum_inputs(seed=2)
    tdb, tq = tdb[:8], tq[:4]
    tsched = make_schedule(16, 128, 16, final_k=16)
    fn = build_sharded_search_staged(mesh8, tsched, 8)
    r = slice(rank, rank + 1)
    s, c = fn(t(tq), t(staged_block(tdb, 16)).to(torch.bfloat16)[r],
              t(tdb)[r], t(prefix_sq(tdb, 16))[r])
    res["tiny_s"], res["tiny_i"] = s, c
    try:
        build_sharded_search_staged(mesh8, sched, N - 1)
        res["uneven_raised"] = 0
    except ValueError:
        res["uneven_raised"] = 1
    try:
        fn = build_sharded_search_staged(mesh8, sched, N)
        fn(t(q), db0[:100], t(db)[:100], sqp[:100])
        res["wrong_slab_raised"] = 0
    except ValueError:
        res["wrong_slab_raised"] = 1

    cfg = get_arch("two-tower-retrieval").SMOKE_CONFIG
    p, uids, emb = tower_inputs(cfg)
    params = RS.load_jax_params(p, cfg, device="cpu")
    fn, tt_sched = two_tower_retrieval(cfg, mesh8, C_SMOKE)
    ds = tt_sched.stages[0].dim
    lo = rank * (C_SMOKE // 8)
    sl = slice(lo, lo + C_SMOKE // 8)
    s, c = fn(params, t(uids), t(staged_block(emb, ds)).to(torch.bfloat16)[sl],
              t(emb)[sl], t(prefix_sq(emb, ds))[sl])
    res["tt_s"], res["tt_i"] = s, c
    res["tt_q"] = RS.tower_user(params, t(uids))
    dist.barrier()
    np.savez(f"{out}.{rank}.npz",
             **{k: (v.float().numpy() if isinstance(v, torch.Tensor)
                    and v.is_floating_point() else
                    v.numpy() if isinstance(v, torch.Tensor)
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
    d = tmp_path_factory.mktemp("torch_staged")
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


def _spectrum_bound(ids):
    """The bound of the search's final scores (float32 rows at 128 dims,
    float32 queries) at the wanted ids."""
    rng = np.random.default_rng(0)
    scales = (1 + np.arange(128)) ** -0.3
    db = (rng.normal(size=(4096, 128)) * scales).astype(np.float32)
    gt = rng.choice(4096, 32, replace=False)
    q = (db[gt] + 0.2 * scales
         * rng.normal(size=(32, 128)).astype(np.float32)).astype(np.float32)
    full = REL * ((db.astype(np.float64) ** 2).sum(1)[None, :]
                  + 2.0 * np.abs(q).astype(np.float64) @ np.abs(db).T)
    return full, gt


@pytest.mark.parametrize("mesh", ["d8", "pd24"])
def test_staged_search_equals_jax(runs, mesh):
    ref, ranks = runs
    bound, _ = _spectrum_bound(None)
    for res in ranks:                 # the result is the same on every rank
        assert_close_up_to_ties((res[f"{mesh}_s"], res[f"{mesh}_i"]),
                                (ref[f"{mesh}_s"], ref[f"{mesh}_i"]), bound)
        np.testing.assert_array_equal(res[f"{mesh}_i"], ranks[0][f"{mesh}_i"])
    # stage 0, the ladder, then one merge: one gather
    assert int(ranks[0][f"{mesh}_gathers"]) == 1


@pytest.mark.parametrize("mesh", ["d8", "pd24"])
def test_staged_passes_the_reference_check(runs, mesh):
    """``tests/test_distributed.py::test_staged_search_matches_regular``:
    top-1 agreement with the float32 sharded search above 0.95."""
    _, ranks = runs
    res = ranks[0]
    agree = (res[f"{mesh}_i"][:, 0] == res[f"{mesh}_f32_i"][:, 0]).mean()
    assert agree > 0.95, agree


def test_one_row_a_shard_gives_the_same_sentinels(runs):
    """8 rows over 8 shards, k0 and final k 16: each shard's stage 0 holds
    one row and 15 (+inf, -1) slots; half of every result row is a
    sentinel, in both packages."""
    ref, ranks = runs
    s, i = ranks[0]["tiny_s"], ranks[0]["tiny_i"]
    rs, ri = ref["tiny_s"], ref["tiny_i"]
    np.testing.assert_array_equal(np.isinf(s), np.isinf(rs))
    np.testing.assert_array_equal(i == -1, ri == -1)
    assert (i == -1).sum() == 4 * 8
    np.testing.assert_array_equal(i, ri)
    fin = np.isfinite(s)
    np.testing.assert_allclose(s[fin], rs[fin], rtol=1e-5, atol=1e-5)


def test_uneven_corpus_and_wrong_slab_raise(runs):
    _, ranks = runs
    assert all(int(r["uneven_raised"]) == 1 for r in ranks)
    assert all(int(r["wrong_slab_raised"]) == 1 for r in ranks)


def test_two_tower_retrieval_cand_equals_jax(runs):
    """The two-tower cell's function at the smoke width, the same weights
    in both packages: the user tower's queries, then the staged search's
    scores and ids."""
    ref, ranks = runs
    np.testing.assert_allclose(ranks[0]["tt_q"], ref["tt_q"], rtol=1e-5,
                               atol=1e-6)
    for res in ranks:
        s, i = res["tt_s"], res["tt_i"]
        np.testing.assert_array_equal(np.isfinite(s), np.isfinite(ref["tt_s"]))
        np.testing.assert_allclose(s, ref["tt_s"], rtol=1e-5, atol=1e-5)
        differ = i != ref["tt_i"]
        assert np.allclose(s[differ], ref["tt_s"][differ], rtol=1e-5,
                           atol=1e-5)
        assert (i >= 0).all()
