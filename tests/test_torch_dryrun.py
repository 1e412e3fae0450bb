"""The port's dry run on the meta device against the JAX package's.

Two subprocesses at once: the JAX package's ``build_cell`` on 256 host
devices (``--xla_force_host_platform_device_count=256``; ``eval_shape``
only, nothing lowered or compiled), and the port's
(`repro_torch.launch.inputs`, `repro_torch.launch.dryrun`) as rank 0 of a
256-rank ``fake`` process group (a process group of its own, so no test
worker holds one).  For four cells on the 16 x 16 mesh — Mistral-Nemo
``train_4k``, Qwen3-MoE ``decode_32k``, the two-tower ``retrieval_cand``
and EGNN ``full_graph_sm`` — every argument leaf's path, shape, dtype and
block in the rules' layout equals the JAX package's ``input_specs`` and
``NamedSharding.shard_shape``; the per-rank argument bytes are the sums of
their leaves; the smoke LM's FLOPs equal the closed-form count of its
matmuls; the production meshes have the JAX package's shapes and names;
and the command line writes its JSON.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")

CELLS = [("mistral-nemo-12b", "train_4k"), ("qwen3-moe-235b-a22b",
                                             "decode_32k"),
         ("two-tower-retrieval", "retrieval_cand"), ("egnn", "full_graph_sm")]

JAX_SIDE = """
import json, sys
import jax
from repro.launch.inputs import build_cell
from repro.launch.mesh import make_production_mesh

mesh = make_production_mesh()
out = {"mesh": [list(mesh.devices.shape), list(mesh.axis_names)]}
for arch, shape in %(cells)r:
    cell = build_cell(arch, shape, mesh)
    leaves = []
    for i, (arg, shard) in enumerate(zip(cell.args, cell.in_shardings)):
        flat = jax.tree_util.tree_flatten_with_path(arg)[0]
        shards = ([None] * len(flat) if shard is None
                  else jax.tree.leaves(shard))
        assert len(shards) == len(flat)
        for (path, x), sh in zip(flat, shards):
            block = x.shape if sh is None else sh.shard_shape(x.shape)
            leaves.append({"path": f"[{i}]" + jax.tree_util.keystr(path),
                           "shape": list(x.shape), "dtype": str(x.dtype),
                           "block": list(block),
                           "itemsize": x.dtype.itemsize})
    out[f"{arch}__{shape}"] = leaves
json.dump(out, open(sys.argv[1], "w"))
print("OK")
""" % {"cells": CELLS}

PORT_SIDE = """
import json, sys
import torch
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.costs import exact_lm_costs
from repro_torch.launch.inputs import build_cell
from repro_torch.launch.mesh import make_production_mesh

out = {}
dryrun.init_fake_world(512)
m = make_production_mesh(multi_pod=True, device_type="cpu")
out["multi"] = [list(m.shape), list(m.mesh_dim_names)]
dryrun.init_fake_world(256)
m = make_production_mesh(device_type="cpu")
out["single"] = [list(m.shape), list(m.mesh_dim_names)]
for arch, shape in %(cells)r:
    rec = dryrun.run_cell(arch, shape, "single")
    cell = build_cell(arch, shape, m)
    rec["local_leaf_bytes"] = [t.numel() * t.element_size()
                               for t in dryrun._tensors(cell.local_args)]
    out[f"{arch}__{shape}"] = rec
cfg = get_arch("mistral-nemo-12b").SMOKE_CONFIG
out["smoke_flops"] = {}
for kind in ("train", "prefill", "decode"):
    sh = ShapeSpec(name="smoke", kind=kind, seq_len=64, global_batch=32)
    out["smoke_flops"][kind] = exact_lm_costs("mistral-nemo-12b", "train_4k",
                                              cfg=cfg, shape=sh)
json.dump(out, open(sys.argv[1], "w"), default=float)
print("OK")
""" % {"cells": CELLS}


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dryrun")
    (d / "jax_side.py").write_text(textwrap.dedent(JAX_SIDE))
    (d / "port_side.py").write_text(textwrap.dedent(PORT_SIDE))
    jax_out, port_out = str(d / "jax.json"), str(d / "port.json")
    procs = [
        subprocess.Popen(
            [sys.executable, str(d / "jax_side.py"), jax_out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=256",
                     JAX_PLATFORMS="cpu")),
        subprocess.Popen(
            [sys.executable, str(d / "port_side.py"), port_out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env()),
        subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "two-tower-retrieval", "--shape", "retrieval_cand", "--mesh",
             "multi", "--outdir", str(d / "out"), "--quiet"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env()),
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return (json.load(open(jax_out)), json.load(open(port_out)),
            d / "out")


def test_production_meshes(runs):
    ref, port, _ = runs
    assert port["single"] == [[16, 16], ["data", "model"]] == ref["mesh"]
    assert port["multi"] == [[2, 16, 16], ["pod", "data", "model"]]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_leaves_and_blocks_equal_the_jax_package(runs, arch, shape):
    """Every argument leaf: path, whole shape, dtype, and its block on one
    rank in the rules' layout."""
    ref, port, _ = runs
    key = f"{arch}__{shape}"
    mine = port[key]["leaves"]
    theirs = ref[key]
    assert [x["path"] for x in mine] == [x["path"] for x in theirs]
    for a, b in zip(mine, theirs):
        assert a["shape"] == b["shape"], a["path"]
        assert a["dtype"] == b["dtype"], a["path"]
        assert a["block"] == b["block"], a["path"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_per_rank_bytes_are_the_sums_of_the_leaves(runs, arch, shape):
    ref, port, _ = runs
    rec = port[f"{arch}__{shape}"]
    rules = sum(int(np.prod(x["block"], dtype=np.int64)) * x["itemsize"]
                for x in ref[f"{arch}__{shape}"])
    assert rec["arg_bytes_rules"] == rules
    assert rec["arg_bytes_port"] == sum(rec["local_leaf_bytes"])
    assert rec["status"] == "ok" and rec["n_ranks"] == 256
    # the port holds more than the rules' layout, never less
    assert rec["arg_bytes_port"] >= rec["arg_bytes_rules"]
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")


def test_the_moe_cell_counts_its_expert_gathers(runs):
    """Qwen3-MoE decode holds E/16 experts a rank and gathers them whole a
    layer (3 all-gathers of 94 layers); the dense train cell's one
    collective is the gradient all-reduce."""
    _, port, _ = runs
    dec = port["qwen3-moe-235b-a22b__decode_32k"]
    assert dec["collective_counts"]["all-gather"] == 3 * 94
    tr = port["mistral-nemo-12b__train_4k"]
    assert tr["collective_counts"] == {"all-gather": 0, "all-reduce": 1,
                                       "all-to-all": 0}


def test_smoke_lm_flops_are_the_closed_form(runs):
    """Mistral-Nemo's smoke LM (2 layers, d 128, 8 heads of 16, 2 kv
    heads, swiglu d_ff 256, vocab 512), 2 rows of 64 tokens a rank:
    projections 2·T·(D·H·dh + 2·D·Hkv·dh + H·dh·D + 3·D·F), attention
    A = 2·B·H·S·S·dh a product; a train step is 3 times each projection,
    the head and 7 A a layer (2 forward, 5 in the plain backward, which
    recomputes the scores); prefill the forward with the last token's head;
    decode one token against 64 cached."""
    _, port, _ = runs
    B, S, D, H, Hkv, dh, F, V, L = 2, 64, 128, 8, 2, 16, 256, 512, 2

    def proj(t):
        return 2 * t * (D * H * dh + 2 * D * Hkv * dh + H * dh * D
                        + 3 * D * F)

    A = 2 * B * H * S * S * dh
    want = {
        "train": L * (3 * proj(B * S) + 7 * A) + 3 * 2 * B * S * D * V,
        "prefill": L * (proj(B * S) + 2 * A) + 2 * B * D * V,
        "decode": L * (proj(B) + 2 * 2 * B * H * S * dh) + 2 * B * D * V,
    }
    for kind, flops in want.items():
        rec = port["smoke_flops"][kind]
        assert rec["flops"] == flops, kind
        assert rec["rows"] == B
        assert rec["hbm_bytes"] > 0


def test_command_line_writes_the_cell(runs):
    _, _, out = runs
    rec = json.load(open(out / "two-tower-retrieval__retrieval_cand__multi"
                                ".json"))
    assert rec["status"] == "ok" and rec["n_ranks"] == 512
    assert rec["meta"]["staged_index"] is True
    # 1M rows over the (pod, data) ranks: 31,250 rows of the bf16 block,
    # the float32 DB and the norms on each
    assert rec["arg_bytes_rules"] <= rec["arg_bytes_port"]
    assert rec["collective_counts"]["all-gather"] == 1
