"""Training launcher: the port of ``src/repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke --steps 100 --ckpt-dir /tmp/run1 [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch qwen3-moe-235b-a22b --smoke \\
        --steps 10 --ckpt-dir /tmp/run2 [--device cpu]

Resolves ``--arch`` through the registry (``get_arch`` / ``family_of``),
builds the family's synthetic data stream (the Markov-chain LM stream, a
fixed random graph, the planted recsys clicks), and drives the
fault-tolerant ``TrainLoop`` (restart-aware; async checkpoints in the JAX
package's format; an emergency checkpoint on interrupt).  ``--smoke``
selects the reduced config; ``--device cpu`` runs the kernels' plain
versions (the tests), ``cuda`` (the default) the CUDA kernels and their
backward kernels.

Under ``torch.distributed.run`` (``WORLD_SIZE`` > 1) every rank joins one
process group — ``nccl`` when each local rank has a card of its own,
``gloo`` when ranks share one (or on the CPU), printed on the first line —
builds the elastic (data, model) mesh of the live ranks
(``launch.mesh.make_elastic_mesh``), and trains data-parallel on it, the
MoE layers expert-parallel over ``model``, each rank holding only its
experts.  The checkpoint holds whole tensors, so a run restarted on fewer
ranks (or on one) resumes from what the larger world wrote: the elastic
rescale.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from repro_torch.configs import family_of, get_arch
from repro_torch.data.synth import lm_batch_stream, recsys_batch_stream
from repro_torch.layers.common import resolve_device
from repro_torch.models import egnn as EG
from repro_torch.models import lm as LM
from repro_torch.models import recsys as RS
from repro_torch.models.graph import random_graph
from repro_torch.sharding.specs import NULL_CTX, make_ctx
from repro_torch.train import TrainLoop


def join_world(device: torch.device):
    """Under ``torch.distributed.run``: join the process group and build
    the elastic mesh.  Returns (ctx, device of this rank); (NULL_CTX,
    device) for a world of one."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return NULL_CTX, device
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_elastic_mesh

    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend, note = "gloo", "CPU ranks"
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
        # initialised now, so the DeviceMesh keeps this card rather than
        # choosing LOCAL_RANK's, which ranks sharing a card do not have
        torch.cuda.init()
        if n_cards >= local_world:
            backend, note = "nccl", "a card for each local rank"
        else:
            note = f"{local_world} local ranks share {n_cards} card(s)"
    dist.init_process_group(backend)
    if dist.get_rank() == 0:
        print(f"[launch] process group: {backend}, world {world} ({note})",
              flush=True)
    mesh = make_elastic_mesh(device_type=device.type)
    if dist.get_rank() == 0:
        print(f"[launch] elastic mesh: "
              f"{dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))}",
              flush=True)
    return make_ctx(mesh), device


def build(arch: str, *, smoke: bool, batch: int, seq: int, device,
          ctx=NULL_CTX):
    """(loss_fn, init_fn, data iterator, cfg, the parameters' logical
    axes) of ``arch``'s family."""
    mod = get_arch(arch)
    cfg = mod.SMOKE_CONFIG if smoke else mod.CONFIG
    fam = family_of(arch)
    rng = np.random.default_rng(0)
    if fam == "lm":
        data = lm_batch_stream(rng, cfg.vocab, batch, seq)
        return (lambda p, b: LM.lm_loss(LM.lm_view(p, cfg), b, ctx=ctx),
                lambda: LM.param_tree(LM.init_lm(cfg, seed=0, device=device)),
                data, cfg, LM.lm_param_logical(cfg))
    if fam == "gnn":
        g = random_graph(rng, 256, 1024, cfg.d_feat_in or 16,
                         n_classes=cfg.n_classes, device=device)
        return (lambda p, b: EG.egnn_loss(p, b, cfg),
                lambda: EG.param_tree(EG.egnn_init(cfg, seed=0,
                                                   device=device)),
                itertools.repeat(g), cfg, EG.egnn_param_logical(cfg))
    data = recsys_batch_stream(rng, cfg.family, batch,
                               n_sparse=cfg.n_sparse or 6,
                               vocab=cfg.vocab_per_field,
                               n_dense=cfg.n_dense or 13,
                               seq_len=cfg.seq_len or 10)
    shapes = RS.param_tree(RS.recsys_init(cfg, device="meta"))
    return (lambda p, b: RS.recsys_loss(p, b, cfg),
            lambda: RS.param_tree(RS.recsys_init(cfg, seed=0, device=device)),
            data, cfg, RS.recsys_param_logical(cfg, shapes))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train one architecture of the registry on one device "
                    "or, under torch.distributed.run, multi-device on the "
                    "elastic mesh of its ranks.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true",
                    help="bf16 gradients before the data-parallel reduction "
                         "and the clipping")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the CUDA kernels, the default) or 'cpu' "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ctx, device = join_world(device)
    loss_fn, init_fn, data, cfg, logical = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        device=device, ctx=ctx)
    loop = TrainLoop(
        loss_fn, init_fn, data,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 5, 10),
        log_every=10, base_lr=args.lr, warmup=max(args.steps // 10, 5),
        total_steps=args.steps, accum_steps=args.accum,
        grad_dtype="bfloat16" if args.grad_compress else None, ctx=ctx,
        logical=logical)
    metrics = loop.run(args.steps)
    if loop.lead:
        print(f"[launch] done: {metrics}", flush=True)
    if ctx.mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
