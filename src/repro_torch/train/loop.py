"""Training loop: the train-step factory and the fault-tolerant driver —
the port of ``src/repro/train/loop.py``.

``make_train_step`` builds the (params, opt_state, batch) -> (params',
opt_state', metrics) step from any ``loss_fn(params, batch) -> (loss,
metrics)`` over a tree of tensors (`repro_torch.optim`'s trees), with
optional gradient accumulation over microbatches (float32 sums, each
divided by ``accum_steps``; the last microbatch's metrics) and optional
bf16 gradient compression.  The JAX package's ``jit`` has no counterpart
(PyTorch runs eagerly; ``jit=False`` existed for the dry run only).
``donate`` (the default, as the JAX package's donated buffers) updates the
parameters and moments in place.

On a mesh (``ctx`` from `repro_torch.sharding.make_ctx`) the step runs on
every rank of the process group, data-parallel: each rank takes its rows
of the global batch (the ``batch`` rule, ``(pod, data)``; a batch that
does not divide, or a graph, stays whole on every rank), and the
gradients are reduced by their placement before clipping and AdamW
(`collectives.reduce_gradients_`, one all-reduce a dtype and placement:
the JAX package's GSPMD reduction).  A whole parameter's gradient is
averaged over the world, so every rank applies the same update to its
copy; a parameter held split (``held_axes``: the MoE experts over
``model``, `ShardingCtx.held_blocks`) is averaged over the other axes and
divided by the ep fold of its expert-parallel gradient (see
``layers.moe.moe_apply_ep``), and the clipping norm sums its squares over
the ranks that hold the parts.  ``grad_dtype='bfloat16'`` casts the
gradients before that reduction.  Every other weight is whole on every
rank: the JAX package's rules also shard weights over ``data`` (FSDP) and
``model`` (tensor parallelism), which the port does not do yet.

``TrainLoop`` is the production driver:
  * restart-aware: restores the latest complete ``(params, OptState)``
    checkpoint on construction (`repro_torch.checkpoint`, the JAX
    package's format: either package resumes the other's run),
  * async checkpoints every ``ckpt_every`` steps, and an emergency
    checkpoint on ``KeyboardInterrupt``,
  * host-side prefetch of the next batch on a thread; each batch goes to
    the parameters' device once per step,
  * step-time telemetry (p50 / p95 over the last 512 steps) and a
    ``history`` of the logged metrics; the step's end is synchronised
    where the JAX package blocks on the loss,
  * on a mesh: every rank restores, only rank 0 prints and writes
    checkpoints, and the others wait for its last one at a barrier; the
    parameters' ``logical`` tree (required) places them: every rank cuts
    its expert blocks from the whole tensors it initialised or restored,
    and the checkpoint gathers them whole again, so a run resumes on any
    world.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import _leaves, _unflatten
from repro_torch.layers.common import dtype_of
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.adamw import OptState, opt_state_logical
from repro_torch.sharding.specs import NULL_CTX, ShardingCtx

Tensor = torch.Tensor


def _tree_map(fn, tree):
    """``fn`` on every array leaf of a batch (dicts, lists, tuples and
    dataclasses such as ``models.graph.Graph``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def to_device(batch, device):
    """A host batch on ``device``: numpy arrays and tensors moved."""
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    return _tree_map(move, batch)


def make_train_step(
    loss_fn: Callable,
    *,
    base_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10000,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    accum_steps: int = 1,
    grad_dtype: Optional[str] = None,
    donate: bool = True,
    ctx: ShardingCtx = NULL_CTX,
    held_axes=None,
):
    """Build a train step.

    ``loss_fn(params, batch) -> (loss, metrics)``.  With ``accum_steps >
    1`` the batch's leading axis must be divisible by it; microbatches run
    one after another, their float32 gradients summed.  The step's metrics
    are detached tensors plus ``grad_norm`` and ``lr`` (on a mesh, the loss
    metrics of this rank's rows).  With a mesh in ``ctx`` the step is
    data-parallel: see the module docstring; ``held_axes`` (a tree beside
    the parameters, `ShardingCtx.held_axes`) names the mesh axes each
    parameter is held split over (None: every parameter whole).
    """
    mesh = ctx.mesh

    def grads_of(params, batch):
        leaves, _ = _leaves(params)
        for p in leaves:
            if p.is_floating_point() and not p.requires_grad:
                p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for g, p in zip(gs, leaves)]
        return gs, {k: v.detach() if isinstance(v, Tensor) else v
                    for k, v in metrics.items()}

    def accumulate(params, batch):
        if accum_steps == 1:
            return grads_of(params, batch)
        acc = None
        for i in range(accum_steps):
            micro = _tree_map(
                lambda x: x.reshape((accum_steps, -1) + tuple(x.shape[1:]))[i],
                batch)
            gs, metrics = grads_of(params, micro)
            with torch.no_grad():
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=torch.float32,
                                       device=g.device) for g in gs]
                for a, g in zip(acc, gs):
                    a.add_(g.to(torch.float32) / accum_steps)
        return acc, metrics

    def local_rows(batch):
        if mesh is None or not isinstance(batch, dict):
            return batch
        return _tree_map(lambda x: ctx.local_block(x, ("batch",)), batch)

    def step(params, opt_state, batch):
        gs, metrics = accumulate(params, local_rows(batch))
        gnorm = None
        if mesh is not None:
            from repro_torch.sharding import collectives as C
            if grad_dtype:
                gs = [g.to(dtype_of(grad_dtype)) for g in gs]
            split = ([frozenset()] * len(gs) if held_axes is None
                     else _leaves(held_axes)[0])
            C.reduce_gradients_(gs, split, mesh)
            gnorm = _split_norm(gs, split, mesh)
        grads = _unflatten(params, gs)
        lr = cosine_schedule(opt_state.step, base_lr=base_lr, warmup=warmup,
                             total=total_steps)
        params, opt_state, om = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, grad_dtype=grad_dtype,
            inplace=donate, grad_norm=gnorm)
        return params, opt_state, {**metrics, **om, "lr": lr}

    return step


@torch.no_grad()
def _split_norm(gs, split, mesh) -> Tensor:
    """The global norm of a gradient tree of which this rank holds parts:
    the float32 sum of squares of the whole leaves, plus each split leaf's
    summed over the ranks along its axes."""
    from repro_torch.sharding import collectives as C

    total = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    parts = {}
    for g, ax in zip(gs, split):
        sq = torch.sum(g.to(torch.float32) ** 2)
        if ax:
            parts[ax] = parts.get(ax, 0) + sq
        else:
            total = total + sq
    for ax, sq in parts.items():
        total = total + C.all_sum(sq, mesh, tuple(sorted(ax)))
    return torch.sqrt(total)


def _tree_shapes(tree):
    """``tree`` with each tensor replaced by its shape (a ``torch.Size``)."""
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(*[_tree_shapes(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_shapes(v) for v in tree)
    return tree.shape


class _Prefetcher:
    """One-batch-ahead host prefetch on a daemon thread."""

    def __init__(self, it: Iterator):
        self.it = it
        self._next = None
        self._sem_full = threading.Semaphore(0)
        self._sem_empty = threading.Semaphore(1)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self.it:
            self._sem_empty.acquire()
            self._next = item
            self._sem_full.release()

    def __next__(self):
        self._sem_full.acquire()
        item = self._next
        self._sem_empty.release()
        return item


class TrainLoop:
    """Fault-tolerant training driver."""

    def __init__(
        self,
        loss_fn: Callable,
        init_params_fn: Callable[[], Any],
        data_iter: Iterator,
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        log_every: int = 10,
        prefetch: bool = True,
        ctx: ShardingCtx = NULL_CTX,
        logical=None,
        **step_kwargs,
    ):
        if ctx.mesh is not None and logical is None:
            raise ValueError("TrainLoop on a mesh needs the parameters' "
                             "logical tree (logical=)")
        self.data = _Prefetcher(data_iter) if prefetch else data_iter
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.distributed = ctx.mesh is not None
        self.lead = True
        if self.distributed:
            import torch.distributed as dist
            self.lead = dist.get_rank() == 0
        self.mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.step_times: collections.deque = collections.deque(maxlen=512)
        self.history: list = []

        params = init_params_fn()
        opt_state = adamw_init(params)
        self.device = opt_state.step.device
        self.state = (params, opt_state)
        self.start_step = 0
        if self.mgr is not None:
            restored, step = self.mgr.restore((params, opt_state))
            if restored is not None:
                self.state = restored
                self.start_step = int(step)
                self._say(f"[train] restored checkpoint at step {step}")
        # the port's layout on a mesh: each rank cuts its expert blocks
        # from the whole tensors (initialised or restored)
        self.ctx, self.held = ctx, None
        held_axes = None
        if self.distributed:
            log = (logical, opt_state_logical(logical))
            shapes = _tree_shapes(self.state)
            held_axes = ctx.held_axes(logical, shapes[0])
            self.held = (log, shapes)
            self.state = ctx.held_blocks(log, self.state)
        self.step_fn = make_train_step(loss_fn, ctx=ctx, held_axes=held_axes,
                                       **step_kwargs)

    def _say(self, line: str) -> None:
        if self.lead:
            print(line, flush=True)

    def _save(self, step, wait: bool = False) -> None:
        """Checkpoint ``step`` (rank 0 only on a mesh: every rank holds
        the same whole tensors, or its blocks of the split ones, which
        every rank gathers whole first); with ``wait`` block until it is
        written, the other ranks at a barrier."""
        if self.mgr is None:
            return
        state = self.state
        if self.held is not None:
            state = self.ctx.gather_held(self.held[0], state, self.held[1])
        if self.lead:
            self.mgr.save_async(step, state)
            if wait:
                self.mgr.wait()
        if wait and self.distributed:
            import torch.distributed as dist
            dist.barrier()

    def _emergency_save(self, step):
        if self.mgr is not None:
            self._say(f"[train] emergency checkpoint at step {step}")
            self._save(step, wait=True)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, n_steps: int) -> Dict[str, float]:
        params, opt_state = self.state
        step = self.start_step
        last_metrics: Dict[str, float] = {}
        try:
            while step < n_steps:
                batch = to_device(next(self.data), self.device)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                self._sync()
                dt = time.perf_counter() - t0
                self.step_times.append(dt)
                self.state = (params, opt_state)
                step += 1
                if step % self.log_every == 0 or step == n_steps:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    ts = np.asarray(self.step_times)
                    last_metrics["step_p50_ms"] = float(
                        np.percentile(ts, 50) * 1e3)
                    last_metrics["step_p95_ms"] = float(
                        np.percentile(ts, 95) * 1e3)
                    self.history.append({"step": step, **last_metrics})
                    self._say(f"[train] step {step}: " + " ".join(
                        f"{k}={v:.4g}" for k, v in last_metrics.items()))
                if step % self.ckpt_every == 0:
                    self._save(step)
        except KeyboardInterrupt:
            self._emergency_save(step)
            raise
        self._save(step, wait=True)
        return last_metrics
