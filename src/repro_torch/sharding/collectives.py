"""Collectives over a mesh's named dims: the port's counterpart of the
``jax.lax`` collectives inside the JAX package's ``shard_map`` bodies.

  axis_group(mesh, axes)       -> the process group of the ranks that
                                  differ only along ``axes``
  axis_index(mesh, axes)       -> ``jax.lax.axis_index(axes)``
  all_gather(x, mesh, axes)    -> ``jax.lax.all_gather`` (stacked on a new
                                  dim)
  all_to_all(x, mesh, axis)    -> ``jax.lax.all_to_all`` of dim 0 blocks,
                                  differentiable (its own adjoint)
  all_mean(x, mesh, axes)      -> ``jax.lax.pmean``, differentiable
  all_sum(x, mesh, axes)       -> ``jax.lax.psum`` (no gradient)
  all_reduce_mean_(tensors)    -> the data-parallel mean over the world, in
                                  place
  reduce_gradients_(gs, axes, mesh)
                               -> the train step's reduction of gradients
                                  held split over some mesh axes, in place

The transport follows the group's backend, chosen by whoever made the
process group, and never changes after a failure: on NCCL the tensors stay
on the card; on ``gloo``, which has no all-gather or all-to-all for CUDA
tensors, a CUDA tensor is copied to host memory, exchanged there and
copied back.  That is a transport, not a fallback: the search and MoE
kernels run on the card either way.  `staged_bytes` counts the bytes such
copies move (both directions), `calls` the collectives by kind, `seconds`
the host time spent inside them and `staged_seconds` the part of it in
the copies (a copy to the host first waits for the rank's own kernels).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import (linear_index, mesh_axes,
                                        mesh_coordinate)

Tensor = torch.Tensor
Axes = Union[str, Sequence[str]]

#: Bytes copied between the card and host memory to carry a collective
#: over ``gloo`` (device to host plus host to device).
staged_bytes = 0
#: Collectives issued, by kind.
calls: Dict[str, int] = {"all_gather": 0, "all_to_all": 0, "all_reduce": 0}
#: Host seconds spent inside the collectives (staging included).
seconds = 0.0
#: Host seconds of `seconds` spent in the copies between card and host.
staged_seconds = 0.0

# (id of the mesh, axes) -> (the mesh, kept so its id stays its own;
# the group; the order)
_groups: Dict[Tuple[int, Tuple[str, ...]], tuple] = {}


def reset_counts() -> None:
    global staged_bytes, seconds, staged_seconds
    staged_bytes, seconds, staged_seconds = 0, 0.0, 0.0
    for kind in calls:
        calls[kind] = 0


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axes: Axes) -> int:
    """This rank's linear index over ``axes``, major-to-minor in the order
    given (``jax.lax.axis_index`` over a tuple of axis names)."""
    return linear_index(mesh_axes(mesh), mesh_coordinate(mesh),
                        _axes(axes))[0]


def axis_group(mesh, axes: Axes):
    """(process group, order) of the ranks that share this rank's
    coordinates on every mesh dim but ``axes``.  ``order[i]`` is the group
    rank of the member whose `axis_index` over ``axes`` is i, so a gather
    can be put in the JAX package's order.  Every rank of the mesh must
    ask for the same ``axes`` in the same order (each distinct set makes
    its groups once, all ranks taking part)."""
    axes = _axes(axes)
    key = (id(mesh), axes)
    if key in _groups:
        return _groups[key][1:]
    sizes = mesh_axes(mesh)
    names = list(sizes)
    for a in axes:
        if a not in sizes:
            raise ValueError(f"mesh {tuple(names)} has no axis {a!r}")
    ranks = mesh.mesh.reshape(tuple(sizes.values()))
    # mesh dims of ``axes`` last, in the order given; the rest first
    rest = [names.index(n) for n in names if n not in axes]
    perm = rest + [names.index(a) for a in axes]
    blocks = ranks.permute(perm).reshape(
        -1, math.prod(sizes[a] for a in axes))
    me = dist.get_rank()
    mine = None
    for row in blocks.tolist():
        if len(row) == dist.get_world_size():
            group = dist.group.WORLD
        else:
            group = dist.new_group(sorted(row))
        if me in row:
            # row is in axis_index order; the group ranks are sorted
            mine = (group, [sorted(row).index(r) for r in row])
    if mine is None:
        raise ValueError("this rank is not in the mesh")
    _groups[key] = (mesh,) + mine
    return mine


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_wire(x: Tensor, group) -> Tensor:
    global staged_bytes, staged_seconds
    x = x.contiguous()
    if x.is_cuda and _staged(group):
        t0 = time.perf_counter()
        staged_bytes += x.numel() * x.element_size()
        x = x.cpu()
        staged_seconds += time.perf_counter() - t0
    return x


def _from_wire(y: Tensor, like: Tensor) -> Tensor:
    global staged_bytes, staged_seconds
    if y.device != like.device:
        t0 = time.perf_counter()
        staged_bytes += y.numel() * y.element_size()
        y = y.to(like.device)
        staged_seconds += time.perf_counter() - t0
    return y


def all_gather(x: Tensor, mesh, axes: Axes, *, dim: int = 0) -> Tensor:
    """Every member's ``x`` along ``axes``, in `axis_index` order, stacked
    on a new dim ``dim``.  Not differentiable (no path needs its
    gradient)."""
    global seconds
    t0 = time.perf_counter()
    group, order = axis_group(mesh, axes)
    n = len(order)
    wire = _to_wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    parts = [parts[g] for g in order]
    out = _from_wire(torch.stack(parts, dim), x)
    calls["all_gather"] += 1
    seconds += time.perf_counter() - t0
    return out


def _all_to_all_dim0(x: Tensor, group, order: List[int]) -> Tensor:
    """Block j of dim 0 to the member of axis index j; block j of the
    result from it."""
    global seconds
    t0 = time.perf_counter()
    n = len(order)
    wire = _to_wire(x, group)
    if wire.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into "
                         f"{n} blocks")
    inv = [order.index(g) for g in range(n)]       # group rank -> axis idx
    blocks = wire.reshape((n, -1) + tuple(wire.shape[1:]))
    send = blocks[inv].contiguous() if inv != list(range(n)) else blocks
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if inv != list(range(n)):
        recv = recv[order]
    out = _from_wire(recv.reshape(wire.shape), x)
    calls["all_to_all"] += 1
    seconds += time.perf_counter() - t0
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, order):
        ctx.group, ctx.order = group, order
        return _all_to_all_dim0(x, group, order)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_dim0(g, ctx.group, ctx.order), None, None


def all_to_all(x: Tensor, mesh, axis: Axes) -> Tensor:
    """``jax.lax.all_to_all`` over ``axis`` with dim 0 split into one block
    a member: block j goes to the member of axis index j, and block j of
    the result came from it.  Its own adjoint, so its backward is the same
    exchange of the gradient."""
    group, order = axis_group(mesh, axis)
    if len(order) == 1:
        return x
    return _AllToAll.apply(x, group, order)


def _mean(x: Tensor, group) -> Tensor:
    global seconds
    t0 = time.perf_counter()
    wire = _to_wire(x, group).clone()
    dist.all_reduce(wire, group=group)
    out = _from_wire(wire / dist.get_world_size(group), x)
    calls["all_reduce"] += 1
    seconds += time.perf_counter() - t0
    return out


class _AllMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean(x, group)

    @staticmethod
    def backward(ctx, g):
        # the mean's adjoint: each member gets the mean of the cotangents
        return _mean(g, ctx.group), None


def all_mean(x: Tensor, mesh, axes: Axes) -> Tensor:
    """``jax.lax.pmean`` over ``axes``; its backward is the mean of the
    members' cotangents (the mean's adjoint), so a loss term that every
    member adds gets its single-device gradient after a data-parallel
    mean."""
    group, order = axis_group(mesh, axes)
    if len(order) == 1:
        return x
    return _AllMean.apply(x, group)


@torch.no_grad()
def all_sum(x: Tensor, mesh, axes: Axes) -> Tensor:
    """``jax.lax.psum`` over ``axes``: the members' sum (a new tensor)."""
    group, order = axis_group(mesh, axes)
    out = x.clone()
    if len(order) > 1:
        _flat_all_reduce_([out], group, mean=False)
    return out


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[Tensor]) -> None:
    """Average ``tensors`` over the world in place: one all-reduce a
    dtype, over a flat buffer of that dtype's tensors."""
    _flat_all_reduce_(tensors, dist.group.WORLD)


@torch.no_grad()
def reduce_gradients_(grads: Sequence[Tensor], split: Sequence[frozenset],
                      mesh) -> None:
    """The data-parallel reduction of gradients whose parameters are held
    split over the mesh axes ``split[i]`` (`ShardingCtx.held_axes`), in
    place.  A whole parameter's gradient is averaged over the world.  A
    split one (an expert slice, split over ``model``) differs by rank: it
    is averaged over the other axes only, then divided by the size of its
    own axes — the ranks along them hold the same tokens, so the owner of
    a slice received that many copies' gradients (the ep fold, see
    ``layers.moe.moe_apply_ep``).  What remains is the one-device gradient
    of the slice, as the world mean leaves it for a whole parameter."""
    sizes = mesh_axes(mesh)
    by_split: Dict[frozenset, List[Tensor]] = {}
    for g, ax in zip(grads, split):
        by_split.setdefault(frozenset(ax), []).append(g)
    for ax, gs in by_split.items():
        if not ax:
            all_reduce_mean_(gs)
            continue
        rest = tuple(a for a in sizes if a not in ax)
        if rest:
            group, order = axis_group(mesh, rest)
            if len(order) > 1:
                _flat_all_reduce_(gs, group)
        fold = math.prod(sizes[a] for a in ax)
        for g in gs:
            g.div_(fold)


def _flat_all_reduce_(tensors: Sequence[Tensor], group, mean: bool = True
                      ) -> None:
    """Average (or, without ``mean``, sum) ``tensors`` over ``group`` in
    place: one all-reduce a dtype, over a flat buffer of that dtype's
    tensors."""
    global seconds
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        wire = _to_wire(flat, group)
        dist.all_reduce(wire, group=group)
        wire = _from_wire(wire, flat)
        if mean:
            wire.div_(n)
        off = 0
        for t in ts:
            t.copy_(wire[off:off + t.numel()].view(t.shape))
            off += t.numel()
        calls["all_reduce"] += 1
    seconds += time.perf_counter() - t0
