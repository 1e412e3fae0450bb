"""Logical-axis sharding: the port of ``src/repro/sharding/specs.py``.

One rules table maps model-space axis names to mesh axes; every parameter
and activation carries logical names, and the same model code runs on one
device (no mesh), one host of ranks, or a (pod, data, model) mesh.

Rules (defaults, the JAX package's table):

    batch    -> ('pod', 'data')   data parallelism (+ pod axis folded in)
    embed    -> ('data',)         FSDP: parameters sharded over data
    vocab    -> ('model',)        vocab-parallel embed / logits
    heads    -> ('model',)        tensor parallelism over attention heads
    kv_heads -> ('model',)
    mlp      -> ('model',)        tensor parallelism over FFN hidden
    expert   -> ('model',)        expert parallelism (MoE all-to-all)
    kv_seq   -> ()                decode cache sequence axis
    rows     -> ('pod', 'data')   corpus / document axis of retrieval DBs
    fields   -> ('model',)        recsys: table-wise parallelism
    nodes / edges                 GNN: graph partitioned over devices

Unknown logical names map to replicated.  An axis rule is dropped when the
mesh lacks that axis or the dimension is not divisible by the axis size.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, or an `AbstractMesh` (names and sizes only, no process group): `spec`
reads nothing else, so it is the JAX package's ``PartitionSpec`` on any
mesh shape, with or without ranks behind it.  `sharding` turns a spec into
DTensor placements, one per mesh dim.  A value on a rank is the local
block that the JAX package's ``shard_map`` would hand its local function;
`ShardingCtx.local_block` cuts that block out of a whole tensor.

The rules above are the layout the JAX package runs (through GSPMD).  The
port holds less of it: a parameter is split only over the names in
`HELD_SPLIT` (the MoE experts, over ``model``: expert parallelism), and is
whole on every rank otherwise (data parallelism).  `held_logical` maps a
leaf's logical names to that layout; `ShardingCtx.held_blocks` cuts a tree
to it, `ShardingCtx.held_axes` names the mesh axes each leaf is split over
(the train step reduces a gradient over the others), and
`ShardingCtx.gather_held` joins the blocks into whole tensors again (the
checkpoint's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": ("data",),
    "embed_act": (),
    "embed_moe": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "layers": (),
    "kv_seq": (),
    "rows": ("pod", "data"),
    "fields": ("model",),
    "nodes": ("data",),
    "edges": ("pod", "data", "model"),
    "cand": ("data",),
}


#: Logical names the port splits a parameter over on a mesh (the rest of a
#: rules' layout it holds whole): the experts of an MoE layer.
HELD_SPLIT: Tuple[str, ...] = ("expert",)


def held_logical(logical: Sequence[Optional[str]]) -> tuple:
    """A leaf's logical names as the port holds it: the names of
    `HELD_SPLIT` kept, every other dim replicated."""
    return tuple(n if n in HELD_SPLIT else None for n in logical)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim names and sizes without devices or a process group
    (``jax.sharding.AbstractMesh``'s role): enough for `ShardingCtx.spec`
    and `ShardingCtx.sharding`."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and names "
                             f"{self.mesh_dim_names} differ in length")


def mesh_axes(mesh) -> Dict[str, int]:
    """name -> size of every dim of ``mesh`` (a ``DeviceMesh`` or an
    `AbstractMesh`), in the mesh's order."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, tuple(mesh.shape)))


def _is_logical_leaf(x) -> bool:
    """A leaf of a logical tree: a tuple of axis names (str or None).  An
    ``OptState`` (a NamedTuple of subtrees) is not one."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def _map_logical(fn, logical, tree, *more):
    """``fn(logical leaf, tree leaf, *leaves of more)`` over trees of one
    structure (the logical tree's): dicts by key, lists, tuples and
    NamedTuples in order; below a logical leaf a tree's node is passed
    whole (a shape, say)."""
    if _is_logical_leaf(logical):
        return fn(logical, tree, *more)
    if isinstance(logical, dict):
        if set(logical) != set(tree):
            raise ValueError(f"logical keys {sorted(logical)} != "
                             f"tree keys {sorted(tree)}")
        return {k: _map_logical(fn, logical[k], tree[k],
                                *[m[k] for m in more]) for k in logical}
    if isinstance(logical, (list, tuple)):
        if len(logical) != len(tree):
            raise ValueError(f"logical length {len(logical)} != tree "
                             f"length {len(tree)}")
        out = [_map_logical(fn, a, b, *ms)
               for a, b, *ms in zip(logical, tree, *more)]
        if isinstance(logical, list):
            return out
        return type(logical)(*out) if hasattr(logical, "_fields") \
            else tuple(out)
    raise TypeError(f"not a logical tree node: {logical!r}")


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Binds a mesh + rules table; translates logical axes to shardings."""

    mesh: Optional[object]
    rules: Tuple[Tuple[str, Tuple[str, ...]], ...]  # hashable rules

    @property
    def rules_dict(self) -> Dict[str, Tuple[str, ...]]:
        return dict(self.rules)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> tuple:
        """The ``PartitionSpec`` entries for a tuple of logical axis names
        (None = replicated): per tensor dim None, a mesh axis name, or a
        tuple of names (sharded over them major-to-minor); trailing Nones
        dropped, as ``P(...)`` prints them.

        If ``shape`` is given, axis rules whose mesh size does not divide
        the dimension are dropped."""
        if self.mesh is None:
            return ()
        rules = self.rules_dict
        sizes = mesh_axes(self.mesh)
        used = set()
        out = []
        for i, name in enumerate(logical):
            if name is None or name not in rules:
                out.append(None)
                continue
            cand = [a for a in rules[name] if a in sizes and a not in used]
            if shape is not None and cand:
                keep, size = [], 1
                for a in cand:
                    nsize = size * sizes[a]
                    if shape[i] % nsize == 0:
                        keep.append(a)
                        size = nsize
                cand = keep
            if not cand:
                out.append(None)
            elif len(cand) == 1:
                out.append(cand[0])
                used.update(cand)
            else:
                out.append(tuple(cand))
                used.update(cand)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def sharding(self, logical, shape=None):
        """DTensor placements of ``logical`` on the mesh: one per mesh dim,
        ``Shard(i)`` where the spec puts that mesh axis on tensor dim i,
        else ``Replicate()``; None without a mesh.  A tensor dim sharded
        over several axes is split major-to-minor in the spec's order,
        which DTensor does in mesh-dim order: the spec's order must be the
        mesh's (it is for every rule of `DEFAULT_RULES`)."""
        if self.mesh is None:
            return None
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_axes(self.mesh))
        out = [Replicate() for _ in names]
        for i, entry in enumerate(self.spec(logical, shape)):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"tensor dim {i} is sharded over {axes}, "
                                 f"not in the mesh's order {tuple(names)}")
            for p in pos:
                out[p] = Shard(i)
        return tuple(out)

    def constrain(self, x, logical):
        """The identity.  The JAX package's ``with_sharding_constraint`` is
        a layout hint to GSPMD that never changes a value; PyTorch runs
        eagerly and has no compiler to hint, so a value here is already the
        rank's own block."""
        return x

    def tree_shardings(self, logical_tree, param_tree):
        """Match a logical-axes tree against a param tree -> placements.

        ``logical_tree`` mirrors ``param_tree``'s structure with tuples of
        logical names at the leaves (a leaf = tuple of str / None)."""
        return _map_logical(lambda log, p: self.sharding(log, tuple(p.shape)),
                            logical_tree, param_tree)

    def local_block(self, x, logical, coord: Optional[Dict[str, int]] = None):
        """The block of the whole tensor ``x`` that this rank (or mesh
        coordinate ``coord``, name -> index) holds under ``logical``: a
        view, each sharded dim cut to its part."""
        if self.mesh is None:
            return x
        if coord is None:
            coord = mesh_coordinate(self.mesh)
        sizes = mesh_axes(self.mesh)
        for i, entry in enumerate(self.spec(logical, tuple(x.shape))):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            idx, n = linear_index(sizes, coord, axes)
            size = x.shape[i] // n
            x = x.narrow(i, idx * size, size)
        return x


    def held_axes(self, logical_tree, tree):
        """A tree of frozensets beside ``tree`` (whole tensors, or their
        shapes): the mesh axes each leaf is split over in the port's layout
        (empty: whole on every rank)."""
        def axes(log, x):
            out = set()
            for e in self.spec(held_logical(log), tuple(_shape(x))):
                if e is not None:
                    out.update((e,) if isinstance(e, str) else e)
            return frozenset(out)

        return _map_logical(axes, logical_tree, tree)

    def held_blocks(self, logical_tree, tree):
        """``tree`` (whole tensors) cut to this rank's blocks of the port's
        layout: a split leaf becomes a copy of its block (so the whole
        tensor can be freed), any other leaf stays as it is."""
        if self.mesh is None:
            return tree

        def cut(log, x):
            blk = self.local_block(x, held_logical(log))
            return blk.clone() if blk.shape != x.shape else x

        return _map_logical(cut, logical_tree, tree)

    def gather_held(self, logical_tree, tree, shapes):
        """The whole tensors of a tree held in the port's layout, whose
        whole shapes are the tree ``shapes`` (shapes or tensors): each
        split leaf all-gathered over its axes (a collective: every rank of
        the mesh calls this at the same point), the rest as they are."""
        if self.mesh is None:
            return tree
        from repro_torch.sharding import collectives as C

        def join(log, x, whole):
            for i, e in enumerate(self.spec(held_logical(log),
                                            tuple(_shape(whole)))):
                if e is None:
                    continue
                axes = (e,) if isinstance(e, str) else tuple(e)
                g = C.all_gather(x, self.mesh, axes, dim=i)
                x = g.reshape(x.shape[:i] + (-1,) + x.shape[i + 1:])
            return x

        return _map_logical(join, logical_tree, tree, shapes)


def _shape(x) -> Tuple[int, ...]:
    """The shape of a tensor, or a shape itself."""
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def linear_index(sizes: Dict[str, int], coord: Dict[str, int],
                 axes: Sequence[str]) -> Tuple[int, int]:
    """(index, count) of mesh coordinate ``coord`` over ``axes``: the
    linear index major-to-minor in the order given, as
    ``jax.lax.axis_index`` over a tuple of axis names gives it."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def mesh_coordinate(mesh) -> Dict[str, int]:
    """name -> this rank's index along each dim of a ``DeviceMesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


NULL_CTX = ShardingCtx(mesh=None, rules=tuple(DEFAULT_RULES.items()))


def make_ctx(mesh, overrides: Optional[Dict[str, Tuple[str, ...]]] = None
             ) -> ShardingCtx:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingCtx(mesh=mesh, rules=tuple(sorted(rules.items())))
