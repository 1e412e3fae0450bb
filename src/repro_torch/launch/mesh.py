"""Mesh construction: the port of ``src/repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, its dims named like the JAX package's axes
(``pod``, ``data``, ``model``); rank r sits at the row-major coordinate of
r, as JAX's meshes place devices.  Functions, not module-level constants:
importing this module touches no process group, so the tests and
single-device runs never see one.

``make_production_mesh`` gives the JAX package's dry-run meshes, (16, 16)
``('data', 'model')`` and (2, 16, 16) ``('pod', 'data', 'model')``, over
the default process group: 256 or 512 ranks, which the dry run
(`repro_torch.launch.dryrun`) makes as a ``fake`` process group in one
process.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str], *,
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group (which the caller initialised).  On CUDA each
    rank should have chosen its card (``torch.cuda.set_device``) first:
    ranks that share one card all choose it."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda"):
    """The JAX package's production mesh: (16, 16) over ``('data',
    'model')``, or with ``multi_pod`` (2, 16, 16) over ``('pod', 'data',
    'model')``, over the default process group (256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device_type=device_type)


def elastic_shape(n: int, n_model: int = 0) -> Tuple[int, int]:
    """(n_data, n_model) of the largest (data, model) mesh over ``n``
    ranks: n_model = min(16, n) unless given, halved until it divides n."""
    if n_model <= 0:
        n_model = min(16, n)
    while n_model > 1 and n % n_model:
        n_model //= 2
    return n // n_model, n_model


def make_elastic_mesh(n_model: int = 0, *, device_type: str = "cuda"):
    """The largest (data, model) mesh the live ranks support — the elastic
    rescale entry point: after a failure the job restarts on fewer ranks
    and trains on (n_live // n_model, n_model) with the same logical
    sharding rules (the checkpoint holds whole tensors, so any world
    resumes it)."""
    import torch.distributed as dist

    return make_mesh_compat(elastic_shape(dist.get_world_size(), n_model),
                            ("data", "model"), device_type=device_type)
