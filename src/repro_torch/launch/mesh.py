"""Mesh construction of the launch layer: the port of the JAX package's
``launch/mesh.py`` over ``torch.distributed`` ranks (DESIGN.md §4).

single-pod: (16, 16)    axes ("data", "model") — one FL super node,
            16-way hierarchical data parallel × 16-way tensor parallel.
multi-pod:  (2, 16, 16) axes ("pod", "data", "model") — each pod is one
            FEDGS super node; external synchronization crosses 'pod'.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of the
initialised world. The production meshes need 256 or 512 ranks; with one
H100 such a world exists only under torch's fake process group
(:func:`init_fake_world`: every collective returns at once with the right
shapes), which is what the meta-device dry run (``launch.dryrun``) runs
on. Functions, not module-level constants, so that importing this module
touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """Initialise a ``world_size``-rank world in this process on torch's
    fake backend (``torch.testing._internal.distributed.fake_pg``; its
    collectives move no data). The dry run's stand-in for 256 or 512
    devices, as the JAX dry run's forced host devices are."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def is_fake_world() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_backend() == "fake"


def _mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The (16, 16) or (2, 16, 16) mesh. It needs a world of 256 or 512
    ranks, which one card has only under the fake backend; anywhere else
    this raises and says so."""
    shape, axes = PRODUCTION[multi_pod]
    need = math.prod(shape)
    if not is_fake_world() or dist.get_world_size() != need:
        raise RuntimeError(
            f"make_production_mesh: the {shape} mesh {axes} needs a world "
            f"of {need} ranks. One H100 has that only under the fake "
            f"process group (launch.mesh.init_fake_world({need})), where "
            "collectives move no data: the dry run's world. A real run "
            "takes launch.mesh.make_host_mesh over its own ranks.")
    return _mesh(device_type, shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1, pod: int = 1,
                   device_type: str | None = None):
    """A small mesh over the ranks of the initialised world (their product
    must be the world size): (pod, data, model) when pod > 1, else (data,
    model). ``device_type`` defaults to 'cuda' on NCCL, else 'cpu'."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh: initialise torch.distributed "
                           "first (init_process_group)")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if pod > 1:
        return _mesh(device_type, (pod, data, model),
                     ("pod", "data", "model"))
    return _mesh(device_type, (data, model), ("data", "model"))


def make_group_mesh(num_groups: int | None = None):
    """The 'groups' mesh of the sharded FEDGS engine (DESIGN.md §8) over
    the ``torch.distributed`` ranks. The implementation lives with the
    engine (``repro_torch.core.fedgs.make_group_mesh``), so that the engine
    and this entry point cannot drift apart."""
    from ..core.fedgs import make_group_mesh as impl
    return impl(num_groups)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: ('pod', 'data') or ('data',)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
