"""Mesh construction of the launch layer (the port of ``make_group_mesh``
in the JAX package's ``launch/mesh.py``; its production meshes are
ROADMAP item 19)."""
from __future__ import annotations


def make_group_mesh(num_groups: int | None = None):
    """The 'groups' mesh of the sharded FEDGS engine (DESIGN.md §8) over
    the ``torch.distributed`` ranks. The implementation lives with the
    engine (``repro_torch.core.fedgs.make_group_mesh``), so that the engine
    and this entry point cannot drift apart."""
    from ..core.fedgs import make_group_mesh as impl
    return impl(num_groups)
