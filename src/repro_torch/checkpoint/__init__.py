"""Pytree checkpoints in the JAX package's on-disk format."""
from .checkpoint import latest_step, load, restore, save  # noqa: F401
