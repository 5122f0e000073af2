"""Core data structures (port of pytorch3d_tpu/structures; meshes and point
clouds so far)."""
from .meshes import Meshes
from .pointclouds import Pointclouds, join_pointclouds_as_batch, join_pointclouds_as_scene
from .utils import list_to_padded

__all__ = [k for k in dir() if not k.startswith("_")]
