"""Core data structures (port of pytorch3d_tpu/structures; meshes only so far)."""
from .meshes import Meshes
from .utils import list_to_padded

__all__ = [k for k in dir() if not k.startswith("_")]
