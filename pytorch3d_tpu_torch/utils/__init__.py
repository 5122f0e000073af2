"""Utility meshes (port of pytorch3d_tpu/utils; primitives only so far)."""
from .ico_sphere import ico_sphere
from .torus import torus

__all__ = ["ico_sphere", "torus"]
