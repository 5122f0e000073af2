"""Utility meshes and camera conversions (port of pytorch3d_tpu/utils)."""
from ..renderer.camera_conversions import (
    cameras_from_opencv_projection,
    opencv_from_cameras_projection,
    pulsar_from_cameras_projection,
    pulsar_from_opencv_projection,
)
from .checkerboard import checkerboard
from .ico_sphere import ico_sphere
from .torus import torus

__all__ = [k for k in dir() if not k.startswith("_")]
