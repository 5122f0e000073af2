"""Transforms (port of pytorch3d_tpu/transforms; Transform3d so far)."""
from .transform3d import Rotate, RotateAxisAngle, Scale, Transform3d, Translate

__all__ = ["Rotate", "RotateAxisAngle", "Scale", "Transform3d", "Translate"]
