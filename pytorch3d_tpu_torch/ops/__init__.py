"""Ops (port of pytorch3d_tpu/ops; interpolation of face attributes so far)."""
from .interp_face_attrs import interpolate_face_attributes

__all__ = ["interpolate_face_attributes"]
