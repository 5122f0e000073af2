"""Ops (port of pytorch3d_tpu/ops; interpolation of face attributes, KNN
and point sampling from meshes so far)."""
from .interp_face_attrs import interpolate_face_attributes
from .knn import knn_gather, knn_points
from .sample_points_from_meshes import sample_points_from_meshes

__all__ = [k for k in dir() if not k.startswith("_")]
