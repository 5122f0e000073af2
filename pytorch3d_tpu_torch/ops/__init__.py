"""Ops (port of pytorch3d_tpu/ops; interpolation of face attributes, grid
sampling, KNN, point sampling from meshes and the fused NeRF MLP so far)."""
from .fused_mlp_cuda import fused_mlp, fused_nerf_field
from .grid_sample import grid_sample
from .interp_face_attrs import interpolate_face_attributes
from .knn import knn_gather, knn_points
from .sample_points_from_meshes import sample_points_from_meshes

__all__ = [k for k in dir() if not k.startswith("_")]
