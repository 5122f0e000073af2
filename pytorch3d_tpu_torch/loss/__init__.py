"""Losses (port of pytorch3d_tpu/loss): chamfer, the mesh regularizers and
the point-mesh distances."""
from .chamfer import chamfer_distance
from .mesh_edge_loss import mesh_edge_loss
from .mesh_laplacian_smoothing import mesh_laplacian_smoothing
from .mesh_normal_consistency import mesh_normal_consistency
from .point_mesh_distance import point_mesh_edge_distance, point_mesh_face_distance

__all__ = [k for k in dir() if not k.startswith("_")]
