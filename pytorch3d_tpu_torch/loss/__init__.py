"""Losses (port of pytorch3d_tpu/loss; chamfer and the mesh regularizers so
far)."""
from .chamfer import chamfer_distance
from .mesh_edge_loss import mesh_edge_loss
from .mesh_laplacian_smoothing import mesh_laplacian_smoothing
from .mesh_normal_consistency import mesh_normal_consistency

__all__ = [k for k in dir() if not k.startswith("_")]
