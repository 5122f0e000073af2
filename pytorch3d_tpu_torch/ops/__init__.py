"""Ops (port of pytorch3d_tpu/ops; interpolation of face attributes, grid
sampling, KNN, point sampling from meshes, the fused NeRF MLP, Laplacian
matrices, packed <-> padded gathers, point covariances and normals, face
areas and normals, the splatting of points into volumes, ball query,
farthest point sampling, point and camera alignment (ICP), EPnP, cubify,
marching cubes, box IoU, subdivision, vert align, graph convolution and
Taubin smoothing)."""
from .ball_query import ball_query
from .cameras_alignment import corresponding_cameras_alignment
from .cubify import cubify
from .fused_mlp_cuda import fused_mlp, fused_nerf_field
from .graph_conv import GraphConv, gather_scatter, gather_scatter_python
from .grid_sample import grid_sample
from .interp_face_attrs import interpolate_face_attributes, interpolate_face_attributes_python
from .iou_box3d import box3d_overlap
from .knn import knn_gather, knn_points
from .laplacian_matrices import cot_laplacian, laplacian, norm_laplacian
from .marching_cubes import marching_cubes, marching_cubes_naive
from .mesh_face_areas_normals import mesh_face_areas_normals
from .mesh_filtering import taubin_smoothing
from .packed_to_padded import packed_to_padded, padded_to_packed
from .perspective_n_points import efficient_pnp
from .points_alignment import corresponding_points_alignment, iterative_closest_point
from .points_normals import estimate_pointcloud_local_coord_frames, estimate_pointcloud_normals
from .points_to_volumes import add_pointclouds_to_volumes, add_points_features_to_volume_densities_features
from .sample_farthest_points import sample_farthest_points, sample_farthest_points_naive
from .sample_points_from_meshes import sample_points_from_meshes
from .subdivide_meshes import SubdivideMeshes
from .utils import convert_pointclouds_to_tensor, eyes, get_point_covariances, is_pointclouds, masked_gather, wmean
from .vert_align import vert_align

__all__ = [k for k in dir() if not k.startswith("_")]
