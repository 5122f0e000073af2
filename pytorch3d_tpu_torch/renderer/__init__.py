"""Differentiable rendering (port of pytorch3d_tpu/renderer; the mesh and
point rendering paths so far)."""
from .blending import BlendParams, hard_rgb_blend, sigmoid_alpha_blend, softmax_rgb_blend
from .cameras import (
    CamerasBase,
    FoVOrthographicCameras,
    FoVPerspectiveCameras,
    camera_position_from_spherical_angles,
    get_world_to_view_transform,
    look_at_rotation,
    look_at_view_transform,
    try_get_projection_transform,
)
from .lighting import PointLights, diffuse, specular
from .materials import Materials
from .mesh import (
    Fragments,
    HardGouraudShader,
    HardPhongShader,
    MeshRasterizer,
    MeshRenderer,
    RasterizationSettings,
    SoftPhongShader,
    SoftSilhouetteShader,
    TexturesVertex,
    rasterize_meshes,
)
from .mesh.shading import gouraud_shading, phong_shading
from .points import (
    AlphaCompositor,
    NormWeightedCompositor,
    PointFragments,
    PointsRasterizationSettings,
    PointsRasterizer,
    PointsRenderer,
    alpha_composite,
    norm_weighted_sum,
    rasterize_points,
    weighted_sum,
)

__all__ = [k for k in dir() if not k.startswith("_")]
