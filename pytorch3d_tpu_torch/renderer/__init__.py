"""Differentiable rendering (port of pytorch3d_tpu/renderer; the mesh,
point, pulsar and NeRF rendering paths and the cameras so far)."""
from .blending import BlendParams, hard_rgb_blend, sigmoid_alpha_blend, softmax_rgb_blend
from .camera_conversions import cameras_from_opencv_projection, opencv_from_cameras_projection
from .camera_utils import camera_to_eye_at_up, join_cameras_as_batch, rotate_on_spot
from .cameras import (
    CamerasBase,
    FoVOrthographicCameras,
    FoVPerspectiveCameras,
    OpenGLOrthographicCameras,
    OpenGLPerspectiveCameras,
    OrthographicCameras,
    PerspectiveCameras,
    SfMOrthographicCameras,
    SfMPerspectiveCameras,
    camera_position_from_spherical_angles,
    get_ndc_to_screen_transform,
    get_screen_to_ndc_transform,
    get_world_to_view_transform,
    look_at_rotation,
    look_at_view_transform,
    try_get_projection_transform,
)
from .fisheyecameras import FishEyeCameras
from .implicit import (
    AbsorptionOnlyRaymarcher,
    EmissionAbsorptionRaymarcher,
    GridRaysampler,
    HarmonicEmbedding,
    HeterogeneousRayBundle,
    ImplicitRenderer,
    MonteCarloRaysampler,
    MultinomialRaysampler,
    NDCGridRaysampler,
    NDCMultinomialRaysampler,
    RayBundle,
    VolumeRenderer,
    VolumeSampler,
    ray_bundle_to_ray_points,
    ray_bundle_variables_to_ray_points,
    sample_pdf,
)
from .lighting import AmbientLights, DirectionalLights, PointLights, diffuse, specular
from .materials import Materials
from .mesh import (
    Fragments,
    HardDepthShader,
    HardFlatShader,
    HardGouraudShader,
    HardPhongShader,
    MeshRasterizer,
    MeshRasterizerOpenGL,
    MeshRenderer,
    MeshRendererWithFragments,
    RasterizationSettings,
    SoftDepthShader,
    SoftGouraudShader,
    SoftPhongShader,
    SoftSilhouetteShader,
    SplatterPhongShader,
    Textures,
    TexturesAtlas,
    TexturesUV,
    TexturesVertex,
    rasterize_meshes,
)
from .mesh.shading import flat_shading, gouraud_shading, phong_shading
from .splatter_blend import SplatterBlender
from .points import (
    AlphaCompositor,
    NormWeightedCompositor,
    PointFragments,
    PointsRasterizationSettings,
    PointsRasterizer,
    PointsRenderer,
    PulsarPointsRenderer,
    alpha_composite,
    norm_weighted_sum,
    rasterize_points,
    weighted_sum,
)
from .utils import (
    TensorProperties,
    convert_to_tensors_and_broadcast,
    format_tensor,
    ndc_grid_sample,
    ndc_to_grid_sample_coords,
)

__all__ = [k for k in dir() if not k.startswith("_")]
