"""Mesh rendering (port of pytorch3d_tpu/renderer/mesh)."""
from .rasterize_meshes import rasterize_meshes
from .rasterizer import Fragments, MeshRasterizer, MeshRasterizerOpenGL, RasterizationSettings
from .renderer import MeshRenderer, MeshRendererWithFragments
from .shader import (
    HardDepthShader,
    HardFlatShader,
    HardGouraudShader,
    HardPhongShader,
    ShaderBase,
    SoftDepthShader,
    SoftGouraudShader,
    SoftPhongShader,
    SoftSilhouetteShader,
    SplatterPhongShader,
)
from .shading import flat_shading, gouraud_shading, phong_shading
from .textures import Textures, TexturesAtlas, TexturesUV, TexturesVertex

__all__ = [k for k in dir() if not k.startswith("_")]
