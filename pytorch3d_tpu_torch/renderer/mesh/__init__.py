"""Mesh rendering (port of pytorch3d_tpu/renderer/mesh)."""
from .rasterize_meshes import rasterize_meshes
from .rasterizer import Fragments, MeshRasterizer, MeshRasterizerOpenGL, RasterizationSettings
from .renderer import MeshRenderer
from .shader import HardGouraudShader, HardPhongShader, SoftPhongShader, SoftSilhouetteShader
from .textures import TexturesVertex

__all__ = [k for k in dir() if not k.startswith("_")]
