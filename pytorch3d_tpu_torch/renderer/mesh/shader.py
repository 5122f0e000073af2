"""Shaders (port of pytorch3d_tpu/renderer/mesh/shader.py; the hard and
soft Phong, hard Gouraud and soft silhouette shaders so far)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...common import DEFAULT_DEVICE
from ..blending import BlendParams, hard_rgb_blend, sigmoid_alpha_blend, softmax_rgb_blend
from ..lighting import PointLights
from ..materials import Materials
from .shading import gouraud_shading, phong_shading


class ShaderBase:
    """Default lights and materials are built on `device`."""

    def __init__(
        self,
        cameras=None,
        lights=None,
        materials: Optional[Materials] = None,
        blend_params: Optional[BlendParams] = None,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ):
        self.lights = lights if lights is not None else PointLights.create(device=device)
        self.materials = materials if materials is not None else Materials.create(device=device)
        self.cameras = cameras
        self.blend_params = blend_params if blend_params is not None else BlendParams()

    def _get_cameras(self, **kwargs):
        cameras = kwargs.get("cameras", self.cameras)
        if cameras is None:
            raise ValueError(
                "Cameras must be specified either at initialization or in the "
                f"forward pass of {type(self).__name__}"
            )
        return cameras

    def __call__(self, fragments, meshes, **kwargs) -> torch.Tensor:
        return self.forward(fragments, meshes, **kwargs)


class HardPhongShader(ShaderBase):
    """Per-pixel Phong lighting, hard (closest-face) blending."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        cameras = self._get_cameras(**kwargs)
        colors = phong_shading(
            meshes=meshes, fragments=fragments, texels=meshes.sample_textures(fragments),
            lights=kwargs.get("lights", self.lights), cameras=cameras,
            materials=kwargs.get("materials", self.materials),
        )
        return hard_rgb_blend(colors, fragments, kwargs.get("blend_params", self.blend_params))


class SoftPhongShader(ShaderBase):
    """Per-pixel Phong lighting, softmax blending."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        cameras = self._get_cameras(**kwargs)
        colors = phong_shading(
            meshes=meshes, fragments=fragments, texels=meshes.sample_textures(fragments),
            lights=kwargs.get("lights", self.lights), cameras=cameras,
            materials=kwargs.get("materials", self.materials),
        )
        return softmax_rgb_blend(
            colors, fragments, kwargs.get("blend_params", self.blend_params),
            znear=kwargs.get("znear", getattr(cameras, "znear", 1.0)),
            zfar=kwargs.get("zfar", getattr(cameras, "zfar", 100.0)),
        )


class HardGouraudShader(ShaderBase):
    """Per-vertex lighting, hard blending."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        cameras = self._get_cameras(**kwargs)
        pixel_colors = gouraud_shading(
            meshes=meshes, fragments=fragments, lights=kwargs.get("lights", self.lights),
            cameras=cameras, materials=kwargs.get("materials", self.materials),
        )
        return hard_rgb_blend(pixel_colors, fragments, kwargs.get("blend_params", self.blend_params))


class SoftSilhouetteShader:
    """Alpha-only silhouette via sigmoid blending."""

    def __init__(self, blend_params: Optional[BlendParams] = None):
        self.blend_params = blend_params if blend_params is not None else BlendParams()

    def __call__(self, fragments, meshes, **kwargs) -> torch.Tensor:
        return self.forward(fragments, meshes, **kwargs)

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        colors = torch.ones_like(fragments.bary_coords)
        return sigmoid_alpha_blend(colors, fragments, kwargs.get("blend_params", self.blend_params))
