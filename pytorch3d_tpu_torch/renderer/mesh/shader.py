"""Shaders (port of pytorch3d_tpu/renderer/mesh/shader.py): Phong, Gouraud
and flat lighting with hard or softmax blending, silhouette, depth and
splatter shaders."""

from __future__ import annotations

import warnings
from typing import Optional, Union

import torch

from ...common import DEFAULT_DEVICE
from ..blending import BlendParams, hard_rgb_blend, sigmoid_alpha_blend, softmax_rgb_blend
from ..lighting import PointLights
from ..materials import Materials
from .shading import flat_shading, gouraud_shading, phong_shading


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


class SoftGouraudShader(ShaderBase):
    """Per-vertex lighting, softmax blending."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        cameras = self._get_cameras(**kwargs)
        pixel_colors = gouraud_shading(
            meshes=meshes, fragments=fragments, lights=kwargs.get("lights", self.lights),
            cameras=cameras, materials=kwargs.get("materials", self.materials),
        )
        return softmax_rgb_blend(
            pixel_colors, fragments, kwargs.get("blend_params", self.blend_params),
            znear=kwargs.get("znear", getattr(cameras, "znear", 1.0)),
            zfar=kwargs.get("zfar", getattr(cameras, "zfar", 100.0)),
        )


class HardFlatShader(ShaderBase):
    """Per-face lighting, hard blending."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        cameras = self._get_cameras(**kwargs)
        colors = flat_shading(
            meshes=meshes, fragments=fragments, texels=meshes.sample_textures(fragments),
            lights=kwargs.get("lights", self.lights), cameras=cameras,
            materials=kwargs.get("materials", self.materials),
        )
        return hard_rgb_blend(colors, fragments, kwargs.get("blend_params", self.blend_params))


def _per_image_zfar(zfar, like: torch.Tensor) -> torch.Tensor:
    """zfar as (N, 1, 1, 1): a batched camera's (N,) must not broadcast
    into the image's channel axis."""
    zfar = torch.as_tensor(zfar, dtype=like.dtype, device=like.device)
    return zfar.reshape(-1, *([1] * (like.ndim - 1)))


class HardDepthShader(ShaderBase):
    """The closest face's depth (N, H, W, 1); background = zfar."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        cameras = self._get_cameras(**kwargs)
        zbuf = fragments.zbuf[..., 0:1]
        zfar = _per_image_zfar(kwargs.get("zfar", getattr(cameras, "zfar", 100.0)), zbuf)
        return torch.where(fragments.pix_to_face[..., 0:1] < 0, zfar, zbuf)


class SoftDepthShader(ShaderBase):
    """Sigmoid-weighted expected depth (N, H, W, 1), over zfar by coverage."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        cameras = self._get_cameras(**kwargs)
        blend_params = kwargs.get("blend_params", self.blend_params)
        mask = fragments.pix_to_face >= 0
        prob = torch.sigmoid(-fragments.dists / blend_params.sigma) * mask
        alpha = 1.0 - torch.prod(1.0 - prob, dim=-1, keepdim=True)
        weights = prob / torch.clamp(torch.sum(prob, dim=-1, keepdim=True), min=1e-10)
        depth = torch.sum(weights * fragments.zbuf, dim=-1, keepdim=True)
        bg = _per_image_zfar(kwargs.get("zfar", getattr(cameras, "zfar", 100.0)), depth)
        return depth * alpha + bg * (1.0 - alpha)


class SplatterPhongShader(ShaderBase):
    """Phong shading with splatter blending (`renderer/splatter_blend.py`):
    the screen positions are recomputed from the detached barycentrics and
    splatted, so the vertex gradient flows through them."""

    def forward(self, fragments, meshes, **kwargs) -> torch.Tensor:
        from ..splatter_blend import SplatterBlender, pixel_coords_screen_from_fragments

        cameras = self._get_cameras(**kwargs)
        colors = phong_shading(
            meshes=meshes, fragments=fragments, texels=meshes.sample_textures(fragments),
            lights=kwargs.get("lights", self.lights), cameras=cameras,
            materials=kwargs.get("materials", self.materials),
        )
        H, W = fragments.pix_to_face.shape[1:3]
        colors_a = torch.cat([colors[..., :3], torch.ones_like(colors[..., :1])], dim=-1)
        pixel_coords = pixel_coords_screen_from_fragments(fragments, meshes, cameras, (H, W))
        return SplatterBlender()(colors_a, pixel_coords, fragments, kwargs.get("blend_params", self.blend_params))


class TexturedSoftPhongShader(SoftPhongShader):
    """Deprecated alias of SoftPhongShader."""

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "TexturedSoftPhongShader is deprecated; use SoftPhongShader",
            PendingDeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)
