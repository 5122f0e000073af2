"""MeshRenderer = rasterizer then shader (port of pytorch3d_tpu/renderer/mesh/renderer.py)."""

from __future__ import annotations

import torch


class MeshRenderer:
    """Compose a rasterizer and a shader into an image pipeline."""

    def __init__(self, rasterizer, shader):
        self.rasterizer = rasterizer
        self.shader = shader

    def __call__(self, meshes_world, **kwargs) -> torch.Tensor:
        return self.forward(meshes_world, **kwargs)

    def forward(self, meshes_world, **kwargs) -> torch.Tensor:
        fragments = self.rasterizer(meshes_world, **kwargs)
        return self.shader(fragments, meshes_world, **kwargs)



class MeshRendererWithFragments(MeshRenderer):
    """A MeshRenderer that also returns the rasterizer's Fragments."""

    def forward(self, meshes_world, **kwargs):
        fragments = self.rasterizer(meshes_world, **kwargs)
        return self.shader(fragments, meshes_world, **kwargs), fragments
