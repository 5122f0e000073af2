"""MeshRasterizer and MeshRasterizerOpenGL: camera transform + rasterization
to Fragments (port of pytorch3d_tpu/renderer/mesh/rasterizer.py)."""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..cameras import OrthographicCameras, PerspectiveCameras, try_get_projection_transform
from ..utils import parse_image_size
from .rasterize_meshes import rasterize_meshes


@dataclasses.dataclass(frozen=True)
class Fragments:
    """Rasterizer outputs per pixel."""

    pix_to_face: torch.Tensor  # (N, H, W, K) packed face ids, -1 empty
    zbuf: torch.Tensor  # (N, H, W, K)
    bary_coords: torch.Tensor  # (N, H, W, K, 3)
    dists: Optional[torch.Tensor]  # (N, H, W, K) signed squared NDC distance; None from MeshRasterizerOpenGL


class RasterizationSettings(NamedTuple):
    """Rasterization configuration."""

    image_size: Union[int, Tuple[int, int]] = 256
    blur_radius: float = 0.0
    faces_per_pixel: int = 1
    bin_size: Optional[int] = None
    max_faces_per_bin: Optional[int] = None
    perspective_correct: Optional[bool] = None
    clip_barycentric_coords: Optional[bool] = None
    cull_backfaces: bool = False
    z_clip_value: Optional[float] = None
    cull_to_frustum: bool = False


class MeshRasterizer:
    """Rasterize world-space meshes with a camera."""

    def __init__(self, cameras=None, raster_settings: Optional[RasterizationSettings] = None):
        self.cameras = cameras
        self.raster_settings = raster_settings or RasterizationSettings()

    def transform(self, meshes_world, **kwargs):
        """World -> NDC-xy with view-space z kept in the z slot."""
        cameras = kwargs.get("cameras", self.cameras)
        if cameras is None:
            raise ValueError(
                "Cameras must be specified either at initialization or in the "
                "forward pass of MeshRasterizer"
            )
        verts_world = meshes_world.verts_padded()
        eps = kwargs.get("eps", None)
        verts_view = cameras.get_world_to_view_transform(**kwargs).transform_points(
            verts_world, eps=eps
        )
        to_ndc = cameras.get_ndc_camera_transform(**kwargs)
        projection = try_get_projection_transform(cameras, kwargs)
        if projection is not None:
            verts_ndc = projection.compose(to_ndc).transform_points(verts_view, eps=eps)
        else:
            verts_proj = cameras.transform_points(verts_world, eps=eps)
            verts_ndc = to_ndc.transform_points(verts_proj, eps=eps)
        # Keep view-space z for depth ordering.
        verts_ndc = torch.cat([verts_ndc[..., :2], verts_view[..., 2:3]], dim=-1)
        return meshes_world.update_padded(verts_ndc)

    def __call__(self, meshes_world, **kwargs) -> Fragments:
        return self.forward(meshes_world, **kwargs)

    def forward(self, meshes_world, **kwargs) -> Fragments:
        meshes_ndc = self.transform(meshes_world, **kwargs)
        raster_settings = kwargs.get("raster_settings", self.raster_settings)
        cameras = kwargs.get("cameras", self.cameras)

        perspective_correct = raster_settings.perspective_correct
        if perspective_correct is None:
            perspective_correct = cameras.is_perspective()
        clip_barycentric_coords = raster_settings.clip_barycentric_coords
        if clip_barycentric_coords is None:
            clip_barycentric_coords = raster_settings.blur_radius > 0.0

        pix_to_face, zbuf, bary, dists = rasterize_meshes(
            meshes_ndc,
            image_size=raster_settings.image_size,
            blur_radius=raster_settings.blur_radius,
            faces_per_pixel=raster_settings.faces_per_pixel,
            bin_size=raster_settings.bin_size,
            max_faces_per_bin=raster_settings.max_faces_per_bin,
            perspective_correct=perspective_correct,
            clip_barycentric_coords=clip_barycentric_coords,
            cull_backfaces=raster_settings.cull_backfaces,
            z_clip_value=raster_settings.z_clip_value,
            cull_to_frustum=raster_settings.cull_to_frustum,
        )
        return Fragments(pix_to_face=pix_to_face, zbuf=zbuf, bary_coords=bary, dists=dists)


class MeshRasterizerOpenGL(MeshRasterizer):
    """The hard serving rasterizer: K = 1, no blur, perspective-correct,
    not differentiable, `dists` None (the counterpart of the reference's
    OpenGL rasterizer, which it pairs with hard and splatter shading).

    On CUDA tensors the whole batch goes through the hard kernel
    (`rasterize_hard_cuda`) in one launch; on CPU tensors through its plain
    version.  The camera and setting checks raise and warn as the JAX
    package's do.
    """

    def forward(self, meshes_world, **kwargs) -> Fragments:
        from .rasterize_cuda import rasterize_hard_cuda

        rs = kwargs.get("raster_settings", self.raster_settings)
        cameras = kwargs.get("cameras", self.cameras)
        if cameras is None:
            raise ValueError(
                "Cameras must be specified either at initialization or in "
                "the forward pass of MeshRasterizerOpenGL"
            )
        if isinstance(cameras, (PerspectiveCameras, OrthographicCameras)):
            raise ValueError(
                "MeshRasterizerOpenGL only works with FoVPerspectiveCameras "
                "and FoVOrthographicCameras, which are OpenGL compatible."
            )
        if rs.faces_per_pixel > 1:
            warnings.warn("MeshRasterizerOpenGL currently works only with one face per pixel.")
        if rs.cull_backfaces:
            warnings.warn("MeshRasterizerOpenGL cannot cull backfaces yet, rasterizing without culling.")
        if rs.cull_to_frustum:
            warnings.warn("MeshRasterizerOpenGL cannot cull to frustum yet, rasterizing without culling.")
        if rs.z_clip_value is not None:
            raise NotImplementedError("MeshRasterizerOpenGL cannot do z-clipping yet.")
        if rs.perspective_correct is False:
            raise ValueError("MeshRasterizerOpenGL always uses perspective-correct interpolation.")

        meshes_ndc = self.transform(meshes_world, **kwargs)
        N, F = len(meshes_ndc), meshes_ndc.max_faces
        with torch.no_grad():
            face_verts = meshes_ndc.verts_packed()[meshes_ndc.faces_packed()].reshape(N, F, 3, 3).contiguous()
            mask = meshes_ndc.faces_packed_mask().reshape(N, F)
            pix, zbuf, bary = rasterize_hard_cuda(face_verts, mask, parse_image_size(rs.image_size))
            # packed face ids: mesh n's faces live at [n*F, (n+1)*F)
            offsets = (torch.arange(N, device=pix.device) * F)[:, None, None, None]
            pix_to_face = torch.where(pix >= 0, pix.long() + offsets, -1)
        return Fragments(pix_to_face=pix_to_face, zbuf=zbuf, bary_coords=bary, dists=None)
