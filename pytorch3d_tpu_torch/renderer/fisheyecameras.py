"""Fisheye camera with radial, tangential and thin-prism distortion (port of
pytorch3d_tpu/renderer/fisheyecameras.py).

Equidistant model with polynomial distortion (the OpenCV / Project Aria
convention): for a view point (x, y, z), ab = (x, y) / z, r = |ab| and
theta = atan(r),

    th_d = theta (1 + k0 th^2 + ... + k5 th^12)          # radial
    [u, v] = th_d ab / r
    [u, v] += tangential + thin-prism terms (if enabled)
    projected = f [u, v] + principal_point

The projection is not linear, so `get_projection_transform` raises and
`MeshRasterizer` takes `transform_points` with an identity NDC transform.
`unproject_points` undoes the tangential and thin-prism terms by 4
fixed-point steps, then inverts the radial polynomial by 8 Newton steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..common import DEFAULT_DEVICE
from .cameras import CamerasBase, _extrinsics, get_world_to_view_transform

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class FishEyeCameras(CamerasBase):
    R: torch.Tensor  # (N, 3, 3)
    T: torch.Tensor  # (N, 3)
    focal_length: torch.Tensor  # (N, 1)
    principal_point: torch.Tensor  # (N, 2)
    radial_params: torch.Tensor  # (N, 6)
    tangential_params: torch.Tensor  # (N, 2)
    thin_prism_params: torch.Tensor  # (N, 4)
    use_radial: bool = True
    use_tangential: bool = True
    use_thin_prism: bool = True
    world_coordinates: bool = False

    @classmethod
    def create(
        cls,
        focal_length=1.0,
        principal_point=((0.0, 0.0),),
        radial_params=((0.0,) * 6,),
        tangential_params=((0.0, 0.0),),
        thin_prism_params=((0.0,) * 4,),
        R: Optional[torch.Tensor] = None,
        T: Optional[torch.Tensor] = None,
        world_coordinates: bool = False,
        use_radial: bool = True,
        use_tangential: bool = True,
        use_thin_prism: bool = True,
        device: Device = DEFAULT_DEVICE,
    ) -> "FishEyeCameras":
        R, T = _extrinsics(R, T, device)
        N = max(R.shape[0], torch.as_tensor(focal_length).reshape(-1).shape[0])

        def batch(x, d):
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            if x.ndim == 0:
                x = x.reshape(1, 1)
            if x.ndim == 1:
                x = x[None] if x.shape[0] == d else x[:, None]
            return x.expand(N, d)

        return cls(
            R=R.expand(N, 3, 3), T=T.expand(N, 3),
            focal_length=batch(focal_length, 1), principal_point=batch(principal_point, 2),
            radial_params=batch(radial_params, 6), tangential_params=batch(tangential_params, 2),
            thin_prism_params=batch(thin_prism_params, 4),
            use_radial=use_radial, use_tangential=use_tangential, use_thin_prism=use_thin_prism,
            world_coordinates=world_coordinates,
        )

    def _distort(self, xr_yr: torch.Tensor) -> torch.Tensor:
        """The tangential and thin-prism terms added at xr_yr (N, P, 2)."""
        x, y = xr_yr[..., 0], xr_yr[..., 1]
        r2 = x * x + y * y
        delta = torch.zeros_like(xr_yr)
        if self.use_tangential:
            p0 = self.tangential_params[..., None, 0]
            p1 = self.tangential_params[..., None, 1]
            delta = delta + torch.stack(
                [(r2 + 2.0 * x * x) * p0 + 2.0 * x * y * p1, (r2 + 2.0 * y * y) * p1 + 2.0 * x * y * p0], dim=-1
            )
        if self.use_thin_prism:
            s = self.thin_prism_params[:, None, :]
            r4 = r2 * r2
            delta = delta + torch.stack([s[..., 0] * r2 + s[..., 1] * r4, s[..., 2] * r2 + s[..., 3] * r4], dim=-1)
        return delta

    def transform_points(self, points: torch.Tensor, eps: Optional[float] = None, **kwargs) -> torch.Tensor:
        """Project world (with `world_coordinates` or `from_world=True`) or
        view points (N, P, 3) to image coordinates (x, y, 1): the base
        coordinates are xy / z, so `use_radial=False` is a pinhole model;
        the tangential and thin-prism terms are taken at the radially
        distorted coordinates."""
        if points.ndim == 2:
            points = points[None]
        if self.world_coordinates or kwargs.get("from_world", False):
            points = get_world_to_view_transform(self.R, self.T).transform_points(points)
        eps = eps or 1e-9
        z = points[..., 2:]
        ab = points[..., :2] / torch.where(z.abs() > eps, z, eps)
        r = torch.sqrt(torch.sum(ab * ab, dim=-1))
        theta = torch.arctan(r)
        th2 = theta * theta
        th_pow = torch.stack([th2 ** (i + 1) for i in range(6)], dim=-1)  # theta^2 .. theta^12
        th_radial = 1.0 + torch.sum(self.radial_params[:, None, :] * th_pow, dim=-1)
        # theta / r with its r -> 0 limit of 1
        th_divr = torch.where(r > eps, theta / torch.clamp(r, min=eps), 1.0)
        xr_yr = (th_radial * th_divr)[..., None] * ab
        uv = (xr_yr if self.use_radial else ab) + self._distort(xr_yr)
        xy = self.focal_length[:, None, :] * uv + self.principal_point[:, None, :]
        return torch.cat([xy, torch.ones_like(z)], dim=-1)

    def unproject_points(self, xy_depth: torch.Tensor, world_coordinates: bool = True, **kwargs) -> torch.Tensor:
        """Image coordinates with view depth (N, P, 3) back to world (or
        view) points."""
        if xy_depth.ndim == 2:
            xy_depth = xy_depth[None]
        uv = (xy_depth[..., :2] - self.principal_point[:, None, :]) / self.focal_length[:, None, :]
        # undo the tangential and thin-prism terms by fixed-point steps
        xr_yr = uv
        for _ in range(4 if (self.use_tangential or self.use_thin_prism) else 0):
            xr_yr = uv - self._distort(xr_yr)
        th_d = torch.linalg.norm(xr_yr, dim=-1)
        # invert th_d = theta (1 + sum k_i theta^{2i+2}) by Newton steps
        theta = th_d
        if self.use_radial:
            k = self.radial_params[:, None, :]
            for _ in range(8):
                th2 = theta * theta
                poly, dpoly, p = 1.0, 0.0, th2
                for j in range(6):
                    poly = poly + k[..., j] * p
                    dpoly = dpoly + (2 * j + 2) * k[..., j] * p / torch.clamp(theta, min=1e-9)
                    p = p * th2
                theta = theta - (theta * poly - th_d) / torch.clamp(poly + theta * dpoly, min=1e-9)
        # direction: tan(theta) in xy over unit z
        xy_dir = xr_yr / torch.clamp(th_d, min=1e-9)[..., None] * torch.tan(theta)[..., None]
        depth = xy_depth[..., 2:]
        points_view = torch.cat([xy_dir * depth, depth], dim=-1)
        if world_coordinates or self.world_coordinates:
            return get_world_to_view_transform(self.R, self.T).inverse().transform_points(points_view)
        return points_view

    def in_ndc(self) -> bool:
        return False

    def is_perspective(self) -> bool:
        return False
