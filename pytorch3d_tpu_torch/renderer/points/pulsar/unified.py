"""PulsarPointsRenderer: pulsar behind the PyTorch3D cameras and
`Pointclouds` (port of pytorch3d_tpu/renderer/points/pulsar/unified.py).

Each camera converts to pulsar's 10-float layout [position (3), axis angle
(3), focal, sensor_width, principal point x and y in pixels], and each
cloud renders through `Renderer`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ....transforms.rotation_conversions import matrix_to_axis_angle
from ...cameras import FoVOrthographicCameras, FoVPerspectiveCameras
from .renderer import Renderer


def _pick(values: torch.Tensor, idx: int) -> torch.Tensor:
    """Entry idx of a batched camera field (..., last) flattened to rows,
    the last row for an index past the end."""
    rows = values.reshape(-1, values.shape[-1]) if values.ndim > 1 else values.reshape(-1, 1)
    return rows[min(idx, rows.shape[0] - 1)]


class PulsarPointsRenderer:
    """Renders `Pointclouds` seen by FoV / SfM perspective or orthographic
    cameras with pulsar (`rasterizer` supplies the cameras, image size and
    radius; pulsar composites itself, so `compositor` is unused)."""

    def __init__(
        self,
        rasterizer,
        compositor=None,
        n_channels: int = 3,
        max_num_spheres: int = int(1e6),
    ) -> None:
        self.rasterizer = rasterizer
        image_size = rasterizer.raster_settings.image_size
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        self._image_size = tuple(image_size)
        cameras = rasterizer.cameras
        self.renderer = Renderer(
            width=self._image_size[1],
            height=self._image_size[0],
            max_num_balls=max_num_spheres,
            orthogonal_projection=cameras is not None and not cameras.is_perspective(),
            n_channels=n_channels,
        )

    def _extract_extrinsics(self, cameras, idx: int):
        """PyTorch3D (R, T) to pulsar's camera centre and axis angle.

        PyTorch3D's view space is (+x left, +y up); pulsar's +x is right.
        A lone x flip is improper, so both x and y flip (a proper rotation,
        view y then points down) and `__call__` flips the image back."""
        D = cameras.R.new_tensor([-1.0, -1.0, 1.0])
        R = cameras.R[idx] * D[None, :]  # row-vector world -> view
        T = cameras.T[idx] * D
        C = -(T @ R.transpose(0, 1))  # the camera centre (flip-invariant)
        return C, matrix_to_axis_angle(R)

    def _extract_intrinsics(self, cameras, idx: int, znear):
        """(focal, sensor_width, ppx_px, ppy_px) of one camera."""
        H, W = self._image_size
        ppx = ppy = 0.0
        if isinstance(cameras, FoVPerspectiveCameras):
            fov = _pick(cameras.fov, idx)[0]
            if cameras.degrees:
                fov = fov * math.pi / 180.0
            focal = znear - 1e-6
            sensor = torch.tan(fov / 2.0) * 2.0 * focal
        elif isinstance(cameras, FoVOrthographicCameras):
            focal = 0.0
            sensor = float(cameras.max_x.reshape(-1)[0]) - float(cameras.min_x.reshape(-1)[0])
        else:  # PerspectiveCameras / OrthographicCameras (NDC focal length)
            f = _pick(cameras.focal_length, idx)[0]
            if cameras.is_perspective():
                focal = znear - 1e-6
                sensor = focal / f * 2.0
            else:
                focal = 0.0
                sensor = 2.0 / f
            if cameras.principal_point is not None:
                if not cameras.in_ndc():
                    raise ValueError("PulsarPointsRenderer requires NDC-space cameras.")
                # negated: the extrinsic conversion flipped view x and y
                pp = _pick(cameras.principal_point, idx)
                ppx = -float(pp[0]) * 0.5 * W
                ppy = -float(pp[1]) * 0.5 * H
        return focal, sensor, ppx, ppy

    def _cam_params(self, cameras, idx: int, znear):
        C, axis_angle = self._extract_extrinsics(cameras, idx)
        intrinsics = torch.stack([
            torch.as_tensor(v, dtype=C.dtype, device=C.device)
            for v in self._extract_intrinsics(cameras, idx, znear)
        ])
        return torch.cat([C, axis_angle, intrinsics])

    def __call__(
        self,
        point_clouds,
        gamma: Tuple[float, ...] = (1e-4,),
        znear=(0.1,),
        zfar=(100.0,),
        bg_col: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> torch.Tensor:
        """(N, H, W, C) images of the N clouds (cloud i with camera i,
        gamma[i], znear[i], zfar[i], each the last where the tuple is
        shorter)."""
        cameras = kwargs.get("cameras", self.rasterizer.cameras)
        if isinstance(znear, (int, float)):
            znear = (float(znear),)
        if isinstance(zfar, (int, float)):
            zfar = (float(zfar),)
        radius = self.rasterizer.raster_settings.radius
        n_cams = cameras.R.shape[0]
        counts = point_clouds.num_points_per_cloud().tolist()  # one host transfer for all clouds
        points = point_clouds.points_padded()
        feats = point_clouds.features_padded()
        images = []
        for i, n in enumerate(counts):
            pts = points[i, :n]
            cols = feats[i, :n] if feats is not None else torch.ones((n, 3), dtype=pts.dtype, device=pts.device)
            if isinstance(radius, (int, float)):
                rad = torch.full((n,), float(radius), dtype=pts.dtype, device=pts.device)
            else:
                rad = torch.as_tensor(radius, dtype=pts.dtype, device=pts.device)[:n]
            zn = znear[min(i, len(znear) - 1)]
            zf = zfar[min(i, len(zfar) - 1)]
            img = self.renderer(
                pts, cols, rad, self._cam_params(cameras, min(i, n_cams - 1), zn),
                gamma[min(i, len(gamma) - 1)], max_depth=zf, min_depth=zn, bg_col=bg_col,
                mode=kwargs.get("mode", 0),
            )
            # the extrinsic conversion renders with view y down: unflip
            images.append(torch.flip(img, (0,)))
        return torch.stack(images)
