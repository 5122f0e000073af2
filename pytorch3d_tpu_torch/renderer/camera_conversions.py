"""OpenCV <-> PyTorch3D camera conversions (port of
pytorch3d_tpu/renderer/camera_conversions.py).

OpenCV convention: x_screen ~ K [R_cv | t_cv] X_world (column vectors, +X
right, +Y down, +Z into the screen).  The package's: row vectors, +X left,
+Y up, view z positive.  `image_size` is (N, 2) as (height, width).  The
outputs lie on the inputs' device.  The axis flips are products, so
autograd reaches the inputs through them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..transforms import matrix_to_rotation_6d
from .cameras import PerspectiveCameras


def _flip(n: int, like: torch.Tensor) -> torch.Tensor:
    """(-1,) * n + (1,) * (3 - n) as a tensor like `like`."""
    return like.new_tensor([-1.0] * n + [1.0] * (3 - n))


def _screen_scale(image_size: torch.Tensor, dtype: torch.dtype):
    """(N, 1) half of the short side and (N, 2) the image centre (w, h)."""
    image_size_wh = image_size.flip(-1).to(dtype)
    return image_size_wh.amin(dim=1, keepdim=True) / 2.0, image_size_wh / 2.0


def cameras_from_opencv_projection(
    R: torch.Tensor,  # (N, 3, 3) OpenCV rotation
    tvec: torch.Tensor,  # (N, 3)
    camera_matrix: torch.Tensor,  # (N, 3, 3)
    image_size: torch.Tensor,  # (N, 2) (h, w)
) -> PerspectiveCameras:
    """OpenCV (R, t, K) -> NDC `PerspectiveCameras`."""
    focal_length = torch.stack([camera_matrix[:, 0, 0], camera_matrix[:, 1, 1]], dim=-1)
    principal_point = camera_matrix[:, :2, 2]
    scale, c0 = _screen_scale(image_size, R.dtype)
    # OpenCV's +x right / +y down against the package's +x left / +y up
    R_pytorch3d = R.transpose(1, 2) * _flip(2, R)
    T_pytorch3d = tvec * _flip(2, tvec)
    return PerspectiveCameras.create(
        R=R_pytorch3d, T=T_pytorch3d, focal_length=focal_length / scale,
        principal_point=-(principal_point - c0) / scale, device=R.device,
    )


def opencv_from_cameras_projection(
    cameras: PerspectiveCameras,
    image_size: torch.Tensor,  # (N, 2) (h, w)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NDC `PerspectiveCameras` -> OpenCV (R, tvec, camera_matrix)."""
    focal = cameras.focal_length
    if focal.shape[-1] == 1:
        focal = focal.expand(-1, 2)
    T_cv = cameras.T * _flip(2, cameras.T)
    R_cv = (cameras.R * _flip(2, cameras.R)).transpose(1, 2)
    scale, c0 = _screen_scale(image_size, cameras.R.dtype)
    principal_point = -cameras.principal_point * scale + c0
    focal_length = focal * scale
    zero = torch.zeros_like(focal_length[:, 0])
    one = torch.ones_like(zero)
    camera_matrix = torch.stack([
        torch.stack([focal_length[:, 0], zero, principal_point[:, 0]], dim=-1),
        torch.stack([zero, focal_length[:, 1], principal_point[:, 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=1)
    return R_cv, T_cv, camera_matrix


def pulsar_from_opencv_projection(
    R: torch.Tensor,  # (N, 3, 3)
    tvec: torch.Tensor,  # (N, 3) or (N, 3, 1)
    camera_matrix: torch.Tensor,  # (N, 3, 3)
    image_size: torch.Tensor,  # (N, 2) (height, width)
    znear: float = 0.1,
) -> torch.Tensor:
    """OpenCV camera parameters -> (N, 13) pulsar camera vectors: position
    (3), 6D rotation (6), focal length, sensor width, principal point
    offsets c_x, c_y in pixels.  Pulsar takes one focal length: fx and fy
    are averaged.  The image is vertically flipped against OpenCV's."""
    R = R.float()
    tvec = tvec.float()
    if tvec.ndim == 2:
        tvec = tvec[..., None]  # (N, 3, 1)
    camera_matrix = camera_matrix.float()
    image_size_wh = image_size.float().flip(-1)
    N = R.shape[0]
    f = (camera_matrix[:, 0, 0] + camera_matrix[:, 1, 1])[:, None] / 2.0
    image_w, image_h = image_size_wh[0, 0], image_size_wh[0, 1]
    focal_length = torch.full((N, 1), znear - 1e-5, dtype=torch.float32, device=R.device)
    sensor_width = focal_length / (f / image_w)
    cx = -(camera_matrix[:, 0, 2][:, None] - image_w / 2.0)
    cy = camera_matrix[:, 1, 2][:, None] - image_h / 2.0
    R_trans = R.transpose(1, 2)
    cam_pos = -torch.sum(R_trans * tvec[:, None, :, 0], dim=-1)  # -R^T t
    return torch.cat([cam_pos, matrix_to_rotation_6d(R_trans), focal_length, sensor_width, cx, cy], dim=1)


def pulsar_from_cameras_projection(cameras: PerspectiveCameras, image_size: torch.Tensor) -> torch.Tensor:
    """NDC `PerspectiveCameras` -> (N, 13) pulsar camera vectors."""
    R_cv, T_cv, K_cv = opencv_from_cameras_projection(cameras, image_size)
    return pulsar_from_opencv_projection(R_cv, T_cv, K_cv, image_size)
