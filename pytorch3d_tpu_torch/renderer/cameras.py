"""Batched cameras (port of pytorch3d_tpu/renderer/cameras.py).

Conventions are the JAX package's: world, view and NDC spaces are
right-handed with +X left, +Y up, +Z into the screen; points are row
vectors (``x_out = x @ M`` via `Transform3d`).

Ported so far: the base class, `FoVPerspectiveCameras`,
`FoVOrthographicCameras`, `look_at_view_transform` and
`try_get_projection_transform`.  Cameras are
plain dataclasses holding tensors; `create` builds one on a device (CUDA
unless the caller names another) and `replace` swaps fields.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from ..common import DEFAULT_DEVICE
from ..transforms import Rotate, Transform3d, Translate

Device = Union[str, torch.device]


def _to_batch(x, device: Device, last_dim: Optional[int] = None) -> torch.Tensor:
    """A scalar / tuple / tensor as a batched float tensor (N, ...).

    A 1-D input with `last_dim` set is a batch of N scalars, not one vector.
    """
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if last_dim is None:
        return x[None] if x.ndim == 0 else x
    if x.ndim == 0:
        return x[None, None]
    if x.ndim == 1:
        return x[:, None]
    return x


def _broadcast_batch(*tensors):
    """Broadcast leading batch dims of a set of tensors to a common N."""
    N = max(t.shape[0] for t in tensors)
    out = []
    for t in tensors:
        if t.shape[0] == N:
            out.append(t)
        elif t.shape[0] == 1:
            out.append(t.expand((N,) + tuple(t.shape[1:])))
        else:
            raise ValueError("Incompatible batch sizes in camera args.")
    return out


def _extrinsics(R, T, device: Device):
    """R as (N, 3, 3) and T as (N, 3), the identity pose where None."""
    R = torch.as_tensor(R, dtype=torch.float32, device=device) if R is not None else torch.eye(3, device=device)[None]
    T = torch.as_tensor(T, dtype=torch.float32, device=device) if T is not None else torch.zeros((1, 3), device=device)
    return (R[None] if R.ndim == 2 else R), (T[None] if T.ndim == 1 else T)


def _rows_to_matrix(rows) -> torch.Tensor:
    """(N, 4, 4) from four rows of four (N,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def get_world_to_view_transform(R: torch.Tensor, T: torch.Tensor) -> Transform3d:
    """World -> view: X_view = X_world @ R + T."""
    if T.ndim != 2 or T.shape[1] != 3:
        raise ValueError(f"Expected T to have shape (N, 3); got {tuple(T.shape)}")
    if R.ndim != 3 or R.shape[1:] != (3, 3):
        raise ValueError(f"Expected R to have shape (N, 3, 3); got {tuple(R.shape)}")
    return Rotate(R, device=R.device).compose(Translate(T, device=T.device))


class CamerasBase:
    """Shared camera behaviour. Subclasses hold R (N, 3, 3), T (N, 3) and
    family-specific intrinsics."""

    def __len__(self) -> int:
        return self.R.shape[0]

    @property
    def device(self) -> torch.device:
        return self.R.device

    def replace(self, **changes):
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)

    def get_world_to_view_transform(self, **kwargs) -> Transform3d:
        return get_world_to_view_transform(
            R=kwargs.get("R", self.R), T=kwargs.get("T", self.T)
        )

    def get_camera_center(self, **kwargs) -> torch.Tensor:
        w2v = self.get_world_to_view_transform(**kwargs)
        return w2v.inverse().get_matrix()[:, 3, :3]

    def get_projection_transform(self, **kwargs) -> Transform3d:
        raise NotImplementedError

    def is_perspective(self) -> bool:
        raise NotImplementedError

    def get_full_projection_transform(self, **kwargs) -> Transform3d:
        w2v = self.get_world_to_view_transform(**kwargs)
        return w2v.compose(self.get_projection_transform(**kwargs))

    def get_ndc_camera_transform(self, **kwargs) -> Transform3d:
        """Projection space -> NDC space; identity for NDC-defined cameras."""
        return Transform3d.create(device=self.device)

    def transform_points(
        self, points: torch.Tensor, eps: Optional[float] = None, **kwargs
    ) -> torch.Tensor:
        return self.get_full_projection_transform(**kwargs).transform_points(points, eps=eps)



@dataclasses.dataclass(frozen=True)
class FoVPerspectiveCameras(CamerasBase):
    """OpenGL-style perspective camera.

    NDC z maps view-space depth to [0, 1] between znear and zfar; z sign is
    +1 (right-handed throughout, unlike OpenGL).
    """

    R: torch.Tensor
    T: torch.Tensor
    znear: torch.Tensor  # (N,)
    zfar: torch.Tensor  # (N,)
    fov: torch.Tensor  # (N,) in degrees unless degrees=False
    aspect_ratio: torch.Tensor  # (N,)
    degrees: bool = True
    K: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        znear=1.0,
        zfar=100.0,
        aspect_ratio=1.0,
        fov=60.0,
        degrees: bool = True,
        R: Optional[torch.Tensor] = None,
        T: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        device: Device = DEFAULT_DEVICE,
    ) -> "FoVPerspectiveCameras":
        R, T, znear, zfar, fov, aspect_ratio = _broadcast_batch(
            *_extrinsics(R, T, device),
            _to_batch(znear, device), _to_batch(zfar, device),
            _to_batch(fov, device), _to_batch(aspect_ratio, device),
        )
        if K is not None:
            K = torch.as_tensor(K, dtype=torch.float32, device=device)
        return cls(
            R=R, T=T, znear=znear, zfar=zfar, fov=fov,
            aspect_ratio=aspect_ratio, degrees=degrees, K=K,
        )

    def compute_projection_matrix(
        self, znear, zfar, fov, aspect_ratio, degrees: bool
    ) -> torch.Tensor:
        if degrees:
            fov = (math.pi / 180.0) * fov
        max_y = torch.tan(fov / 2.0) * znear
        max_x = max_y * aspect_ratio
        zero = torch.zeros_like(znear)
        one = torch.ones_like(znear)
        return _rows_to_matrix([
            [znear / max_x, zero, zero, zero],
            [zero, znear / max_y, zero, zero],
            [zero, zero, zfar / (zfar - znear), -(zfar * znear) / (zfar - znear)],
            [zero, zero, one, zero],
        ])

    def get_projection_transform(self, **kwargs) -> Transform3d:
        K = kwargs.get("K", self.K)
        if K is None:
            K = self.compute_projection_matrix(
                kwargs.get("znear", self.znear),
                kwargs.get("zfar", self.zfar),
                kwargs.get("fov", self.fov),
                kwargs.get("aspect_ratio", self.aspect_ratio),
                kwargs.get("degrees", self.degrees),
            )
        # Row-vector convention: transpose the column-convention K.
        return Transform3d(K.transpose(-1, -2))

    def is_perspective(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class FoVOrthographicCameras(CamerasBase):
    """OpenGL-style orthographic camera: the box [min_x, max_x] x
    [min_y, max_y] x [znear, zfar] of view space maps to NDC x, y in
    [-1, 1] (times scale_xyz) and z in [0, 1]."""

    R: torch.Tensor
    T: torch.Tensor
    znear: torch.Tensor  # (N,)
    zfar: torch.Tensor  # (N,)
    max_y: torch.Tensor  # (N,)
    min_y: torch.Tensor  # (N,)
    max_x: torch.Tensor  # (N,)
    min_x: torch.Tensor  # (N,)
    scale_xyz: torch.Tensor  # (N, 3)
    K: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        znear=1.0,
        zfar=100.0,
        max_y=1.0,
        min_y=-1.0,
        max_x=1.0,
        min_x=-1.0,
        scale_xyz=((1.0, 1.0, 1.0),),
        R: Optional[torch.Tensor] = None,
        T: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        device: Device = DEFAULT_DEVICE,
    ) -> "FoVOrthographicCameras":
        R, T, znear, zfar, max_y, min_y, max_x, min_x, scale_xyz = _broadcast_batch(
            *_extrinsics(R, T, device),
            *(_to_batch(a, device) for a in (znear, zfar, max_y, min_y, max_x, min_x)),
            _to_batch(scale_xyz, device, last_dim=3),
        )
        if K is not None:
            K = torch.as_tensor(K, dtype=torch.float32, device=device)
        return cls(
            R=R, T=T, znear=znear, zfar=zfar, max_y=max_y, min_y=min_y,
            max_x=max_x, min_x=min_x, scale_xyz=scale_xyz, K=K,
        )

    def compute_projection_matrix(
        self, znear, zfar, max_x, min_x, max_y, min_y, scale_xyz
    ) -> torch.Tensor:
        zero = torch.zeros_like(znear)
        one = torch.ones_like(znear)
        return _rows_to_matrix([
            [(2.0 / (max_x - min_x)) * scale_xyz[:, 0], zero, zero, -(max_x + min_x) / (max_x - min_x)],
            [zero, (2.0 / (max_y - min_y)) * scale_xyz[:, 1], zero, -(max_y + min_y) / (max_y - min_y)],
            [zero, zero, (1.0 / (zfar - znear)) * scale_xyz[:, 2], -znear / (zfar - znear)],
            [zero, zero, zero, one],
        ])

    def get_projection_transform(self, **kwargs) -> Transform3d:
        K = kwargs.get("K", self.K)
        if K is None:
            K = self.compute_projection_matrix(
                kwargs.get("znear", self.znear),
                kwargs.get("zfar", self.zfar),
                kwargs.get("max_x", self.max_x),
                kwargs.get("min_x", self.min_x),
                kwargs.get("max_y", self.max_y),
                kwargs.get("min_y", self.min_y),
                kwargs.get("scale_xyz", self.scale_xyz),
            )
        return Transform3d(K.transpose(-1, -2))

    def unproject_points(
        self,
        xy_depth: torch.Tensor,
        world_coordinates: bool = True,
        scaled_depth_input: bool = False,
        **kwargs,
    ) -> torch.Tensor:
        """(N, P, 3) NDC x, y with view depth (or NDC z when
        `scaled_depth_input`) back to world (or view) coordinates."""
        if world_coordinates:
            to_cam = self.get_full_projection_transform(**kwargs)
        else:
            to_cam = self.get_projection_transform(**kwargs)
        if not scaled_depth_input:
            znear = kwargs.get("znear", self.znear)[:, None, None]
            zfar = kwargs.get("zfar", self.zfar)[:, None, None]
            scale_z = kwargs.get("scale_xyz", self.scale_xyz)[:, None, 2:]
            sdepth = (xy_depth[..., 2:] * scale_z - znear) / (zfar - znear)
            xy_depth = torch.cat([xy_depth[..., :2], sdepth], dim=-1)
        return to_cam.inverse().transform_points(xy_depth)

    def is_perspective(self) -> bool:
        return False

    def in_ndc(self) -> bool:
        return True


def camera_position_from_spherical_angles(
    distance, elevation, azimuth, degrees: bool = True, device: Device = DEFAULT_DEVICE
) -> torch.Tensor:
    """Camera position on a sphere around the origin."""
    dist, elev, azim = _broadcast_batch(
        _to_batch(distance, device), _to_batch(elevation, device), _to_batch(azimuth, device)
    )
    if degrees:
        elev = elev * (math.pi / 180.0)
        azim = azim * (math.pi / 180.0)
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    return torch.stack([x, y, z], dim=1).reshape(-1, 3)


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def look_at_rotation(
    camera_position, at=((0, 0, 0),), up=((0, 1, 0),), device: Device = DEFAULT_DEVICE
) -> torch.Tensor:
    """World->view rotation for a camera looking at `at`."""
    camera_position, at, up = _broadcast_batch(
        _to_batch(camera_position, device, last_dim=3),
        _to_batch(at, device, last_dim=3),
        _to_batch(up, device, last_dim=3),
    )
    z_axis = _normalize(at - camera_position)
    x_axis = _normalize(torch.linalg.cross(up, z_axis))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))
    # up parallel to z: replace the degenerate x axis.
    is_close = torch.all(x_axis.abs() < 5e-3, dim=1, keepdim=True)
    replacement = _normalize(torch.linalg.cross(y_axis, z_axis))
    x_axis = torch.where(is_close, replacement, x_axis)
    R = torch.stack([x_axis, y_axis, z_axis], dim=1)  # rows
    return R.transpose(-1, -2)


def look_at_view_transform(
    dist=1.0,
    elev=0.0,
    azim=0.0,
    degrees: bool = True,
    eye=None,
    at=((0, 0, 0),),
    up=((0, 1, 0),),
    device: Device = DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, T) for a camera orbiting `at`."""
    at = _to_batch(at, device, last_dim=3)
    up = _to_batch(up, device, last_dim=3)
    if eye is not None:
        C, at, up = _broadcast_batch(_to_batch(eye, device, last_dim=3), at, up)
    else:
        C = camera_position_from_spherical_angles(dist, elev, azim, degrees, device=device)
        C, at, up = _broadcast_batch(C, at, up)
        C = C + at
    R = look_at_rotation(C, at, up, device=device)
    T = -torch.einsum("nij,nj->ni", R.transpose(-1, -2), C)
    return R, T


def try_get_projection_transform(cameras, cameras_kwargs) -> Optional[Transform3d]:
    """Projection transform if the camera is linear, else None."""
    try:
        return cameras.get_projection_transform(**cameras_kwargs)
    except NotImplementedError:
        return None
