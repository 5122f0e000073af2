"""Batched cameras (port of pytorch3d_tpu/renderer/cameras.py).

Conventions are the JAX package's: world, view and NDC spaces are
right-handed with +X left, +Y up, +Z into the screen; points are row
vectors (``x_out = x @ M`` via `Transform3d`).

The base class (NDC and screen projections, batch indexing, `clone` and
`to`), `FoVPerspectiveCameras`, `FoVOrthographicCameras`, the SfM-style
`PerspectiveCameras` and `OrthographicCameras`, `look_at_view_transform`,
the NDC <-> screen transforms and `try_get_projection_transform`
(`FishEyeCameras` is in fisheyecameras.py).  Cameras are plain
dataclasses holding tensors; `create` builds one on a device (CUDA unless
the caller names another) and `replace` swaps fields.
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

    @property
    def dtype(self) -> torch.dtype:
        return self.R.dtype

    def replace(self, **changes):
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)

    def _map_tensors(self, fn):
        """A copy with `fn` applied to every tensor field (the flags stay)."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))
        })

    def __getitem__(self, index):
        """The cameras at `index` (an int, a list, a slice or an index
        tensor), every tensor field indexed along its batch dimension; an
        int keeps that dimension.  An int out of range raises IndexError."""
        n = len(self)
        if isinstance(index, int):
            index = [index]
        if isinstance(index, (list, tuple)):
            if any(isinstance(i, int) and not -n <= i < n for i in index):
                raise IndexError(f"index {index} out of range for batch size {n}")
            index = torch.as_tensor(index, dtype=torch.int64, device=self.device)
        return self._map_tensors(lambda t: t[index])

    def clone(self):
        return self._map_tensors(torch.clone)

    def to(self, device: Device):
        return self._map_tensors(lambda t: t.to(device))

    def get_znear(self):
        return getattr(self, "znear", None)

    def get_principal_point(self, **kwargs) -> Optional[torch.Tensor]:
        return kwargs.get("principal_point", getattr(self, "principal_point", None))

    def get_world_to_view_transform(self, **kwargs) -> Transform3d:
        return get_world_to_view_transform(
            R=kwargs.get("R", self.R), T=kwargs.get("T", self.T)
        )

    def get_camera_center(self, **kwargs) -> torch.Tensor:
        w2v = self.get_world_to_view_transform(**kwargs)
        return w2v.inverse().get_matrix()[:, 3, :3]

    def get_projection_transform(self, **kwargs) -> Transform3d:
        raise NotImplementedError

    def unproject_points(self, xy_depth: torch.Tensor, **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def is_perspective(self) -> bool:
        raise NotImplementedError

    def in_ndc(self) -> bool:
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

    def transform_points_ndc(
        self, points: torch.Tensor, eps: Optional[float] = None, **kwargs
    ) -> torch.Tensor:
        world_to_ndc = self.get_full_projection_transform(**kwargs)
        if not self.in_ndc():
            world_to_ndc = world_to_ndc.compose(self.get_ndc_camera_transform(**kwargs))
        return world_to_ndc.transform_points(points, eps=eps)

    def transform_points_screen(
        self, points: torch.Tensor, eps: Optional[float] = None, with_xyflip: bool = True, **kwargs
    ) -> torch.Tensor:
        points_ndc = self.transform_points_ndc(points, eps=eps, **kwargs)
        image_size = kwargs.get("image_size", self.get_image_size())
        return get_ndc_to_screen_transform(
            self, with_xyflip=with_xyflip, image_size=image_size
        ).transform_points(points_ndc, eps=eps)

    def get_image_size(self):
        return getattr(self, "image_size", None)



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

    def unproject_points(
        self,
        xy_depth: torch.Tensor,
        world_coordinates: bool = True,
        scaled_depth_input: bool = False,
        **kwargs,
    ) -> torch.Tensor:
        """(N, P, 3) NDC x, y with view depth (or NDC z when
        `scaled_depth_input`) back to world (or view) coordinates; view depth
        z maps to NDC z = f/(f-n) - f*n/((f-n)*z)."""
        if world_coordinates:
            to_cam = self.get_full_projection_transform(**kwargs)
        else:
            to_cam = self.get_projection_transform(**kwargs)
        if not scaled_depth_input:
            znear = kwargs.get("znear", self.znear)[:, None, None]
            zfar = kwargs.get("zfar", self.zfar)[:, None, None]
            z = xy_depth[..., 2:]
            sdepth = (zfar / (zfar - znear)) - (zfar * znear) / ((zfar - znear) * z)
            xy_depth = torch.cat([xy_depth[..., :2], sdepth], dim=-1)
        return to_cam.inverse().transform_points(xy_depth)

    def is_perspective(self) -> bool:
        return True

    def in_ndc(self) -> bool:
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


def _sfm_calibration_matrix(
    focal_length: torch.Tensor, principal_point: torch.Tensor, orthographic: bool
) -> torch.Tensor:
    """(N, 4, 4) column-convention intrinsics of an SfM camera: x_ndc =
    fx X / Z + px (perspective, depth in z) or fx X + px (orthographic)."""
    if focal_length.ndim == 2 and focal_length.shape[1] == 2:
        fx, fy = focal_length[:, 0], focal_length[:, 1]
    else:
        fx = fy = focal_length.reshape(-1)
    px, py = principal_point[:, 0], principal_point[:, 1]
    zero, one = torch.zeros_like(px), torch.ones_like(px)
    if orthographic:
        rows = [[fx, zero, zero, px], [zero, fy, zero, py], [zero, zero, one, zero], [zero, zero, zero, one]]
    else:
        rows = [[fx, zero, px, zero], [zero, fy, py, zero], [zero, zero, zero, one], [zero, zero, one, zero]]
    return _rows_to_matrix(rows)


class _SfMCameraMixin(CamerasBase):
    """What `PerspectiveCameras` and `OrthographicCameras` share: focal
    length and principal point in NDC (or screen space with
    `in_ndc=False` and an image size), the calibration matrix, the
    screen-to-NDC fix and the analytic unprojection."""

    _orthographic = False

    @classmethod
    def create(
        cls,
        focal_length=1.0,
        principal_point=((0.0, 0.0),),
        R: Optional[torch.Tensor] = None,
        T: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        image_size=None,
        in_ndc: bool = True,
        device: Device = DEFAULT_DEVICE,
    ):
        R, T, fl, pp = _broadcast_batch(
            *_extrinsics(R, T, device),
            _to_batch(focal_length, device, last_dim=2), _to_batch(principal_point, device, last_dim=2),
        )
        img = None
        if image_size is not None:
            img = _to_batch(image_size, device, last_dim=2).expand(R.shape[0], 2)
        if K is not None:
            K = torch.as_tensor(K, dtype=torch.float32, device=device)
        return cls(R=R, T=T, focal_length=fl, principal_point=pp, image_size=img, K=K, in_ndc_space=in_ndc)

    def in_ndc(self) -> bool:
        return self.in_ndc_space

    def is_perspective(self) -> bool:
        return not self._orthographic

    def get_projection_transform(self, **kwargs) -> Transform3d:
        K = kwargs.get("K", self.K)
        if K is None:
            K = _sfm_calibration_matrix(
                _to_batch(kwargs.get("focal_length", self.focal_length), self.device, last_dim=2),
                kwargs.get("principal_point", self.principal_point),
                self._orthographic,
            )
        return Transform3d(K.transpose(-1, -2))

    def get_ndc_camera_transform(self, **kwargs) -> Transform3d:
        if self.in_ndc():
            return Transform3d.create(device=self.device)
        # Screen-space camera: undo the principal point (defined in image
        # space), then rescale to NDC.
        pp = kwargs.get("principal_point", self.principal_point)
        fix = torch.eye(4, device=self.device).repeat(len(self), 1, 1)
        fix[:, :2, 3] = -2.0 * pp
        image_size = kwargs.get("image_size", self.get_image_size())
        return Transform3d(fix.transpose(-1, -2)).compose(
            get_screen_to_ndc_transform(self, with_xyflip=False, image_size=image_size)
        )

    def unproject_points(
        self, xy_depth: torch.Tensor, world_coordinates: bool = True, from_ndc: bool = False, **kwargs
    ) -> torch.Tensor:
        """Projected x, y with view depth back to view (or world)
        coordinates, inverting the intrinsics analytically."""
        pts = xy_depth[None] if xy_depth.ndim == 2 else xy_depth
        if from_ndc:
            pts = self.get_ndc_camera_transform(**kwargs).inverse().transform_points(pts)
        fl = _to_batch(kwargs.get("focal_length", self.focal_length), self.device, last_dim=2)
        pp = kwargs.get("principal_point", self.principal_point)
        if fl.shape[-1] == 1:
            fl = torch.cat([fl, fl], dim=-1)
        xy = pts[..., :2] - pp[:, None, :]
        if self.is_perspective():
            xy = xy * pts[..., 2:]
        xy = xy / fl[:, None, :]
        cam_pts = torch.cat([xy, pts[..., 2:]], dim=-1)
        if world_coordinates:
            cam_pts = self.get_world_to_view_transform(**kwargs).inverse().transform_points(cam_pts)
        return cam_pts[0] if xy_depth.ndim == 2 else cam_pts


@dataclasses.dataclass(frozen=True)
class PerspectiveCameras(_SfMCameraMixin):
    """SfM-style perspective camera: x_ndc = fx X / Z + px, view depth
    passed through as z."""

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor  # (N, 2) or (N, 1)
    principal_point: torch.Tensor  # (N, 2)
    image_size: Optional[torch.Tensor] = None  # (N, 2) (height, width)
    K: Optional[torch.Tensor] = None
    in_ndc_space: bool = True


@dataclasses.dataclass(frozen=True)
class OrthographicCameras(_SfMCameraMixin):
    """SfM-style orthographic camera: x_ndc = fx X + px."""

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor
    principal_point: torch.Tensor
    image_size: Optional[torch.Tensor] = None
    K: Optional[torch.Tensor] = None
    in_ndc_space: bool = True

    _orthographic = True


def get_ndc_to_screen_transform(cameras, with_xyflip: bool = False, image_size=None) -> Transform3d:
    """NDC -> screen (+X right, +Y down, origin top-left)."""
    if image_size is None:
        raise ValueError(
            "For NDC to screen conversion, image_size=(height, width) needs to be specified."
        )
    image_size = torch.as_tensor(image_size, dtype=torch.float32, device=cameras.device).reshape(-1, 2)
    height, width = image_size[:, 0], image_size[:, 1]
    scale = image_size.amin(dim=1) / 2.0
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    K = _rows_to_matrix([
        [scale, zero, zero, -width / 2.0],
        [zero, scale, zero, -height / 2.0],
        [zero, zero, one, zero],
        [zero, zero, zero, one],
    ])
    transform = Transform3d(K.transpose(-1, -2))
    if with_xyflip:
        flip = torch.diag(torch.tensor([-1.0, -1.0, 1.0, 1.0], device=K.device)).expand(K.shape[0], 4, 4)
        transform = transform.compose(Transform3d(flip))
    return transform


def get_screen_to_ndc_transform(cameras, with_xyflip: bool = False, image_size=None) -> Transform3d:
    """Screen -> NDC, the inverse of `get_ndc_to_screen_transform`."""
    return get_ndc_to_screen_transform(cameras, with_xyflip=with_xyflip, image_size=image_size).inverse()


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


# The reference's legacy names for the FoV (OpenGL) and SfM cameras.
OpenGLPerspectiveCameras = FoVPerspectiveCameras
OpenGLOrthographicCameras = FoVOrthographicCameras
SfMPerspectiveCameras = PerspectiveCameras
SfMOrthographicCameras = OrthographicCameras
