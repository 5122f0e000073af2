"""Batched 3D transforms (port of pytorch3d_tpu/transforms/transform3d.py).

``Transform3d`` wraps a batch of 4x4 matrices in the row-vector convention
used throughout the package::

    [x' y' z' 1] = [x y z 1] @ M,    M = [[Rxx, Rxy, Rxz, 0],
                                          [Ryx, Ryy, Ryz, 0],
                                          [Rzx, Rzy, Rzz, 0],
                                          [Tx,  Ty,  Tz,  1]]

Composition is an eager matmul, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from ..common import DEFAULT_DEVICE
from .rotation_conversions import _axis_angle_rotation

Device = Union[str, torch.device]


def _broadcast_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matmul broadcasting batch dims of size 1 on either side."""
    if a.ndim == 2:
        a = a[None]
    if len(a) != len(b) and not (len(a) == 1 or len(b) == 1):
        raise ValueError(
            f"Expected batch dims to be broadcastable, got {len(a)}, {len(b)}."
        )
    return torch.matmul(a, b)


class Transform3d:
    """A batch of N 4x4 transform matrices (row-vector convention)."""

    def __init__(self, matrix: torch.Tensor):
        self.matrix = matrix  # (N, 4, 4)

    @classmethod
    def create(
        cls,
        matrix: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.float32,
        device: Device = DEFAULT_DEVICE,
    ) -> "Transform3d":
        """The identity when `matrix` is None, else a (4, 4)/(N, 4, 4) batch."""
        if matrix is None:
            return cls(torch.eye(4, dtype=dtype, device=device)[None])
        matrix = torch.as_tensor(matrix, dtype=dtype, device=device)
        if matrix.ndim not in (2, 3):
            raise ValueError('"matrix" has to be a 2- or a 3-dimensional tensor.')
        if matrix.shape[-2:] != (4, 4):
            raise ValueError(
                '"matrix" has to be a tensor of shape (minibatch, 4, 4) or (4, 4).'
            )
        if matrix.ndim == 2:
            matrix = matrix[None]
        return cls(matrix)

    def __len__(self) -> int:
        return self.matrix.shape[0]

    def __getitem__(self, index) -> "Transform3d":
        """The transforms at `index`; an int keeps the batch dimension."""
        if isinstance(index, int):
            index = slice(index, index + 1) if index != -1 else slice(-1, None)
        return Transform3d(self.matrix[index])

    @property
    def dtype(self) -> torch.dtype:
        return self.matrix.dtype

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    def get_matrix(self) -> torch.Tensor:
        """The (N, 4, 4) composed matrix."""
        return self.matrix

    def get_se3_log(self, eps: float = 1e-4, cos_bound: float = 1e-4) -> torch.Tensor:
        """The (N, 6) se(3) logarithm of the matrices."""
        from .se3 import se3_log_map

        return se3_log_map(self.matrix, eps=eps, cos_bound=cos_bound)

    def compose(self, *others: "Transform3d") -> "Transform3d":
        """Return self followed by each transform in ``others`` (left to right)."""
        m = self.matrix
        for other in others:
            m = _broadcast_bmm(m, other.matrix)
        return Transform3d(m)

    def inverse(self) -> "Transform3d":
        # inv_ex: as jnp.linalg.inv, a singular matrix gives non-finite
        # entries rather than an error, so a CUDA call needs no host sync.
        return Transform3d(torch.linalg.inv_ex(self.matrix).inverse)

    def stack(self, *others: "Transform3d") -> "Transform3d":
        """The batches of self and `others` concatenated."""
        return Transform3d(torch.cat([self.matrix] + [o.matrix for o in others], dim=0))

    def transform_points(
        self, points: torch.Tensor, eps: Optional[float] = None
    ) -> torch.Tensor:
        """Transform points of shape (P, 3) or (N, P, 3).

        ``eps`` clamps |w| of the homogeneous output away from zero
        (sign-preserving) before the perspective divide.
        """
        points_batch = points[None] if points.ndim == 2 else points
        if points_batch.ndim != 3 or points_batch.shape[-1] != 3:
            raise ValueError(
                f"Expected points of shape (P, 3) or (N, P, 3); got {tuple(points.shape)}."
            )
        ones = torch.ones_like(points_batch[..., :1])
        points_out = _broadcast_bmm(torch.cat([points_batch, ones], dim=2), self.matrix)
        denom = points_out[..., 3:]
        if eps is not None:
            sign = torch.where(denom >= 0.0, 1.0, -1.0)
            denom = sign * torch.clamp(denom.abs(), min=eps)
        points_out = points_out[..., :3] / denom
        if points.ndim == 2 and points_out.shape[0] == 1:
            points_out = points_out[0]
        return points_out

    def transform_normals(self, normals: torch.Tensor) -> torch.Tensor:
        """Transform normals (P, 3) or (N, P, 3) by the inverse transpose."""
        if normals.ndim not in (2, 3) or normals.shape[-1] != 3:
            raise ValueError(
                f"Expected normals of shape (P, 3) or (N, P, 3); got {tuple(normals.shape)}."
            )
        mat = torch.linalg.inv_ex(self.matrix[:, :3, :3]).inverse.transpose(1, 2)
        normals_batch = normals[None] if normals.ndim == 2 else normals
        normals_out = _broadcast_bmm(normals_batch, mat)
        if normals.ndim == 2 and normals_out.shape[0] == 1:
            normals_out = normals_out[0]
        return normals_out

    def translate(self, *args, **kwargs) -> "Transform3d":
        return self.compose(Translate(*args, dtype=self.dtype, device=self.device, **kwargs))

    def scale(self, *args, **kwargs) -> "Transform3d":
        return self.compose(Scale(*args, dtype=self.dtype, device=self.device, **kwargs))

    def rotate(self, *args, **kwargs) -> "Transform3d":
        return self.compose(Rotate(*args, dtype=self.dtype, device=self.device, **kwargs))

    def rotate_axis_angle(self, *args, **kwargs) -> "Transform3d":
        return self.compose(
            RotateAxisAngle(*args, dtype=self.dtype, device=self.device, **kwargs)
        )

    def clone(self) -> "Transform3d":
        return Transform3d(self.matrix.clone())

    def to(self, device: Optional[Device] = None, dtype: Optional[torch.dtype] = None) -> "Transform3d":
        return Transform3d(self.matrix.to(device=device, dtype=dtype))

    def cpu(self) -> "Transform3d":
        return self.to("cpu")


def _handle_coord(c, dtype, device) -> torch.Tensor:
    c = torch.as_tensor(c, dtype=dtype, device=device)
    return c.reshape(1) if c.ndim == 0 else c


def _handle_input(x, y, z, dtype, device, name: str, allow_singleton: bool = False):
    """Normalize (x, y, z) constructor args to an (N, 3) tensor."""
    if not isinstance(x, (int, float)):
        x = torch.as_tensor(x)
        if x.ndim == 2:
            if x.shape[1] != 3:
                raise ValueError(f"Expected tensor of shape (N, 3); got {tuple(x.shape)} ({name})")
            if y is not None or z is not None:
                raise ValueError(f"Expected y and z to be None ({name})")
            return x.to(dtype=dtype, device=device)
    if allow_singleton and y is None and z is None:
        y = x
        z = x
    xyz = [_handle_coord(c, dtype, device) for c in (x, y, z)]
    sizes = [c.shape[0] for c in xyz]
    N = max(sizes)
    for c in xyz:
        if c.shape[0] not in (1, N):
            raise ValueError(f"Got non-broadcastable sizes {sizes} ({name})")
    return torch.stack([c.expand(N) for c in xyz], dim=1)


def Translate(x, y=None, z=None, dtype=torch.float32, device: Device = DEFAULT_DEVICE):
    """Translation transform from per-axis offsets or an (N, 3) tensor."""
    xyz = _handle_input(x, y, z, dtype, device, "Translate")
    mat = torch.eye(4, dtype=dtype, device=device).repeat(xyz.shape[0], 1, 1)
    mat[:, 3, :3] = xyz
    return Transform3d(mat)


def Scale(x, y=None, z=None, dtype=torch.float32, device: Device = DEFAULT_DEVICE):
    """Scale transform; a single scalar scales isotropically."""
    xyz = _handle_input(x, y, z, dtype, device, "scale", allow_singleton=True)
    ones = torch.ones_like(xyz[:, :1])
    return Transform3d(torch.diag_embed(torch.cat([xyz, ones], dim=1)))


def Rotate(R, dtype=torch.float32, device: Device = DEFAULT_DEVICE):
    """Rotation transform from (3, 3) or (N, 3, 3) row-vector matrices."""
    R = torch.as_tensor(R, dtype=dtype, device=device)
    if R.ndim == 2:
        R = R[None]
    if R.shape[-2:] != (3, 3):
        raise ValueError("R must have shape (3, 3) or (N, 3, 3)")
    mat = torch.eye(4, dtype=dtype, device=device).repeat(R.shape[0], 1, 1)
    mat[:, :3, :3] = R
    return Transform3d(mat)


def RotateAxisAngle(
    angle, axis: str = "X", degrees: bool = True, dtype=torch.float32,
    device: Device = DEFAULT_DEVICE,
):
    """Rotation about a named axis by batched angles.

    The axis rotation is transposed so that it rotates row-vector points
    counterclockwise about the axis.
    """
    axis = axis.upper()
    if axis not in ("X", "Y", "Z"):
        raise ValueError("Expected axis to be one of ['X', 'Y', 'Z']; got %s" % axis)
    angle = _handle_coord(angle, dtype, device)
    if degrees:
        angle = angle * (math.pi / 180.0)
    R = _axis_angle_rotation(axis, angle)
    return Rotate(R.transpose(-1, -2), dtype=dtype, device=device)
