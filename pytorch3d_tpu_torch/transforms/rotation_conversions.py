"""Rotation representation conversions
(port of pytorch3d_tpu/transforms/rotation_conversions.py).

Quaternions are real-part-first ``(w, x, y, z)``; euler conventions are
strings of axis letters composed as ``R = R(c0) @ R(c1) @ R(c2)``.  Every
function is batched over leading dims and keeps the JAX package's
gradient-safe branches (safe substitutes under `torch.where`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..common import DEFAULT_DEVICE


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x <= 0."""
    positive = x > 0
    safe_x = torch.where(positive, x, 1.0)
    return torch.where(positive, torch.sqrt(safe_x), 0.0)


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Magnitudes of ``a`` with the signs of ``b`` (sign(0) treated as +)."""
    return torch.where(b < 0, -a.abs(), a.abs())


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Convert quaternions (..., 4), real part first, to matrices (..., 3, 3)."""
    r, i, j, k = torch.unbind(quaternions, -1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Convert rotation matrices (..., 3, 3) to quaternions (..., 4), w first,
    by the four-candidate construction (the candidate with the largest
    denominator is taken)."""
    batch_dim = matrix.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(matrix.reshape(batch_dim + (9,)), -1)
    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    # Denominators clipped away from zero for gradient safety; the selected
    # candidate's is >= 0.5 for a valid rotation.
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    onehot = torch.nn.functional.one_hot(q_abs.argmax(dim=-1), 4).to(matrix.dtype)
    out = torch.sum(quat_candidates * onehot[..., None], dim=-2)
    return standardize_quaternion(out)


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip quaternions so the real part is non-negative."""
    return torch.where(quaternions[..., 0:1] < 0, -quaternions, quaternions)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two quaternion tensors (..., 4)."""
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack([ow, ox, oy, oz], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quaternion product, standardized to non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    """Inverse (conjugate) of unit quaternions."""
    return quaternion * quaternion.new_tensor([1, -1, -1, -1])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., 3) by unit quaternions (..., 4)."""
    if point.shape[-1] != 3:
        raise ValueError(f"Points are not in 3D, {point.shape}.")
    real_parts = point.new_zeros(point.shape[:-1] + (1,))
    point_as_quaternion = torch.cat([real_parts, point], dim=-1)
    out = quaternion_raw_multiply(
        quaternion_raw_multiply(quaternion, point_as_quaternion),
        quaternion_invert(quaternion),
    )
    return out[..., 1:]


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about a named axis ('X' | 'Y' | 'Z')."""
    cos = torch.cos(angle)
    sin = torch.sin(angle)
    one = torch.ones_like(angle)
    zero = torch.zeros_like(angle)

    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError("letter must be either X, Y or Z.")

    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3:
        raise ValueError("Convention must have 3 letters.")
    if convention[1] in (convention[0], convention[2]):
        raise ValueError(f"Invalid convention {convention}.")
    for letter in convention:
        if letter not in ("X", "Y", "Z"):
            raise ValueError(f"Invalid letter {letter} in convention string.")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Euler angles (..., 3) in radians to matrices, given e.g. "XYZ"."""
    if euler_angles.ndim == 0 or euler_angles.shape[-1] != 3:
        raise ValueError("Invalid input euler angles.")
    _check_convention(convention)
    matrices = [_axis_angle_rotation(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return matrices[0] @ matrices[1] @ matrices[2]


def _index_from_letter(letter: str) -> int:
    if letter not in ("X", "Y", "Z"):
        raise ValueError("letter must be either X, Y or Z.")
    return "XYZ".index(letter)


def _angle_from_tan(
    axis: str, other_axis: str, data: torch.Tensor, horizontal: bool, tait_bryan: bool
) -> torch.Tensor:
    """The first or third euler angle from a matrix slice, by atan2."""
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """Matrices (..., 3, 3) to euler angles (..., 3) for the given convention."""
    _check_convention(convention)
    if matrix.ndim < 2 or matrix.shape[-2:] != (3, 3):
        raise ValueError(f"Invalid rotation matrix shape {matrix.shape}.")
    i0 = _index_from_letter(convention[0])
    i2 = _index_from_letter(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in [-1, 2] else 1.0
        central_angle = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central_angle = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central_angle,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


def random_quaternions(
    n: int, generator: Optional[torch.Generator] = None, dtype=torch.float32, device=None
) -> torch.Tensor:
    """n random unit quaternions with non-negative real part, drawn from
    `generator` (a fresh one seeded 0 when None, as the JAX package's
    default key).  They lie on `device`: by default the generator's, or
    `DEFAULT_DEVICE` when no generator is given."""
    if generator is None:
        generator = torch.Generator(device=DEFAULT_DEVICE if device is None else device).manual_seed(0)
    o = torch.randn((n, 4), generator=generator, dtype=dtype, device=generator.device)
    s = torch.sum(o * o, dim=1, keepdim=True)
    q = o / _copysign(torch.sqrt(s), o[:, 0:1])
    return q if device is None else q.to(device)


def random_rotations(
    n: int, generator: Optional[torch.Generator] = None, dtype=torch.float32, device=None
) -> torch.Tensor:
    """n uniformly random rotation matrices (n, 3, 3)."""
    return quaternion_to_matrix(random_quaternions(n, generator, dtype, device))


def random_rotation(generator: Optional[torch.Generator] = None, dtype=torch.float32, device=None) -> torch.Tensor:
    """A single random rotation matrix (3, 3)."""
    return random_rotations(1, generator, dtype, device)[0]


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) to quaternions (..., 4), w first, with a
    Taylor expansion of sin(x/2)/x near zero."""
    angles2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small_angles = angles2 < 1e-12
    angles = torch.sqrt(torch.where(small_angles, 1.0, angles2))
    half_angles = angles * 0.5
    sin_half_angles_over_angles = torch.where(small_angles, 0.5 - angles2 / 48.0, torch.sin(half_angles) / angles)
    cos_half = torch.where(small_angles, 1.0 - angles2 / 8.0, torch.cos(half_angles))
    return torch.cat([cos_half, axis_angle * sin_half_angles_over_angles], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4), w first, to axis-angle vectors (..., 3)."""
    norms2 = torch.sum(quaternions[..., 1:] * quaternions[..., 1:], dim=-1, keepdim=True)
    small = norms2 < 1e-12
    norms = torch.sqrt(torch.where(small, 1.0, norms2))
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    sin_half_angles_over_angles = torch.where(small, 0.5 - (angles * angles) / 48.0, torch.sin(half_angles) / angles)
    out = quaternions[..., 1:] / sin_half_angles_over_angles
    return torch.where(small, quaternions[..., 1:] * 2.0, out)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) to rotation matrices by Rodrigues' formula,
    R = I + sin(t) K + (1 - cos t) K^2 with K = hat(axis), with series
    fallbacks of sin(t)/t and (1 - cos t)/t^2 near t = 0."""
    theta2 = torch.sum(axis_angle * axis_angle, dim=-1)
    small = theta2 < 1e-10
    safe_theta2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe_theta2)
    sin_over = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    one_minus_cos_over2 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    x, y, z = torch.unbind(axis_angle, -1)
    zeros = torch.zeros_like(x)
    K = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1).reshape(axis_angle.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + sin_over[..., None, None] * K + one_minus_cos_over2[..., None, None] * (K @ K)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) to axis-angle vectors (..., 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation (Zhou et al., CVPR 2019) to matrices: the
    two 3-vectors Gram-Schmidt-orthonormalised into the first two rows, the
    third row their cross product."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Matrices (..., 3, 3) to the 6D representation (first two rows)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))
