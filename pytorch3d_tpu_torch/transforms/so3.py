"""SO(3) Lie group utilities (port of pytorch3d_tpu/transforms/so3.py).

Rotation matrices follow the row-vector convention used throughout the
package: points transform as ``x' = x @ R``.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from .math import acos_linear_extrapolation
from .rotation_conversions import axis_angle_to_matrix, matrix_to_axis_angle


def hat(v: torch.Tensor) -> torch.Tensor:
    """Hat operator: 3-vectors (..., 3) to skew matrices (..., 3, 3)."""
    if v.shape[-1] != 3:
        raise ValueError("Input vectors have to be 3-dimensional.")
    x, y, z = v.unbind(-1)
    zeros = torch.zeros_like(x)
    return torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1).reshape(v.shape[:-1] + (3, 3))


def hat_inv(h: torch.Tensor) -> torch.Tensor:
    """Inverse hat operator: skew matrices (..., 3, 3) to vectors (..., 3).

    As in the JAX package it reads the entries (2, 1), (0, 2) and (1, 0)
    and does not check that the input is skew (a check would sync the host).
    """
    if h.shape[-2:] != (3, 3):
        raise ValueError("Input has to be a batch of 3x3 Tensors.")
    return torch.stack((h[..., 2, 1], h[..., 0, 2], h[..., 1, 0]), dim=-1)


def so3_rotation_angle(
    R: torch.Tensor, eps: float = 1e-4, cos_angle: bool = False, cos_bound: float = 1e-4
) -> torch.Tensor:
    """Rotation angle of matrices, acos(0.5 (trace - 1)).

    ``cos_bound > 0`` extrapolates acos linearly near +-1, so values and
    gradients stay finite near 0 and pi.
    """
    if R.shape[-2:] != (3, 3):
        raise ValueError("Input has to be a batch of 3x3 Tensors.")
    phi_cos = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    if cos_bound > 0.0:
        bound = 1.0 - cos_bound
        return acos_linear_extrapolation(phi_cos, (-bound, bound))
    return torch.arccos(torch.clamp(phi_cos, -1.0, 1.0))


def so3_relative_angle(
    R1: torch.Tensor, R2: torch.Tensor, cos_angle: bool = False, cos_bound: float = 1e-4, eps: float = 1e-4
) -> torch.Tensor:
    """Geodesic angle between pairs of rotations: the angle of R1 @ R2^T."""
    R12 = torch.matmul(R1, R2.transpose(-1, -2))
    return so3_rotation_angle(R12, cos_angle=cos_angle, cos_bound=cos_bound, eps=eps)


def _so3_exp_map(
    log_rot: torch.Tensor, eps: float = 0.0001
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exp map plus the intermediates se3_exp_map reuses: (R, angles
    sqrt(max(|w|^2, eps)), hat(w), hat(w)^2)."""
    if log_rot.shape[-1] != 3:
        raise ValueError("Input tensor shape has to be Nx3.")
    nrms = torch.sum(log_rot * log_rot, dim=-1)
    rot_angles = torch.sqrt(torch.clamp(nrms, min=eps))
    skews = hat(log_rot)
    return axis_angle_to_matrix(log_rot), rot_angles, skews, torch.matmul(skews, skews)


def so3_exp_map(log_rot: torch.Tensor, eps: float = 0.0001) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues' formula)."""
    return _so3_exp_map(log_rot, eps=eps)[0]


def so3_exponential_map(log_rot: torch.Tensor, eps: float = 0.0001) -> torch.Tensor:
    """Deprecated alias of so3_exp_map."""
    warnings.warn("so3_exponential_map is deprecated, use so3_exp_map instead.", PendingDeprecationWarning)
    return so3_exp_map(log_rot, eps)


def so3_log_map(R: torch.Tensor, eps: float = 0.0001, cos_bound: float = 1e-4) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) through the quaternion
    (`matrix_to_axis_angle`), whose gradient is finite at the identity."""
    if R.shape[-2:] != (3, 3):
        raise ValueError("Input has to be a batch of 3x3 Tensors.")
    return matrix_to_axis_angle(R)
