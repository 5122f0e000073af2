"""SE(3) exp/log maps (port of pytorch3d_tpu/transforms/se3.py).

SE(3) matrices use the row-vector convention::

    [ R 0 ]
    [ T 1 ]

and the 6D log is ``[log_translation | log_rotation]``.
"""

from __future__ import annotations

import torch

from .so3 import _so3_exp_map, hat, so3_log_map


def _se3_V_matrix(
    log_rotation: torch.Tensor,
    log_rotation_hat: torch.Tensor,
    log_rotation_hat_square: torch.Tensor,
    rotation_angles: torch.Tensor,
    eps: float = 1e-4,
) -> torch.Tensor:
    """The left Jacobian V = I + A hat + B hat^2 with A = (1 - cos t)/t^2
    and B = (t - sin t)/t^3, at t = sqrt(max(|w|^2, eps)) >= 0.01: in
    float32 B loses ~0.5 % to cancellation at t = 0.01, as in the JAX
    package."""
    theta = rotation_angles
    theta2 = theta * theta
    A = (1.0 - torch.cos(theta)) / theta2
    B = (theta - torch.sin(theta)) / (theta2 * theta)
    eye = torch.eye(3, dtype=log_rotation.dtype, device=log_rotation.device)
    return eye + A[..., None, None] * log_rotation_hat + B[..., None, None] * log_rotation_hat_square


def _get_se3_V_input(log_rotation: torch.Tensor, eps: float = 1e-4):
    nrms = torch.sum(log_rotation * log_rotation, dim=-1)
    rotation_angles = torch.sqrt(torch.clamp(nrms, min=eps))
    log_rotation_hat = hat(log_rotation)
    return log_rotation, log_rotation_hat, torch.matmul(log_rotation_hat, log_rotation_hat), rotation_angles


def se3_exp_map(log_transform: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Exponential map se(3) -> SE(3), (N, 6) -> (N, 4, 4) row-vector matrices."""
    if log_transform.ndim != 2 or log_transform.shape[1] != 6:
        raise ValueError("Expected input to be of shape (N, 6).")
    log_translation, log_rotation = log_transform[..., :3], log_transform[..., 3:]
    R, rotation_angles, log_rotation_hat, log_rotation_hat_square = _so3_exp_map(log_rotation, eps=eps)
    V = _se3_V_matrix(log_rotation, log_rotation_hat, log_rotation_hat_square, rotation_angles, eps=eps)
    # T = V t, written out as products (no batched GEMM for 3x3 by 3).
    T = torch.sum(V * log_translation[:, None, :], dim=-1)
    N = log_transform.shape[0]
    top = torch.cat([R, T[:, :, None]], dim=2)  # (N, 3, 4): [R | T]
    bottom = log_transform.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(N, 1, 4)
    # Row-vector convention: the transpose, translation in the last row.
    return torch.cat([top, bottom], dim=1).transpose(1, 2)


def se3_log_map(transform: torch.Tensor, eps: float = 1e-4, cos_bound: float = 1e-4) -> torch.Tensor:
    """Logarithm map SE(3) -> se(3), (N, 4, 4) -> (N, 6)."""
    if transform.ndim != 3 or transform.shape[-2:] != (4, 4):
        raise ValueError("Input tensor shape has to be (N, 4, 4).")
    R = transform[:, :3, :3].transpose(1, 2)
    log_rotation = so3_log_map(R, eps=eps, cos_bound=cos_bound)
    T = transform[:, 3, :3]
    V = _se3_V_matrix(*_get_se3_V_input(log_rotation, eps=eps), eps=eps)
    log_translation = torch.linalg.solve(V, T[..., None])[..., 0]
    return torch.cat((log_translation, log_rotation), dim=1)
