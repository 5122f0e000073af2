"""Fit circles to 2D and 3D point sequences, such as camera centres (port of
pytorch3d_tpu/implicitron/tools/circle_fitting.py), on `torch.linalg`."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class Circle2D:
    center: torch.Tensor  # (2,)
    radius: torch.Tensor  # ()
    generated_points: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Circle3D:
    center: torch.Tensor  # (3,)
    radius: torch.Tensor  # ()
    normal: torch.Tensor  # (3,)
    generated_points: Optional[torch.Tensor] = None


def angles_around(n_points: int, like: torch.Tensor) -> torch.Tensor:
    """n_points angles evenly over [0, 2 pi), the last one short of 2 pi."""
    return torch.arange(n_points, dtype=like.dtype, device=like.device) * (2 * math.pi / n_points)


def fit_circle_in_2d(
    points2d: torch.Tensor, n_points: int = 0, angles: Optional[torch.Tensor] = None
) -> Circle2D:
    """Least-squares circle through (P, 2) points (Coope's method): solve
    [2 p, 1] (c, r^2 - |c|^2) = |p|^2.  With `n_points` or `angles`, also
    the circle's points at those angles."""
    P = points2d
    A = torch.cat([2.0 * P, torch.ones((P.shape[0], 1), dtype=P.dtype, device=P.device)], dim=1)
    b = torch.sum(P * P, dim=1)
    sol = torch.linalg.lstsq(A, b[:, None]).solution
    center = sol[:2, 0]
    radius = torch.sqrt(sol[2, 0] + torch.sum(center**2))
    generated = None
    if n_points > 0 or angles is not None:
        if angles is None:
            angles = angles_around(n_points, P)
        generated = center + radius * torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    return Circle2D(center=center, radius=radius, generated_points=generated)


def fit_circle_in_3d(
    points: torch.Tensor,
    n_points: int = 0,
    angles: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    up: Optional[torch.Tensor] = None,
) -> Circle3D:
    """Circle through (P, 3) points: their plane by PCA (the normal turned
    towards `up` where given), then `fit_circle_in_2d` in that plane."""
    centroid = points.mean(dim=0)
    centered = points - centroid
    Vt = torch.linalg.svd(centered, full_matrices=False).Vh
    normal = Vt[2]
    if up is not None:
        normal = normal * torch.sign(torch.dot(normal, up))
    basis = Vt[:2]  # (2, 3)
    c2d = fit_circle_in_2d(centered @ basis.T, n_points=n_points, angles=angles)
    generated = None
    if c2d.generated_points is not None:
        generated = centroid + c2d.generated_points @ basis
        if offset is not None:
            generated = generated + offset
    return Circle3D(center=centroid + c2d.center @ basis, radius=c2d.radius, normal=normal,
                    generated_points=generated)


def get_rotation_to_best_fit_xy(points: torch.Tensor, centroid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotation R such that `points @ R` has its best-fit plane parallel to
    xy: the two largest principal directions become x and y, their cross
    product z (right-handed)."""
    if centroid is None:
        centroid = points.mean(dim=-2, keepdim=True)
    centered = points - centroid
    _, evec = torch.linalg.eigh(centered.transpose(-1, -2) @ centered)  # ascending eigenvalues
    return torch.cat([evec[..., 1:], torch.linalg.cross(evec[..., 1], evec[..., 2])[..., None]], dim=-1)
