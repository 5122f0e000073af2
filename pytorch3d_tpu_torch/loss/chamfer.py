"""Chamfer distance between point sets, with an optional normals term
(port of pytorch3d_tpu/loss/chamfer.py), built on `knn_points`.

Inputs are padded (N, P, D) tensors with optional lengths; a `Pointclouds`
input waits for the port of structures/pointclouds.py and raises TypeError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..common.math_utils import safe_normalize
from ..ops.knn import knn_gather, knn_points


def _handle_pointcloud_input(points, lengths, normals):
    """Padded tensor (+ lengths, normals) -> (padded, lengths, normals)."""
    if not isinstance(points, torch.Tensor):
        raise TypeError(
            f"chamfer_distance takes padded (N, P, D) tensors; got {type(points).__name__}"
            " (Pointclouds waits for the port of structures/pointclouds.py)"
        )
    if points.ndim != 3:
        raise ValueError("Expected points to be of shape (N, P, D)")
    if lengths is None:
        lengths = torch.full((points.shape[0],), points.shape[1], dtype=torch.int64, device=points.device)
    return points, lengths, normals


def _chamfer_single_direction(x, y, x_lengths, y_lengths, x_normals, y_normals, weights, norm, abs_cosine):
    P1 = x.shape[1]
    x_mask = torch.arange(P1, device=x.device)[None] < x_lengths[:, None]

    nn = knn_points(x, y, x_lengths, y_lengths, norm=norm, K=1)
    cham_x = torch.where(x_mask, nn.dists[..., 0], 0.0)  # (N, P1)

    cham_norm_x = None
    if x_normals is not None and y_normals is not None:
        y_nn_normals = knn_gather(y_normals, nn.idx, y_lengths)[..., 0, :]
        cos = torch.sum(safe_normalize(x_normals) * safe_normalize(y_nn_normals), dim=-1)
        cos = cos.abs() if abs_cosine else cos
        cham_norm_x = torch.where(x_mask, 1.0 - cos, 0.0)

    if weights is not None:
        cham_x = cham_x * weights[:, None]
        if cham_norm_x is not None:
            cham_norm_x = cham_norm_x * weights[:, None]
    return cham_x, cham_norm_x


def _reduce(cham, x_lengths, weights, point_reduction, batch_reduction):
    if point_reduction == "mean":
        cham = torch.sum(cham, dim=1) / x_lengths.to(cham.dtype).clamp(min=1.0)
    elif point_reduction == "sum":
        cham = torch.sum(cham, dim=1)
    elif point_reduction == "max":
        cham = torch.amax(cham, dim=1)
    elif point_reduction is None:
        return cham
    else:
        raise ValueError('point_reduction must be one of ["mean", "sum", "max", None]')
    if batch_reduction is None:
        return cham
    if batch_reduction == "sum":
        return torch.sum(cham)
    if batch_reduction == "mean":
        div = torch.sum(weights).clamp(min=1e-12) if weights is not None else cham.shape[0]
        return torch.sum(cham) / div
    raise ValueError('batch_reduction must be one of ["mean", "sum", None]')


def chamfer_distance(
    x,
    y,
    x_lengths: Optional[torch.Tensor] = None,
    y_lengths: Optional[torch.Tensor] = None,
    x_normals: Optional[torch.Tensor] = None,
    y_normals: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    batch_reduction: Optional[str] = "mean",
    point_reduction: Optional[str] = "mean",
    norm: int = 2,
    single_directional: bool = False,
    abs_cosine: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Chamfer distance (JAX chamfer.py:105).

    Returns (loss, loss_normals); loss_normals is None when no normals are
    given (and for point_reduction="max").
    """
    if norm not in (1, 2):
        raise ValueError("Support for 1 or 2 norm.")
    x, x_lengths, x_normals = _handle_pointcloud_input(x, x_lengths, x_normals)
    y, y_lengths, y_normals = _handle_pointcloud_input(y, y_lengths, y_normals)

    cham_x, cham_norm_x = _chamfer_single_direction(
        x, y, x_lengths, y_lengths, x_normals, y_normals, weights, norm, abs_cosine
    )
    loss_x = _reduce(cham_x, x_lengths, weights, point_reduction, batch_reduction)
    loss_norm_x = (
        _reduce(cham_norm_x, x_lengths, weights, point_reduction, batch_reduction)
        if cham_norm_x is not None
        else None
    )
    if single_directional:
        return loss_x, loss_norm_x

    cham_y, cham_norm_y = _chamfer_single_direction(
        y, x, y_lengths, x_lengths, y_normals, x_normals, weights, norm, abs_cosine
    )
    loss_y = _reduce(cham_y, y_lengths, weights, point_reduction, batch_reduction)
    loss_norm_y = (
        _reduce(cham_norm_y, y_lengths, weights, point_reduction, batch_reduction)
        if cham_norm_y is not None
        else None
    )
    if point_reduction == "max":
        return torch.maximum(loss_x, loss_y), None
    loss_norm = loss_norm_x + loss_norm_y if loss_norm_x is not None else None
    return loss_x + loss_y, loss_norm
