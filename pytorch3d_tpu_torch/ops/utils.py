"""Shared op utilities (port of pytorch3d_tpu/ops/utils.py)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..common import DEFAULT_DEVICE
from ..structures.pointclouds import Pointclouds
from .knn import knn_points

Device = Union[str, torch.device]


def eyes(dim: int, N: int, dtype: torch.dtype = torch.float32, device: Device = DEFAULT_DEVICE) -> torch.Tensor:
    """(N, dim, dim) batch of identity matrices."""
    return torch.eye(dim, dtype=dtype, device=device).expand(N, dim, dim)


def wmean(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    dim: Union[int, Tuple[int, ...]] = -2,
    keepdim: bool = True,
    eps: float = 1e-9,
) -> torch.Tensor:
    """Mean of x over `dim`, weighted by `weight` (x's shape without its
    last dim) when given."""
    if weight is None:
        return x.mean(dim=dim, keepdim=keepdim)
    w = weight[..., None]
    return (x * w).sum(dim=dim, keepdim=keepdim) / torch.clamp(w.sum(dim=dim, keepdim=keepdim), min=eps)


def masked_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (N, P, D) gathered by (N, K) or (N, K, S) indices; an index
    of -1 gives zeros."""
    if idx.ndim not in (2, 3):
        raise ValueError("idx format is not supported %s" % repr(tuple(idx.shape)))
    mask = idx >= 0
    flat = torch.clamp(idx, min=0).reshape(idx.shape[0], -1)
    out = points.gather(1, flat[..., None].expand(-1, -1, points.shape[-1]))
    out = out.reshape(tuple(idx.shape) + (points.shape[-1],))
    return torch.where(mask[..., None], out, 0.0)


def convert_pointclouds_to_tensor(pcl):
    """Pointclouds or an (N, P, D) tensor -> (padded points, counts (N,))."""
    if isinstance(pcl, Pointclouds):
        return pcl.points_padded(), pcl.num_points_per_cloud()
    pcl = torch.as_tensor(pcl)
    return pcl, torch.full((pcl.shape[0],), pcl.shape[1], dtype=torch.int64, device=pcl.device)


def is_pointclouds(pcl) -> bool:
    return isinstance(pcl, Pointclouds)


def get_point_covariances(
    points_padded: torch.Tensor, num_points_per_cloud: torch.Tensor, neighborhood_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariances of each point's K nearest neighbours (itself included):
    (covariances (N, P, 3, 3), k_nearest_neighbors (N, P, K, 3)).

    The neighbours come from `knn_points` (the KNN kernel, #9, on the card
    for K <= 16).  The covariance sums are float32 products over the K
    neighbours, not a batched 3xK by Kx3 GEMM per point.
    """
    k_nn = knn_points(
        points_padded, points_padded, lengths1=num_points_per_cloud, lengths2=num_points_per_cloud,
        K=neighborhood_size, return_nn=True,
    ).knn
    centered = k_nn - k_nn.mean(dim=2, keepdim=True)
    cov = (centered[..., :, None] * centered[..., None, :]).sum(dim=2) / max(neighborhood_size, 1)
    return cov, k_nn
