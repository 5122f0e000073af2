"""Point cloud normal and local-frame estimation by per-point PCA (port of
pytorch3d_tpu/ops/points_normals.py), through the closed-form
`symeig3x3`."""

from __future__ import annotations

from typing import Tuple

import torch

from ..common.symeig3x3 import symeig3x3
from .utils import convert_pointclouds_to_tensor, get_point_covariances


def estimate_pointcloud_normals(
    pointclouds,
    neighborhood_size: int = 50,
    disambiguate_directions: bool = True,
    use_symeig_workaround: bool = True,
) -> torch.Tensor:
    """(N, P, 3) normals: the eigenvector of the smallest eigenvalue of each
    point's neighbourhood covariance."""
    _, local_frames = estimate_pointcloud_local_coord_frames(
        pointclouds, neighborhood_size=neighborhood_size, disambiguate_directions=disambiguate_directions,
        use_symeig_workaround=use_symeig_workaround,
    )
    return local_frames[..., 0]


def estimate_pointcloud_local_coord_frames(
    pointclouds,
    neighborhood_size: int = 50,
    disambiguate_directions: bool = True,
    use_symeig_workaround: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per point (curvatures (N, P, 3), frames (N, P, 3, 3)): the ascending
    eigenvalues and eigenvectors (columns) of the neighbourhood covariance.

    The size check reads the smallest cloud's count on the host (one sync
    per call).  Neighbourhoods of up to 16 take the KNN kernel on the card;
    larger ones its plain version, as the JAX package takes XLA's.
    """
    points_padded, num_points = convert_pointclouds_to_tensor(pointclouds)
    if points_padded.shape[-1] != 3:
        raise ValueError("The pointclouds argument has to be of shape (N, P, 3)")
    if int(num_points.min()) <= neighborhood_size:
        raise ValueError("The neighborhood_size argument has to be >= size of each of the clouds.")
    cov, knns = get_point_covariances(points_padded, num_points, neighborhood_size)
    curvatures, local_coord_frames = symeig3x3(cov, eigenvectors=True)
    if disambiguate_directions:
        # Normal and tangent point toward the mean neighbour offset.
        knn_deltas = knns - points_padded[:, :, None]
        n = _disambiguate_vector_directions(knn_deltas, local_coord_frames[:, :, :, 0])
        z = _disambiguate_vector_directions(knn_deltas, local_coord_frames[:, :, :, 2])
        y = torch.linalg.cross(z, n, dim=-1)
        local_coord_frames = torch.stack((n, y, z), dim=3)
    return curvatures, local_coord_frames


def _disambiguate_vector_directions(df: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """vecs flipped where they point away from the mean of the offsets df."""
    proj = torch.sum(df * vecs[:, :, None], dim=-1)  # (N, P, K)
    flip = (proj.sum(dim=-1, keepdim=True) < 0).to(vecs.dtype)
    return (1.0 - 2.0 * flip) * vecs
