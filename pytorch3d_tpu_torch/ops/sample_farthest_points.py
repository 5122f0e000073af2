"""Iterative farthest point sampling (port of
pytorch3d_tpu/ops/sample_farthest_points.py).

The selection is sequential (K steps); each step updates every cloud's
running minimum distance to the chosen points and takes its argmax, for
the whole batch at once.  Variable lengths are -inf masks.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def sample_farthest_points(
    points: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    K: Union[int, torch.Tensor] = 50,
    random_start_point: bool = False,
    generator: Optional[torch.Generator] = None,
    start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Farthest point subsampling (JAX sample_farthest_points.py:20).

    Args:
        points: (N, P, D).
        lengths: (N,) valid counts.
        K: samples per cloud: an int, or an (N,) tensor of per-cloud budgets
            (padded to the largest).
        random_start_point: start each cloud at a uniformly drawn point
            (from `generator`, on the points' device) instead of point 0.
        start: (N,) start indices, handed in instead of drawn (the CPU
            tests hand in the JAX package's).

    Returns:
        (selected points (N, K, D), indices (N, K) int64); padded slots get
        index -1 and point 0.
    """
    N, P, D = points.shape
    device = points.device
    if torch.is_tensor(K):
        K_per = K.to(device=device, dtype=torch.int64).clamp(max=P)
        K_max = int(K_per.max())
    else:
        K_max, K_per = int(min(K, P)), None
    if lengths is None:
        lengths = torch.full((N,), P, dtype=torch.int64, device=device)
    lengths = lengths.to(device=device, dtype=torch.int64)
    valid = torch.arange(P, device=device)[None, :] < lengths[:, None]
    if start is None:
        if random_start_point:
            u = torch.rand((N,), generator=generator, device=device, dtype=points.dtype)
            start = (u * lengths.clamp(min=1)).long()
        else:
            start = torch.zeros((N,), dtype=torch.int64, device=device)
    last = start.to(device=device, dtype=torch.int64)

    batch = torch.arange(N, device=device)
    min_d = torch.where(valid, torch.inf, -torch.inf).to(points.dtype)
    picked = []
    for _ in range(K_max):
        picked.append(last)
        d = ((points - points[batch, last][:, None, :]) ** 2).sum(dim=-1)
        min_d = torch.minimum(min_d, torch.where(valid, d, -torch.inf))
        last = torch.argmax(min_d, dim=-1)
    idxs = torch.stack(picked, dim=1) if picked else torch.zeros((N, 0), dtype=torch.int64, device=device)

    budget = torch.minimum(lengths, K_per if K_per is not None else torch.full_like(lengths, K_max))
    idxs = torch.where(torch.arange(K_max, device=device)[None, :] < budget[:, None], idxs, -1)
    pts = torch.gather(points, 1, idxs.clamp(min=0)[..., None].expand(-1, -1, D))
    pts = torch.where((idxs >= 0)[..., None], pts, 0.0)
    return pts, idxs


def sample_farthest_points_naive(
    points, lengths=None, K=50, random_start_point=False, generator=None, start=None
):
    """Reference-naming alias (JAX sample_farthest_points.py:85)."""
    return sample_farthest_points(points, lengths, K, random_start_point, generator, start)
