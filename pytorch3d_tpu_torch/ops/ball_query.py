"""Fixed-radius neighbour search with first-K semantics (port of
pytorch3d_tpu/ops/ball_query.py).

The squared distances to every database point are computed at once and the
first K within the radius, in ascending index, are selected by a top-k of
the score -j (the smallest index scores highest), as the JAX package does
in place of the reference's early-exit scan.
"""

from __future__ import annotations

from typing import Optional

import torch

from .knn import _KNN, _pair_dists, knn_gather


def ball_query(
    p1: torch.Tensor,
    p2: torch.Tensor,
    lengths1: Optional[torch.Tensor] = None,
    lengths2: Optional[torch.Tensor] = None,
    K: int = 500,
    radius: float = 0.2,
    return_nn: bool = True,
) -> _KNN:
    """The first K points of p2 within `radius` of each point of p1 (JAX
    ball_query.py:22).

    Returns _KNN(dists (N, P1, K) squared, idx (N, P1, K) int64, nn
    (N, P1, K, D) or None); unfilled slots have idx -1, dist 0 and nn 0.
    """
    if p1.ndim != 3 or p2.ndim != 3:
        raise ValueError("p1 and p2 must be (N, P, D) tensors")
    P1, P2 = p1.shape[1], p2.shape[1]
    K = int(min(K, P2))
    d = _pair_dists(p1, p2, 2)  # (N, P1, P2) squared
    inside = d < radius * radius
    if lengths2 is not None:
        inside = inside & (torch.arange(P2, device=p2.device)[None, :] < lengths2[:, None])[:, None, :]
    j = torch.arange(P2, dtype=torch.float32, device=p2.device)
    score = torch.where(inside, -j, -torch.inf)
    top = torch.topk(score, K, dim=-1).values  # largest score = smallest index
    filled = torch.isfinite(top)
    idx = torch.where(filled, -top, -1.0).long()
    dists = torch.where(filled, torch.gather(d, -1, idx.clamp(min=0)), 0.0)
    if lengths1 is not None:
        valid1 = (torch.arange(P1, device=p1.device)[None, :] < lengths1[:, None])[..., None]
        idx = torch.where(valid1, idx, -1)
        dists = torch.where(valid1, dists, 0.0)
    nn = None
    if return_nn:
        nn = torch.where((idx >= 0)[..., None], knn_gather(p2, idx.clamp(min=0)), 0.0)
    return _KNN(dists=dists, idx=idx, knn=nn)
