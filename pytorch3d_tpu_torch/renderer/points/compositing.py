"""Point compositing functions: alpha, normalized weighted and weighted sum
(port of pytorch3d_tpu/renderer/points/compositing.py).

Plain torch: the JAX package has no kernel here either, and autograd
differentiates the gathers and the cumulative product.  Layouts follow the
JAX package: pointsidx (N, K, H, W), alphas (N, K, H, W), features
(C, P_packed) -> output (N, C, H, W).
"""

from __future__ import annotations

import torch

from ...common.gather import gather_rows


def _gather_feats(features: torch.Tensor, pointsidx: torch.Tensor) -> torch.Tensor:
    """features (C, P), idx (N, K, H, W) -> (N, C, K, H, W), 0 where idx < 0;
    gathered point-major ((P, C) rows)."""
    g = gather_rows(features.t(), pointsidx).movedim(-1, 1)
    return torch.where((pointsidx >= 0)[:, None], g, 0.0)


def _masked_alphas(alphas: torch.Tensor, pointsidx: torch.Tensor) -> torch.Tensor:
    return torch.where(pointsidx >= 0, alphas, 0.0)


def alpha_composite(pointsidx, alphas, features) -> torch.Tensor:
    """Front-to-back over: sum_k alpha_k * prod_{j<k} (1 - alpha_j) * f_k."""
    a = _masked_alphas(alphas, pointsidx)  # (N, K, H, W)
    f = _gather_feats(features, pointsidx)  # (N, C, K, H, W)
    cum = torch.cumprod(1.0 - a, dim=1)
    t = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)  # exclusive cumprod
    w = a * t
    return torch.sum(w[:, None] * f, dim=2)


def norm_weighted_sum(pointsidx, alphas, features) -> torch.Tensor:
    """Weighted sum normalized by the sum of the weights (at least 1e-10)."""
    a = _masked_alphas(alphas, pointsidx)
    f = _gather_feats(features, pointsidx)
    w = a / torch.clamp(torch.sum(a, dim=1, keepdim=True), min=1e-10)
    return torch.sum(w[:, None] * f, dim=2)


def weighted_sum(pointsidx, alphas, features) -> torch.Tensor:
    """Unnormalized weighted sum."""
    a = _masked_alphas(alphas, pointsidx)
    f = _gather_feats(features, pointsidx)
    return torch.sum(a[:, None] * f, dim=2)
