"""NaN-safe vector math for autograd (port of pytorch3d_tpu/common/math_utils.py).

The gradient of |x| is x/|x|, which is NaN at 0, and a zero upstream
gradient does not mask it (0 * nan = nan).  The double-where trick replaces
degenerate inputs before the sqrt, so value and gradient are both 0 there.
"""

from __future__ import annotations

import torch


def safe_norm(
    x: torch.Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-20
) -> torch.Tensor:
    """L2 norm with a zero (not NaN) gradient where ||x|| == 0."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    ok = sq > eps
    safe = torch.sqrt(torch.where(ok, sq, torch.ones_like(sq)))
    return torch.where(ok, safe, torch.zeros_like(sq))



def safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-20) -> torch.Tensor:
    """x / ||x|| with a zero output (and zero gradient) where ||x|| == 0."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    ok = sq > eps
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, sq, torch.ones_like(sq))), 0.0)
    return x * inv
