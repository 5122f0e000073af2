"""Numerically safe math helpers (port of pytorch3d_tpu/transforms/math.py)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

DEFAULT_ACOS_BOUND: float = 1.0 - 1e-4


def acos_linear_extrapolation(
    x: torch.Tensor,
    bounds: Tuple[float, float] = (-DEFAULT_ACOS_BOUND, DEFAULT_ACOS_BOUND),
) -> torch.Tensor:
    """arccos(x) inside ``bounds``; outside them the first-order Taylor
    expansion around the bound, so that the value and its gradient stay
    finite for |x| -> 1 and beyond."""
    lower_bound, upper_bound = bounds
    if lower_bound > upper_bound:
        raise ValueError("lower bound has to be smaller or equal to upper bound.")
    if lower_bound <= -1.0 or upper_bound >= 1.0:
        raise ValueError("Both bounds have to be within (-1, 1).")
    out = torch.arccos(torch.clamp(x, lower_bound, upper_bound))
    out = torch.where(x > upper_bound, _acos_linear_approximation(x, upper_bound), out)
    return torch.where(x < lower_bound, _acos_linear_approximation(x, lower_bound), out)


def _acos_linear_approximation(x: torch.Tensor, x0: float) -> torch.Tensor:
    """First-order Taylor expansion of arccos around x0."""
    return (x - x0) * (-1.0 / math.sqrt(1.0 - x0 * x0)) + math.acos(x0)
