"""Workaround utilities (port of pytorch3d_tpu/common/workaround/utils.py)."""

from __future__ import annotations

import torch


def _safe_det_3x3(t: torch.Tensor) -> torch.Tensor:
    """Cofactor-expansion determinant of (..., 3, 3) matrices."""
    return (
        t[..., 0, 0] * (t[..., 1, 1] * t[..., 2, 2] - t[..., 1, 2] * t[..., 2, 1])
        - t[..., 0, 1] * (t[..., 1, 0] * t[..., 2, 2] - t[..., 2, 0] * t[..., 1, 2])
        + t[..., 0, 2] * (t[..., 1, 0] * t[..., 2, 1] - t[..., 2, 0] * t[..., 1, 1])
    )
