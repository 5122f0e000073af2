"""Rotation conversions (port of pytorch3d_tpu/transforms/rotation_conversions.py).

Only what `transform3d.py` needs has been ported so far.
"""

from __future__ import annotations

import torch


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about a named axis ('X' | 'Y' | 'Z')."""
    cos = torch.cos(angle)
    sin = torch.sin(angle)
    one = torch.ones_like(angle)
    zero = torch.zeros_like(angle)

    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError("letter must be either X, Y or Z.")

    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))
