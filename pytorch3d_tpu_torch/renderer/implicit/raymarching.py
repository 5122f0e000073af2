"""Raymarching helpers (port of pytorch3d_tpu/renderer/implicit/raymarching.py;
the NeRF raymarcher's shifted cumulative product so far)."""

from __future__ import annotations

import torch


def _shifted_cumprod(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """cumprod along the last axis, shifted right by `shift` with ones."""
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :shift]), cp[..., :-shift]], dim=-1)
