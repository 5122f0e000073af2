"""Torus primitive (port of pytorch3d_tpu/utils/torus.py)."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..common import DEFAULT_DEVICE
from ..structures import Meshes


def torus(
    r: float,
    R: float,
    sides: int,
    rings: int,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Meshes:
    """A torus with minor radius r, major radius R, (rings x sides) grid."""
    if not (sides > 0 and rings > 0):
        raise ValueError("sides and rings must be > 0.")
    phi = 2 * np.pi * np.arange(rings) / rings  # around the big circle
    theta = 2 * np.pi * np.arange(sides) / sides  # around the tube
    phi, theta = np.meshgrid(phi, theta, indexing="ij")  # (rings, sides)
    x = (R + r * np.cos(theta)) * np.cos(phi)
    y = (R + r * np.cos(theta)) * np.sin(phi)
    z = r * np.sin(theta)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    idx = np.arange(rings * sides).reshape(rings, sides)
    i_next = np.roll(idx, -1, axis=0)
    j_next = np.roll(idx, -1, axis=1)
    ij_next = np.roll(i_next, -1, axis=1)
    # two triangles per quad
    f0 = np.stack([idx, i_next, j_next], axis=-1).reshape(-1, 3)
    f1 = np.stack([j_next, i_next, ij_next], axis=-1).reshape(-1, 3)
    faces = np.concatenate([f0, f1], axis=0)
    return Meshes.create(
        verts=[verts.astype(np.float32)], faces=[faces], device=device
    )
