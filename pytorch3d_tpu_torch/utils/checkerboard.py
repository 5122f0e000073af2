"""Checkerboard mesh primitive (port of pytorch3d_tpu/utils/checkerboard.py)."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..common import DEFAULT_DEVICE
from ..renderer.mesh.textures import TexturesAtlas
from ..structures.meshes import Meshes


def checkerboard(
    radius: int = 4,
    color1: Tuple[float, ...] = (0.0, 0.0, 0.0),
    color2: Tuple[float, ...] = (1.0, 1.0, 1.0),
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Meshes:
    """A 2*radius x 2*radius checkerboard in the z=0 plane, two triangles a
    square, coloured by a per-face (R=1) texture atlas."""
    side = 2 * radius
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X, Y, np.zeros_like(X)], axis=-1).reshape(-1, 3)
    V = side + 1
    faces, colors = [], []
    for i in range(side):
        for j in range(side):
            v00 = i * V + j
            v10 = v00 + V
            faces += [(v00, v10, v10 + 1), (v00, v10 + 1, v00 + 1)]
            c = color1 if (i + j) % 2 == 0 else color2
            colors += [c, c]
    atlas = np.asarray(colors, np.float32)[None, :, None, None, :]
    return Meshes.create(
        [verts], [np.asarray(faces, np.int64)], textures=TexturesAtlas.create(atlas, device=device), device=device,
    )
