"""Icosphere primitive (port of pytorch3d_tpu/utils/ico_sphere.py).

Host-side generator: the unit icosahedron and `level` rounds of 1-to-4
face subdivision with midpoint dedup, re-projected onto the unit sphere.
The vertex and face order is the JAX package's, so both give the same mesh.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..common import DEFAULT_DEVICE
from ..structures import Meshes


def _icosahedron():
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def _subdivide(verts: np.ndarray, faces: np.ndarray):
    midpoint_cache = {}
    verts = list(verts)

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in midpoint_cache:
            m = (verts[i] + verts[j]) / 2.0
            m /= np.linalg.norm(m)
            midpoint_cache[key] = len(verts)
            verts.append(m)
        return midpoint_cache[key]

    new_faces = []
    for a, b, c in faces:
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(new_faces, dtype=np.int64)


def ico_sphere(
    level: int = 0, device: Union[str, torch.device] = DEFAULT_DEVICE
) -> Meshes:
    """A unit icosphere mesh at the given subdivision level (0 = 20 faces)."""
    if level < 0:
        raise ValueError("level must be >= 0.")
    verts, faces = _icosahedron()
    for _ in range(level):
        verts, faces = _subdivide(verts, faces)
    return Meshes.create(
        verts=[verts.astype(np.float32)], faces=[faces], device=device
    )
