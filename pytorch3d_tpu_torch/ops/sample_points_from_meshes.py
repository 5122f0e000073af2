"""Uniform point sampling from mesh surfaces (port of
pytorch3d_tpu/ops/sample_points_from_meshes.py): per mesh, faces drawn with
probability proportional to area, then uniform barycentrics by the sqrt
trick.

The random draws come from an explicit `torch.Generator` and are handed to
`sample_points_with_draws`, which takes the face ids and (u, v) as
arguments, so a test can feed it the numbers another framework drew.
`return_textures` samples the mesh's textures at the samples through
one-sample fragments, as the rasterizer's would be.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..common.math_utils import safe_norm, safe_normalize


def _face_corners(meshes):
    """(v0, v1, v2) each (N, F, 3): the corners of every padded face."""
    verts = meshes.verts_padded()  # (N, V, 3)
    f = meshes.faces_padded().clamp(min=0)  # (N, F, 3)
    return tuple(torch.gather(verts, 1, f[..., c : c + 1].expand(-1, -1, 3)) for c in range(3))


def _take(x: torch.Tensor, face_idx: torch.Tensor) -> torch.Tensor:
    """x (N, F, C) at face_idx (N, S) -> (N, S, C)."""
    return torch.gather(x, 1, face_idx[..., None].expand(-1, -1, x.shape[-1]))


def _face_areas(meshes) -> torch.Tensor:
    """(N, F) face areas, 0 for padding: the draw's unnormalised probabilities."""
    v0, v1, v2 = _face_corners(meshes)
    areas = 0.5 * safe_norm(torch.linalg.cross(v1 - v0, v2 - v0), dim=-1)
    return torch.where(meshes.faces_padded_mask(), areas, 0.0)


def sample_points_with_draws(
    meshes,
    face_idx: torch.Tensor,  # (N, S) local face ids
    u: torch.Tensor,  # (N, S) uniform in [0, 1)
    v: torch.Tensor,  # (N, S) uniform in [0, 1)
    return_normals: bool = False,
    return_textures: bool = False,
):
    """Samples (N, S, 3) [, face normals (N, S, 3)] [, textures (N, S, C)]
    at the given draws; the samples are differentiable with respect to the
    mesh's verts."""
    v0, v1, v2 = _face_corners(meshes)
    a, b, c = (_take(x, face_idx) for x in (v0, v1, v2))
    su = torch.sqrt(u)
    w0 = 1.0 - su
    w1 = su * (1.0 - v)
    w2 = su * v
    samples = w0[..., None] * a + w1[..., None] * b + w2[..., None] * c
    out = (samples,)
    if return_normals:
        out += (_take(safe_normalize(torch.linalg.cross(v1 - v0, v2 - v0)), face_idx),)
    if return_textures:
        if meshes.textures is None:
            raise ValueError("Meshes do not contain textures.")
        from ..renderer.mesh.rasterizer import Fragments

        N, S = face_idx.shape
        first = meshes.mesh_to_faces_packed_first_idx()
        pix_to_face = (face_idx + first[:, None]).reshape(N, S, 1, 1)
        bary = torch.stack([w0, w1, w2], dim=-1).reshape(N, S, 1, 1, 3)
        dummy = samples.new_zeros((N, S, 1, 1))
        fragments = Fragments(pix_to_face=pix_to_face, zbuf=dummy, bary_coords=bary, dists=dummy)
        out += (meshes.sample_textures(fragments)[:, :, 0, 0],)
    return out if len(out) > 1 else out[0]


def sample_points_from_meshes(
    meshes,
    num_samples: int = 10000,
    return_normals: bool = False,
    return_textures: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """Sample points uniformly (by area) from a batch of meshes.

    Returns samples (N, num_samples, 3) [, normals (N, num_samples, 3)]
    [, textures (N, num_samples, C)].  `generator` (on the meshes' device)
    makes the draws reproducible.
    """
    if meshes.isempty():
        raise ValueError("Meshes are empty.")
    N = len(meshes)
    with torch.no_grad():
        face_idx = torch.multinomial(
            _face_areas(meshes), num_samples, replacement=True, generator=generator
        )
    uv = torch.rand((2, N, num_samples), generator=generator, device=meshes.device,
                    dtype=meshes.verts_padded().dtype)
    return sample_points_with_draws(meshes, face_idx, uv[0], uv[1], return_normals, return_textures)
