"""Barycentric interpolation of per-face-vertex attributes to pixels
(port of pytorch3d_tpu/ops/interp_face_attrs.py): a gather and a weighted
sum; autograd differentiates the gather."""

from __future__ import annotations

import torch

from ..common.gather import gather_rows


def interpolate_face_attributes(
    pix_to_face: torch.Tensor,  # (N, H, W, K) packed face ids, -1 = empty
    barycentric_coords: torch.Tensor,  # (N, H, W, K, 3)
    face_attributes: torch.Tensor,  # (F_total, 3, D)
) -> torch.Tensor:
    """Interpolate per-vertex attributes with barycentric weights.

    Returns (N, H, W, K, D); empty pixels are 0.
    """
    if face_attributes.ndim != 3 or face_attributes.shape[1] != 3:
        raise ValueError("face_attributes must have shape (F, 3, D)")
    attrs = gather_rows(face_attributes, pix_to_face)  # (N, H, W, K, 3, D)
    vals = torch.sum(barycentric_coords[..., None] * attrs, dim=-2)
    return torch.where((pix_to_face >= 0)[..., None], vals, 0.0)


def interpolate_face_attributes_python(pix_to_face, barycentric_coords, face_attributes):
    """PyTorch3D's name for its plain version: the same function."""
    return interpolate_face_attributes(pix_to_face, barycentric_coords, face_attributes)
