"""Barycentric interpolation of per-face-vertex attributes to pixels
(port of pytorch3d_tpu/ops/interp_face_attrs.py): a gather and a weighted
sum; autograd differentiates the gather."""

from __future__ import annotations

import torch


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
    F, _, D = face_attributes.shape
    ids = pix_to_face.reshape(-1)
    live = ids >= 0
    # Empty slots read rows spread over the table, not all row 0: their
    # values are masked below, and the gather's backward (index_add_) then
    # adds their zeros without millions of atomics on one row.
    spread = torch.arange(ids.numel(), device=ids.device) % max(F, 1)
    rows = face_attributes.index_select(0, torch.where(live, ids, spread))
    attrs = rows.reshape(*pix_to_face.shape, 3, D)  # (N, H, W, K, 3, D)
    vals = torch.sum(barycentric_coords[..., None] * attrs, dim=-2)
    return torch.where((pix_to_face >= 0)[..., None], vals, 0.0)
