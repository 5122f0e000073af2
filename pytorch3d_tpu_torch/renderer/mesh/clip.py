"""Near-plane (z) clipping for mesh rasterization
(port of pytorch3d_tpu/renderer/mesh/clip.py).

Every input face maps to two static output slots, so a batch of (N, F)
faces becomes (N, 2F) and the rasterizer sees fixed shapes:

- case 1 (no vertex clipped): slot A = the face, slot B invalid;
- case 2 (all clipped): both slots invalid;
- case 3 (two clipped): slot A = the smaller triangle, slot B invalid;
- case 4 (one clipped): the quad split into slots A and B.

Slot A of face f is row f, slot B row F + f.  Each output vertex carries
its barycentric combination of the original face's vertices, so the
rasterized barycentrics convert back with one product.  All of it is
tensor ops over the whole batch; autograd carries gradients through the
plane intersections, whose divisions are guarded where a vertex lies on
the plane.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ...common.gather import gather_rows


class ClippedFaces(NamedTuple):
    face_verts: torch.Tensor  # (..., 2F, 3, 3)
    valid: torch.Tensor  # (..., 2F)
    faces_clipped_to_unclipped_idx: torch.Tensor  # (2F,) original face ids
    barycentric_conversion: torch.Tensor  # (..., 2F, 3, 3): rows = new verts as
    # barycentric combinations of the original verts


def clip_faces(
    face_verts: torch.Tensor,  # (..., F, 3, 3) NDC xy + view z
    valid: torch.Tensor,  # (..., F)
    z_clip_value: float,
) -> ClippedFaces:
    """Clip every face at z = z_clip_value (leading batch axes allowed)."""
    F = face_verts.shape[-3]
    z = face_verts[..., 2]  # (..., F, 3)
    clipped = z < z_clip_value
    n_clip = clipped.sum(dim=-1)  # (..., F)
    ar3 = torch.arange(3, device=face_verts.device)

    def rotate(r):
        return (r[..., None] + ar3) % 3  # (..., F, 3)

    # case 3: the first kept vertex leads; case 4: the vertex after the clipped one
    perm3 = rotate(torch.argmin(clipped.long() * 2 - 1, dim=-1))  # (t, p1, p2)
    perm4 = rotate((torch.argmax(clipped.long(), dim=-1) + 1) % 3)  # (t1, t2, p)

    def take(perm):
        return torch.gather(face_verts, -2, perm[..., None].expand(*perm.shape, 3))

    eye = torch.eye(3, dtype=face_verts.dtype, device=face_verts.device)
    fv3, fv4 = take(perm3), take(perm4)
    b3, b4 = eye[perm3], eye[perm4]

    def intersect(a, b, ba, bb):
        """The point on segment a -> b at z = z_clip_value and its barycentric row.

        A clipped vertex b on the camera plane (view z = 0) projects to an
        infinite x or y, and so does the point.  Its infinite difference
        stays out of the backward: there even a zero cotangent times
        infinity is NaN."""
        dz = b[..., 2] - a[..., 2]
        alpha = (z_clip_value - a[..., 2]) / torch.where(dz.abs() < 1e-12, 1.0, dz)
        # maximum / minimum, not clamp: at a vertex on the plane alpha is 0
        # exactly, where they split the gradient as the JAX package's clip does
        alpha = torch.minimum(torch.maximum(alpha, alpha.new_zeros(())), alpha.new_ones(()))[..., None]
        d = b - a
        d_finite = torch.where(torch.isfinite(d), d, 0.0)
        point = a + alpha * d_finite + (alpha * d - alpha * d_finite).detach()
        return point, ba + alpha * (bb - ba)

    # case 3 triangle: (t, i1, i2)
    t, p1, p2 = fv3.unbind(-2)
    bt, bp1, bp2 = b3.unbind(-2)
    i1, bi1 = intersect(t, p1, bt, bp1)
    i2, bi2 = intersect(t, p2, bt, bp2)
    tri3 = torch.stack([t, i1, i2], dim=-2)
    bar3 = torch.stack([bt, bi1, bi2], dim=-2)

    # case 4 quad: (t1, t2, j2) and (t1, j2, j1), with j_k = intersect(t_k, p)
    t1, t2, p = fv4.unbind(-2)
    bt1, bt2, bp = b4.unbind(-2)
    j1, bj1 = intersect(t1, p, bt1, bp)
    j2, bj2 = intersect(t2, p, bt2, bp)
    tri4a = torch.stack([t1, t2, j2], dim=-2)
    bar4a = torch.stack([bt1, bt2, bj2], dim=-2)
    tri4b = torch.stack([t1, j2, j1], dim=-2)
    bar4b = torch.stack([bt1, bj2, bj1], dim=-2)

    is1 = (n_clip == 1)[..., None, None]
    is2 = (n_clip == 2)[..., None, None]
    slot_a = torch.where(is2, tri3, torch.where(is1, tri4a, face_verts))
    bar_a = torch.where(is2, bar3, torch.where(is1, bar4a, eye.expand_as(face_verts)))
    valid_a = valid & (n_clip != 3)
    valid_b = valid & (n_clip == 1)
    out = torch.cat([slot_a, tri4b], dim=-3)
    # A sub-face with an infinite vertex covers no pixel; marked invalid,
    # no rasterizer bins it.  Invalid slots hold zeros, so that no route's
    # gathers of them meet an infinity.
    out_valid = torch.cat([valid_a, valid_b], dim=-1) & torch.isfinite(out).all(dim=-1).all(dim=-1)
    ids = torch.arange(F, device=face_verts.device)
    return ClippedFaces(
        face_verts=torch.where(out_valid[..., None, None], out, 0.0),
        valid=out_valid,
        faces_clipped_to_unclipped_idx=torch.cat([ids, ids]),
        barycentric_conversion=torch.cat([bar_a, bar4b], dim=-3),
    )


def convert_clipped_rasterization_to_original_faces(
    pix_to_face_clipped: torch.Tensor,  # (..., K) ids into the 2F table of each image
    bary_clipped: torch.Tensor,  # (..., K, 3)
    clipped: ClippedFaces,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map sub-face ids and barycentrics back to the original faces.

    Unbatched tables (2F, 3, 3) take ids of any shape; batched tables
    (N, 2F, 3, 3) take per-image ids (N, ...).  Empty slots keep -1 and
    their barycentrics."""
    conv = clipped.barycentric_conversion
    ids = pix_to_face_clipped.long()
    table_ids = ids
    if conv.ndim == 4:
        N, F2 = conv.shape[:2]
        offsets = torch.arange(N, device=ids.device).reshape(N, *([1] * (ids.ndim - 1))) * F2
        table_ids = torch.where(ids >= 0, ids + offsets, -1)
        conv = conv.reshape(N * F2, 3, 3)
    filled = ids >= 0
    pix_to_face = torch.where(filled, clipped.faces_clipped_to_unclipped_idx[ids.clamp(min=0)], -1)
    rows = gather_rows(conv, table_ids)  # (..., K, 3, 3)
    # the product written out: as an einsum it is a batched 1x3 by 3x3 GEMM
    # per slot, launched as millions of tiny matrix products
    b = bary_clipped
    bary = b[..., 0:1] * rows[..., 0, :] + b[..., 1:2] * rows[..., 1, :] + b[..., 2:3] * rows[..., 2, :]
    return pix_to_face, torch.where(filled[..., None], bary, bary_clipped)


class ClipFrustum:
    """View-frustum description for clipping and culling.  Axis values
    left None disable culling at that plane; `z_clip_value` enables
    near-plane triangle clipping (`clip_faces`)."""

    __slots__ = [
        "left",
        "right",
        "top",
        "bottom",
        "znear",
        "zfar",
        "perspective_correct",
        "cull",
        "z_clip_value",
    ]

    def __init__(
        self,
        left=None,
        right=None,
        top=None,
        bottom=None,
        znear=None,
        zfar=None,
        perspective_correct: bool = False,
        cull: bool = True,
        z_clip_value=None,
    ) -> None:
        self.left = left
        self.right = right
        self.top = top
        self.bottom = bottom
        self.znear = znear
        self.zfar = zfar
        self.perspective_correct = perspective_correct
        self.cull = cull
        self.z_clip_value = z_clip_value
