"""Mesh rasterization: the plain path and the dispatch
(port of pytorch3d_tpu/renderer/mesh/rasterize_meshes.py).

The rasterizer is split as in the JAX package:

1. **Selection** (not differentiable): for every pixel the K nearest-in-z
   faces whose blur region covers it, ties to the lower face id.  The plain
   version here scans face chunks with a per-pixel running top-K buffer
   (`rasterize_topk`); on CUDA tensors the hand-written fine kernel of
   `rasterize_cuda.py` does the selection and emits the fragments.
2. **Recompute** (differentiable): gather the selected faces' verts and
   recompute barycentrics, z and signed distance with plain torch
   (`interpolate_fragments`); autograd carries gradients to the verts.

Conventions: face verts are in NDC xy (+X left, +Y up) with view-space z;
pixel (0, 0) is the top-left of the image; dists are squared NDC distances,
negative inside the face; blur_radius is in squared NDC units.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..utils import parse_image_size

kEpsilon = 1e-8


def non_square_ndc_range(S1: int, S2: int) -> float:
    """NDC span of an image side of length S1 given the other side S2."""
    return 2.0 * max(S1 / S2, 1.0)


def pix_to_non_square_ndc(i: torch.Tensor, S1: int, S2: int) -> torch.Tensor:
    """Center of pixel i along a side of length S1 (other side S2)."""
    rng = non_square_ndc_range(S1, S2)
    offset = rng / 2.0
    return -offset + (rng * i + offset) / S1


def pixel_grid_ndc(H: int, W: int, device, dtype=torch.float32):
    """(H,) y and (W,) x NDC pixel-center coordinates, row 0 = top (+y)."""
    rows = torch.arange(H, dtype=dtype, device=device)
    cols = torch.arange(W, dtype=dtype, device=device)
    yf = pix_to_non_square_ndc(H - 1 - rows, H, W)
    xf = pix_to_non_square_ndc(W - 1 - cols, W, H)
    return yf, xf


def pixel_centers_ndc(H: int, W: int, device, dtype=torch.float32) -> torch.Tensor:
    """(H, W, 2) NDC pixel centers, last axis (x, y)."""
    yf, xf = pixel_grid_ndc(H, W, device, dtype)
    gy, gx = torch.meshgrid(yf, xf, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


# --------------------------------------------------------------------------- #
# Geometry primitives
# --------------------------------------------------------------------------- #


def edge_function(p, v0, v1):
    """Signed parallelogram area of (v0, v1, p); all inputs (..., 2)."""
    return (p[..., 0] - v0[..., 0]) * (v1[..., 1] - v0[..., 1]) - (
        p[..., 1] - v0[..., 1]
    ) * (v1[..., 0] - v0[..., 0])


def barycentric_coords(p, v0, v1, v2):
    """Barycentrics of p in triangle (v0, v1, v2); inputs broadcast (..., 2)."""
    area = edge_function(v2, v0, v1) + kEpsilon
    w0 = edge_function(p, v1, v2) / area
    w1 = edge_function(p, v2, v0) / area
    w2 = edge_function(p, v0, v1) / area
    return torch.stack([w0, w1, w2], dim=-1)


def barycentric_perspective_correction(bary, z0, z1, z2):
    w0_top = bary[..., 0] * z1 * z2
    w1_top = z0 * bary[..., 1] * z2
    w2_top = z0 * z1 * bary[..., 2]
    denom = torch.clamp(w0_top + w1_top + w2_top, min=kEpsilon)
    return torch.stack([w0_top, w1_top, w2_top], dim=-1) / denom[..., None]


def barycentric_clip(bary):
    w = torch.clamp(bary, min=0.0)
    # (w0 + w1) + w2 written out: a reduction kernel may add in another
    # order, and the CUDA fine kernel adds in this one.
    w_sum = torch.clamp(w[..., 0:1] + w[..., 1:2] + w[..., 2:3], min=1e-5)
    return w / w_sum


def point_line_segment_distance2(p, v0, v1):
    """Squared distance from p to segment (v0, v1); inputs (..., 2)."""
    v1v0 = v1 - v0
    l2 = torch.sum(v1v0 * v1v0, dim=-1)
    t = torch.sum(v1v0 * (p - v0), dim=-1) / torch.clamp(l2, min=kEpsilon)
    t = torch.clamp(t, 0.0, 1.0)
    # Degenerate segment: distance to v1.
    t = torch.where(l2 <= kEpsilon, 1.0, t)
    d = p - (v0 + t[..., None] * v1v0)
    return torch.sum(d * d, dim=-1)


def point_triangle_distance2(p, v0, v1, v2):
    """Squared distance from p to the triangle boundary (min over edges)."""
    e01 = point_line_segment_distance2(p, v0, v1)
    e02 = point_line_segment_distance2(p, v0, v2)
    e12 = point_line_segment_distance2(p, v1, v2)
    return torch.minimum(torch.minimum(e01, e02), e12)


# --------------------------------------------------------------------------- #
# Selection: per-pixel top-K face ids (not differentiable)
# --------------------------------------------------------------------------- #


def _face_pixel_candidates(
    fv: torch.Tensor,  # (C, 3, 3) chunk of face verts
    face_ok: torch.Tensor,  # (C,) bool (valid & not culled)
    pxy: torch.Tensor,  # (H, W, 2)
    blur_radius: float,
    perspective_correct: bool,
    clip_barycentric_coords: bool,
) -> torch.Tensor:
    """z of each chunk face at each pixel, +inf where the face doesn't cover:
    (H, W, C)."""
    v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
    v0xy, v1xy, v2xy = v0[:, :2], v1[:, :2], v2[:, :2]
    z0, z1, z2 = v0[:, 2], v1[:, 2], v2[:, 2]

    p = pxy[:, :, None, :]  # (H, W, 1, 2)
    bary0 = barycentric_coords(p, v0xy, v1xy, v2xy)  # (H, W, C, 3)
    bary = (
        barycentric_perspective_correction(bary0, z0, z1, z2)
        if perspective_correct
        else bary0
    )
    bary_clip = barycentric_clip(bary) if clip_barycentric_coords else bary
    pz = bary_clip[..., 0] * z0 + bary_clip[..., 1] * z1 + bary_clip[..., 2] * z2

    dist2 = point_triangle_distance2(p, v0xy, v1xy, v2xy)  # (H, W, C)
    inside = torch.all(bary > 0.0, dim=-1)
    covers = face_ok & (pz >= 0) & (inside | (dist2 < blur_radius))
    return torch.where(covers, pz, torch.inf)


def _face_culls(
    fv: torch.Tensor, valid: torch.Tensor, cull_backfaces: bool
) -> torch.Tensor:
    """Per-face cull mask shared by all pixels (zmax, area, backface).
    `fv` is (..., F, 3, 3); the CUDA path bins with the same mask."""
    v0, v1, v2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    zmax = torch.maximum(torch.maximum(v0[..., 2], v1[..., 2]), v2[..., 2])
    face_area = edge_function(v0[..., :2], v1[..., :2], v2[..., :2])
    zero_area = (face_area <= kEpsilon) & (face_area >= -kEpsilon)
    ok = valid & (zmax >= 0) & ~zero_area
    if cull_backfaces:
        ok = ok & (face_area >= 0)
    return ok


def rasterize_topk(
    face_verts: torch.Tensor,  # (F, 3, 3) one image's faces (NDC xy, view z)
    valid: torch.Tensor,  # (F,) bool
    image_size: Tuple[int, int],
    blur_radius: float = 0.0,
    faces_per_pixel: int = 1,
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    cull_backfaces: bool = False,
    chunk_size: int = 256,
) -> torch.Tensor:
    """Per-pixel ascending-z top-K face indices; -1 where fewer than K cover.

    The plain selection (JAX `rasterize_topk_xla`): scans face chunks
    keeping an (H, W, K) running buffer of the smallest-z candidates.
    """
    H, W = image_size
    pxy = pixel_centers_ndc(H, W, face_verts.device, face_verts.dtype)
    return rasterize_topk_at_pixels(
        face_verts, valid, pxy, blur_radius, faces_per_pixel,
        perspective_correct, clip_barycentric_coords, cull_backfaces, chunk_size,
    )


def rasterize_topk_at_pixels(
    face_verts: torch.Tensor,  # (F, 3, 3)
    valid: torch.Tensor,  # (F,)
    pxy: torch.Tensor,  # (H, W, 2) explicit NDC pixel centers
    blur_radius: float = 0.0,
    faces_per_pixel: int = 1,
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    cull_backfaces: bool = False,
    chunk_size: int = 256,
) -> torch.Tensor:
    """Selection over an explicit pixel grid.  Per-pixel results are
    independent, so any subset of pixels gives the full-image values.

    Ties in z go to the lower face id: each chunk is sorted stably
    (`torch.topk` promises no order among ties) and merged stably with the
    running buffer, which holds only lower ids.
    """
    H, W = pxy.shape[:2]
    F = face_verts.shape[0]
    K = faces_per_pixel
    device = face_verts.device
    ok = _face_culls(face_verts, valid, cull_backfaces)

    best_z = torch.full((H, W, K), torch.inf, dtype=face_verts.dtype, device=device)
    best_idx = torch.full((H, W, K), -1, dtype=torch.int64, device=device)
    C = max(1, min(chunk_size, F))
    for base in range(0, F, C):
        pz = _face_pixel_candidates(
            face_verts[base : base + C], ok[base : base + C], pxy, blur_radius,
            perspective_correct, clip_barycentric_coords,
        )  # (H, W, c)
        chunk_z, local = torch.sort(pz, dim=-1, stable=True)
        chunk_z, local = chunk_z[..., :K], local[..., :K]
        chunk_idx = torch.where(torch.isinf(chunk_z), -1, base + local)
        all_z = torch.cat([best_z, chunk_z], dim=-1)
        all_idx = torch.cat([best_idx, chunk_idx], dim=-1)
        order = torch.sort(all_z, dim=-1, stable=True).indices[..., :K]
        best_z = torch.gather(all_z, -1, order)
        best_idx = torch.gather(all_idx, -1, order)
    return best_idx


# --------------------------------------------------------------------------- #
# Recompute: differentiable fragment quantities at fixed pix_to_face
# --------------------------------------------------------------------------- #


def _fragments_from_gathered(
    fv: torch.Tensor,  # (H, W, K, 3, 3) per-pixel gathered face verts
    pix_to_face: torch.Tensor,  # (H, W, K)
    image_size: Tuple[int, int],
    perspective_correct: bool,
    clip_barycentric_coords: bool,
    pxy: Optional[torch.Tensor] = None,
):
    """Elementwise fragment math given already-gathered face verts."""
    v0, v1, v2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    v0xy, v1xy, v2xy = v0[..., :2], v1[..., :2], v2[..., :2]
    z0, z1, z2 = v0[..., 2], v1[..., 2], v2[..., 2]

    if pxy is None:
        pxy = pixel_centers_ndc(*image_size, fv.device, fv.dtype)
    p = pxy[:, :, None, :]  # (H, W, 1, 2)

    bary0 = barycentric_coords(p, v0xy, v1xy, v2xy)
    bary = (
        barycentric_perspective_correction(bary0, z0, z1, z2)
        if perspective_correct
        else bary0
    )
    bary_clip = barycentric_clip(bary) if clip_barycentric_coords else bary
    pz = bary_clip[..., 0] * z0 + bary_clip[..., 1] * z1 + bary_clip[..., 2] * z2

    dist2 = point_triangle_distance2(p, v0xy, v1xy, v2xy)
    inside = torch.all(bary > 0.0, dim=-1)
    signed_dist = torch.where(inside, -dist2, dist2)

    empty = pix_to_face < 0
    zbuf = torch.where(empty, -1.0, pz)
    bary_out = torch.where(empty[..., None], -1.0, bary_clip)
    dists = torch.where(empty, -1.0, signed_dist)
    return zbuf, bary_out, dists


def interpolate_fragments(
    face_verts: torch.Tensor,  # (F, 3, 3) differentiable
    pix_to_face: torch.Tensor,  # (H, W, K) int, -1 = empty
    image_size: Tuple[int, int],
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
):
    """Differentiably recompute (zbuf, bary_coords, dists) for selected faces.

    Empty slots get zbuf = bary = dists = -1.  Autograd differentiates the
    gather; `rasterize_grad_plain` is the same gradient written out.
    """
    fv = face_verts[pix_to_face.clamp(min=0)]  # (H, W, K, 3, 3)
    return _fragments_from_gathered(
        fv, pix_to_face, image_size, perspective_correct, clip_barycentric_coords
    )


def rasterize_grad_plain(
    face_verts: torch.Tensor,  # (N, F, 3, 3)
    pix_to_face: torch.Tensor,  # (N, H, W, K) per-image local ids, -1 = empty
    gz: Optional[torch.Tensor],  # (N, H, W, K) or None (= 0)
    gbary: Optional[torch.Tensor],  # (N, H, W, K, 3) or None
    gdists: Optional[torch.Tensor],  # (N, H, W, K) or None
    image_size: Tuple[int, int],
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    row0: int = 0,
) -> torch.Tensor:
    """(N, F, 3, 3) gradient of (zbuf, bary, dists) w.r.t. `face_verts`.

    The JAX package's `_interp_bwd`: the VJP of `_fragments_from_gathered`
    on the per-pixel gathered verts (`torch.autograd.grad`), empty slots
    masked, scattered back to faces with `index_add_`.  It is the plain
    version of the CUDA backward kernel in `rasterize_cuda.py`.  The ids
    and cotangents may be a band of rows of the image, starting at `row0`.
    """
    N, F = face_verts.shape[:2]
    idx = pix_to_face.long()
    flat = (idx.clamp(min=0) + (torch.arange(N, device=idx.device) * F)[:, None, None, None])
    rows = idx.shape[1]
    pxy = pixel_centers_ndc(*image_size, face_verts.device, face_verts.dtype)[row0 : row0 + rows]
    with torch.enable_grad():
        fv = face_verts.detach().reshape(N * F, 3, 3)[flat].requires_grad_(True)
        outs = _fragments_from_gathered(
            fv, idx, image_size, perspective_correct, clip_barycentric_coords, pxy=pxy
        )
        pairs = [(o, g) for o, g in zip(outs, (gz, gbary, gdists)) if g is not None]
        if pairs:
            (gfv,) = torch.autograd.grad(
                [o for o, _ in pairs], fv, [g.to(o.dtype) for o, g in pairs]
            )
        else:
            gfv = torch.zeros_like(fv)
    gfv = torch.where((idx >= 0)[..., None, None], gfv, 0.0)
    grad = torch.zeros((N * F, 3, 3), dtype=gfv.dtype, device=gfv.device)
    grad.index_add_(0, flat.reshape(-1), gfv.reshape(-1, 3, 3))
    return grad.reshape(N, F, 3, 3)


# --------------------------------------------------------------------------- #
# Public entry (batched padded face verts)
# --------------------------------------------------------------------------- #


def rasterize_meshes(
    meshes,
    image_size: Union[int, Tuple[int, int]] = 256,
    blur_radius: float = 0.0,
    faces_per_pixel: int = 8,
    bin_size: Optional[int] = None,
    max_faces_per_bin: Optional[int] = None,
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    cull_backfaces: bool = False,
    z_clip_value: Optional[float] = None,
    cull_to_frustum: bool = False,
):
    """Rasterize a batch of meshes already in NDC-xy / view-z space.

    Returns (pix_to_face, zbuf, bary_coords, dists) with shapes
    (N, H, W, K), (N, H, W, K), (N, H, W, K, 3), (N, H, W, K).
    `pix_to_face` holds packed face indices (mesh n's faces live at rows
    [n*F, (n+1)*F)), or -1.

    CUDA tensors go through the fine kernel (`rasterize_cuda.py`), whose
    per-tile face lists are exact, so `max_faces_per_bin` is accepted for
    API parity only; `bin_size=0` asks for the plain path instead.

    With `z_clip_value` every face is first clipped at that view depth
    (`clip.py`): the rasterizer and its backward see (N, 2F) sub-faces,
    and the ids and barycentrics are mapped back to the original faces
    before the packed offset, which counts the original F.  zbuf and
    dists stay those of the sub-faces.
    """
    H, W = parse_image_size(image_size)
    from .rasterize_cuda import rasterize_fragments_cuda, rasterize_fragments_plain

    N, F = len(meshes), meshes.max_faces
    face_verts = meshes.verts_packed()[meshes.faces_packed()]  # (N*F, 3, 3)
    fv_batched = face_verts.reshape(N, F, 3, 3)
    mask_batched = meshes.faces_packed_mask().reshape(N, F)
    clipped = None
    if z_clip_value is not None:
        from .clip import clip_faces

        clipped = clip_faces(fv_batched, mask_batched, z_clip_value)
        fv_batched, mask_batched = clipped.face_verts, clipped.valid  # (N, 2F, ...)

    rasterize = rasterize_fragments_plain if bin_size == 0 else rasterize_fragments_cuda
    pix_local, zbuf, bary, dists = rasterize(
        fv_batched, mask_batched, (H, W), blur_radius, faces_per_pixel,
        perspective_correct, clip_barycentric_coords, cull_backfaces,
    )
    if clipped is not None:
        from .clip import convert_clipped_rasterization_to_original_faces

        pix_local, bary = convert_clipped_rasterization_to_original_faces(pix_local, bary, clipped)
    # Packed ids: mesh n's faces live at rows [n*F, (n+1)*F).
    offsets = (torch.arange(N, device=pix_local.device) * F)[:, None, None, None]
    pix_to_face = torch.where(pix_local >= 0, pix_local + offsets, -1)
    return pix_to_face, zbuf, bary, dists
