"""Point rasterization: the plain path and the dispatch
(port of pytorch3d_tpu/renderer/points/rasterize_points.py).

The rasterizer is split as in the JAX package:

1. **Selection** (not differentiable): for every pixel the K points of
   smallest z whose disc covers its center, ties to the lower point id.
   The plain version scans point chunks with a per-pixel running top-K
   buffer; on CUDA tensors the hand-written kernel of
   `rasterize_points_cuda.py` selects and emits the fragments.
2. **Recompute** (differentiable): gather the selected points and
   recompute zbuf and dists with plain torch; autograd carries gradients to
   the points.

Conventions: points are NDC xy (+X left, +Y up) with view-space z; pixel
(0, 0) is the top-left of the image; dists are squared NDC distances in the
image plane; radius is in NDC units.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ...common.gather import gather_rows
from ..mesh.rasterize_meshes import pixel_centers_ndc
from ..utils import parse_image_size

# (pixel, point) pairs the plain selection holds at once.
_PLAIN_CHUNK_PAIRS = 1 << 24


def _format_radius(radius, pointclouds) -> torch.Tensor:
    """A scalar, (N,), (N, P) or packed (N*P,) radius as a packed (N*P,)
    float32 per-point radius on the clouds' device."""
    N, P = len(pointclouds), pointclouds.max_points
    device = pointclouds.device
    if isinstance(radius, (float, int)):
        return torch.full((N * P,), float(radius), dtype=torch.float32, device=device)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=device)
    if radius.ndim == 1 and radius.shape[0] == N:
        return radius[:, None].expand(N, P).reshape(-1)
    if radius.ndim == 2:
        return radius.reshape(-1)
    if radius.ndim == 1 and radius.shape[0] == N * P:
        return radius
    raise ValueError("radius must be a float, (N,), (N, P) or packed array")


def point_distances2(pxy: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Squared image-plane distance of pixel centers to points, written
    (px-x)*(px-x) + (py-y)*(py-y) as the CUDA kernels compute it (built
    without FMA contraction): the same value bit for bit."""
    dx = pxy[..., 0] - xy[..., 0]
    dy = pxy[..., 1] - xy[..., 1]
    return dx * dx + dy * dy


def rasterize_points_topk(
    points: torch.Tensor,  # (P, 3) one cloud, NDC xy + view z
    radius: torch.Tensor,  # (P,)
    valid: torch.Tensor,  # (P,) bool
    image_size: Tuple[int, int],
    points_per_pixel: int = 8,
) -> torch.Tensor:
    """(H, W, K) per-pixel ascending-z point ids, -1 where fewer than K
    cover (JAX `rasterize_points_topk_xla`).

    Ties in z go to the lower point id: each chunk is sorted stably
    (`torch.topk` promises no order among ties) and merged stably with the
    running buffer, which holds only lower ids.
    """
    H, W = image_size
    P = points.shape[0]
    K = points_per_pixel
    device = points.device
    pxy = pixel_centers_ndc(H, W, device, points.dtype)[:, :, None, :]  # (H, W, 1, 2)
    ok = valid & (points[:, 2] >= 0)
    best_z = torch.full((H, W, K), torch.inf, dtype=points.dtype, device=device)
    best_idx = torch.full((H, W, K), -1, dtype=torch.int64, device=device)
    C = max(1, min(P, _PLAIN_CHUNK_PAIRS // (H * W)))
    for base in range(0, P, C):
        pc, rc = points[base : base + C], radius[base : base + C]
        covers = ok[base : base + C] & (point_distances2(pxy, pc[:, :2]) < rc * rc)
        pz = torch.where(covers, pc[:, 2], torch.inf)  # (H, W, c)
        chunk_z, local = torch.sort(pz, dim=-1, stable=True)
        chunk_z, local = chunk_z[..., :K], local[..., :K]
        chunk_idx = torch.where(torch.isinf(chunk_z), -1, base + local)
        all_z = torch.cat([best_z, chunk_z], dim=-1)
        all_idx = torch.cat([best_idx, chunk_idx], dim=-1)
        order = torch.sort(all_z, dim=-1, stable=True).indices[..., :K]
        best_z = torch.gather(all_z, -1, order)
        best_idx = torch.gather(all_idx, -1, order)
    return best_idx


def recompute_point_fragments(
    points: torch.Tensor,  # (N, P, 3) differentiable
    idx: torch.Tensor,  # (N, H, W, K) local ids, -1 = empty
    image_size: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (zbuf, dists) (N, H, W, K) at fixed selected ids;
    empty slots hold -1."""
    N, P = points.shape[:2]
    ids = idx.long()
    live = ids >= 0
    flat = torch.where(live, ids + (torch.arange(N, device=ids.device) * P)[:, None, None, None], -1)
    p = gather_rows(points.reshape(N * P, 3), flat)  # masked below
    pxy = pixel_centers_ndc(*image_size, points.device, points.dtype)[:, :, None, :]
    zbuf = torch.where(live, p[..., 2], -1.0)
    dists = torch.where(live, point_distances2(pxy, p[..., :2]), -1.0)
    return zbuf, dists


def rasterize_points_plain(
    points: torch.Tensor,  # (N, P, 3)
    radius: torch.Tensor,  # (N, P)
    valid: torch.Tensor,  # (N, P) bool
    image_size: Tuple[int, int],
    points_per_pixel: int = 8,
):
    """The plain PyTorch version of the CUDA kernel: `rasterize_points_topk`
    cloud by cloud, then `recompute_point_fragments`.

    Returns (idx, zbuf, dists) (N, H, W, K) with per-cloud local ids;
    zbuf and dists are differentiable with respect to `points`.
    """
    pts = points.detach()
    idx = torch.stack([
        rasterize_points_topk(p, r, m, image_size, points_per_pixel)
        for p, r, m in zip(pts, radius, valid)
    ]) if len(pts) else torch.full((0, *image_size, points_per_pixel), -1, dtype=torch.int64, device=pts.device)
    zbuf, dists = recompute_point_fragments(points, idx, image_size)
    return idx, zbuf, dists


def rasterize_points_grad_plain(
    points: torch.Tensor,  # (N, P, 3)
    idx: torch.Tensor,  # (N, H, W, K) per-cloud local ids, -1 = empty
    gz: Optional[torch.Tensor],  # (N, H, W, K) or None (= 0)
    gdists: Optional[torch.Tensor],  # (N, H, W, K) or None
    image_size: Tuple[int, int],
) -> torch.Tensor:
    """(N, P, 3) gradient of (zbuf, dists) w.r.t. `points`: the VJP of
    `recompute_point_fragments` (`torch.autograd.grad`; the gather's
    backward is an `index_add_` per point).  It is the plain version of the
    CUDA backward kernel in `rasterize_points_cuda.py`, in the points'
    dtype."""
    with torch.enable_grad():
        pts = points.detach().requires_grad_(True)
        outs = recompute_point_fragments(pts, idx, image_size)
        pairs = [(o, g) for o, g in zip(outs, (gz, gdists)) if g is not None]
        if not pairs:
            return torch.zeros_like(pts)
        (grad,) = torch.autograd.grad([o for o, _ in pairs], pts, [g.to(o.dtype) for o, g in pairs])
    return grad


def rasterize_points(
    pointclouds,
    image_size: Union[int, Tuple[int, int]] = 256,
    radius: Union[float, torch.Tensor] = 0.01,
    points_per_pixel: int = 8,
    bin_size: Optional[int] = None,
    max_points_per_bin: Optional[int] = None,
):
    """Rasterize clouds already in NDC-xy / view-z space.

    Returns (idx, zbuf, dists), each (N, H, W, K); idx holds packed point
    ids (cloud n's points live at rows [n*P, (n+1)*P)) or -1.

    CUDA tensors go through the points kernel (`rasterize_points_cuda.py`),
    whose per-tile point lists are exact, so `max_points_per_bin` is
    accepted for API parity only; `bin_size=0` asks for the plain path.
    """
    H, W = parse_image_size(image_size)
    from .rasterize_points_cuda import rasterize_points_cuda

    N, P = len(pointclouds), pointclouds.max_points
    rad = _format_radius(radius, pointclouds).reshape(N, P).contiguous()
    rasterize = rasterize_points_plain if bin_size == 0 else rasterize_points_cuda
    idx_local, zbuf, dists = rasterize(
        pointclouds.points_padded().contiguous(), rad, pointclouds.points_padded_mask(), (H, W),
        points_per_pixel,
    )
    offsets = (torch.arange(N, device=idx_local.device) * P)[:, None, None, None]
    idx = torch.where(idx_local >= 0, idx_local.long() + offsets, -1)
    return idx, zbuf, dists


def rasterize_points_python(pointclouds, image_size=256, radius=0.01, points_per_pixel=8):
    """PyTorch3D's name for the plain version: `rasterize_points` on the
    plain path (`bin_size=0`) on any device."""
    return rasterize_points(pointclouds, image_size, radius, points_per_pixel, bin_size=0)
