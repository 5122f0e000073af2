"""Pixel-row-sharded rasterization over a mesh of ranks (port of
pytorch3d_tpu/parallel/raster.py).

The image's H rows are split over the mesh's "rays" axis:

- the face list is small and replicated: every rank holds all of it;
- each rank rasterizes its own band of rows against all faces, on the card
  through the band build of the fine kernel (`rasterize_fragments_band_cuda`,
  which equals those rows of the full image's fragments bit for bit), on
  the CPU through its plain version;
- the bands are all-gathered, so every rank returns the full (H, W, K)
  outputs, as `shard_map`'s `out_specs=P(axis)` gives them to a caller;
- the backward takes each rank's band of the cotangents through the band
  build of the backward kernel and sums the face-vertex gradient over the
  group (an all-reduce: `shard_map`'s psum).

Unlike the JAX package's Pallas route, whose band must be a multiple of a
K- and F-dependent tile height (parallel/raster.py:150-160 there), any
split with H % n == 0 works: the band kernels take a pixel-row offset.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..renderer.mesh.rasterize_cuda import rasterize_fragments_band_cuda
from .mesh import DeviceMesh


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward; the backward all-reduces (sums) the gradient over
    `group` (None: one rank, nothing to sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.group is not None:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherBands(torch.autograd.Function):
    """All-gather each rank's (1, h, ...) band along dim 1 in rank order;
    the backward hands each rank its own band of the cotangent."""

    @staticmethod
    def forward(ctx, group, n, index, *bands):
        ctx.band = (index, bands[0].shape[1])
        out = []
        for b in bands:
            if group is None:
                out.append(b.clone())
                continue
            parts = [torch.empty_like(b) for _ in range(n)]
            dist.all_gather(parts, b.contiguous(), group=group)
            out.append(torch.cat(parts, dim=1))
        ctx.mark_non_differentiable(*(o for o in out if not o.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        index, h = ctx.band
        return (None, None, None, *(None if g is None else g[:, index * h : (index + 1) * h] for g in grads))


def rasterize_fragments_shard_map(
    face_verts: torch.Tensor,  # (F, 3, 3) NDC xy + view z
    valid: torch.Tensor,  # (F,) bool
    image_size: Tuple[int, int],
    mesh: DeviceMesh,
    axis: str = "rays",
    blur_radius: float = 0.0,
    faces_per_pixel: int = 1,
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    cull_backfaces: bool = False,
):
    """Row-band sharded rasterization (differentiable with respect to
    face_verts): (pix_to_face, zbuf, bary, dists) of shapes (H, W, K) and
    (H, W, K, 3), the same on every rank of the `axis` group.

    Rank r of the group rasterizes rows [r H / n, (r + 1) H / n): through
    the band kernel for CUDA tensors, through its plain version for CPU
    tensors.  H % n != 0 raises.
    """
    H, W = image_size
    n = mesh.size(axis)
    if H % n != 0:
        raise ValueError(f"image height {H} must divide the '{axis}' axis size {n}")
    h = H // n
    index = mesh.coordinate(axis)
    group = mesh.group(axis) if n > 1 else None
    fv = _SumGradOverGroup.apply(face_verts, group)
    idx, zbuf, bary, dists = rasterize_fragments_band_cuda(
        fv[None], valid[None], index * h, h, (H, W), blur_radius, faces_per_pixel,
        perspective_correct, clip_barycentric_coords, cull_backfaces,
    )
    outs = _GatherBands.apply(group, n, index, idx.to(torch.int32), zbuf, bary, dists)
    return tuple(t[0] for t in outs)


def sharded_silhouette_loss_and_grad(
    face_verts: torch.Tensor,
    valid: torch.Tensor,
    image_size: Tuple[int, int],
    mesh: DeviceMesh,
    axis: str = "rays",
    blur_radius: float = 1e-4,
    faces_per_pixel: int = 8,
    sigma: float = 1e-4,
):
    """(loss, d loss / d face_verts) of the soft-silhouette loss through
    the sharded rasterizer: mean over pixels of
    1 - prod_k (1 - sigmoid(-dists / sigma)) (JAX :115-138)."""
    fv = face_verts.detach().requires_grad_(True)
    with torch.enable_grad():
        _, _, _, dists = rasterize_fragments_shard_map(
            fv, valid, image_size, mesh, axis, blur_radius, faces_per_pixel,
        )
        alpha = 1.0 - torch.prod(1.0 - torch.sigmoid(-dists / sigma), dim=-1)
        loss = torch.mean(alpha)
        (grad,) = torch.autograd.grad(loss, fv)
    return loss.detach(), grad
