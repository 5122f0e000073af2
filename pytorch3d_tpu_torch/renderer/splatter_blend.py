"""Splatter blending, differentiable surface splatting
(port of pytorch3d_tpu/renderer/splatter_blend.py).

`SplatterPhongShader` pairs it with the rasterizer: each fragment's colour
is splatted onto the 3x3 pixels around it with Gaussian weights of its
screen position, so the vertex gradient flows through the positions.

1. Per-fragment screen positions from the detached barycentrics and the
   vertex positions (exactly the pixel centres in the forward).
2. Occlusion layers: each of the 9 neighbours p of a pixel q is matched to
   q's rasterized layers by depth (same surface, in front, behind).
3. Gaussian splat weights per direction, normalised by the kernel's sum
   (+5 %, so that gradients flow at pixels inside a surface too).
4. Each direction's splats shifted onto their target pixels with zero
   padding (no wraparound) and added into three buffers (background,
   surface, foreground).
5. Each buffer normalised by its weight, then composited back to front
   over the background colour.

Everything is elementwise on (N, H, W, K, ...) tensors; nothing scatters.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..common.gather import gather_rows
from .blending import BlendParams

# The 9 splat displacements in (dy, dx) = (row, column) order.
_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[:, h, w] = x[:, h + dy, w + dx], zero-padded at the borders."""
    H, W = x.shape[1], x.shape[2]
    xp = torch.nn.functional.pad(x, [0, 0] * (x.ndim - 3) + [1, 1, 1, 1])
    return xp[:, 1 + dy : H + 1 + dy, 1 + dx : W + 1 + dx]


def _compute_occlusion_layers(q_depth: torch.Tensor) -> torch.Tensor:
    """(N, H, W, K) fragment depths -> (N, H, W, 9) int occlusion offsets.

    For each direction d, the index of q's layer whose depth matches the
    top layer splatting in from d: 0 = the same surface, > 0 = the splat
    lies in front of q's surface, < 0 = its top layer matches a deeper
    layer of q (background)."""
    p_depth = torch.stack([_shift2d(q_depth, dy, dx) for (dy, dx) in _OFFSETS], dim=3)  # (N, H, W, 9, K)
    q_d = q_depth[:, :, :, None, :]  # (N, H, W, 1, K)
    qtop_to_p = torch.abs(p_depth - q_d[..., 0:1])  # the p layer closest to q's top layer
    qtop_closest = torch.amin(qtop_to_p, dim=-1)
    qtop_closest_id = torch.argmin(qtop_to_p, dim=-1)
    ptop_to_q = torch.abs(p_depth[..., 0:1] - q_d)  # the q layer closest to p's top layer
    ptop_closest = torch.amin(ptop_to_q, dim=-1)
    ptop_closest_id = torch.argmin(ptop_to_q, dim=-1)
    return torch.where(ptop_closest < qtop_closest, -ptop_closest_id, qtop_closest_id)


def _splat_kernel_normalization(sigma: float) -> float:
    """(1 + 0.05) / sum over directions of exp(-|d|^2 / 2 sigma^2), each
    exponential taken in float32 as the JAX package takes it."""
    total = sum(
        float(torch.exp(torch.tensor(-(dy * dy + dx * dx) / (2.0 * sigma**2), dtype=torch.float32)))
        for (dy, dx) in _OFFSETS
    )
    return (1.0 + 0.05) / total


class SplatterBlender:
    """Occlusion-aware 9-tap splatting blender."""

    def __init__(self, input_shape: Tuple[int, ...] = (), device=None) -> None:
        pass  # no precomputed state: the shifts are static slices

    def __call__(
        self,
        colors: torch.Tensor,  # (N, H, W, K, 4) shaded colors + alpha
        pixel_coords_screen: torch.Tensor,  # (N, H, W, K, 2 or 3) positions
        fragments,
        blend_params: BlendParams,
    ) -> torch.Tensor:
        """Splat and composite the occlusion layers: (N, H, W, 4)."""
        N, H, W, K, _ = colors.shape
        sigma = blend_params.sigma if blend_params.sigma else 0.5
        bg_mask = fragments.pix_to_face < 0  # (N, H, W, K)

        # background fragments: alpha 0, colors 0, depth at the far plane
        alpha = torch.where(bg_mask, 0.0, colors[..., 3])
        colors = torch.where(bg_mask[..., None], 0.0, colors)
        depth = torch.where(bg_mask, 1.0, fragments.zbuf)
        occlusion = _compute_occlusion_layers(depth)  # (N, H, W, 9)

        # Each splat's offset from its own pixel centre: 0 in the forward, it
        # carries the vertex gradient.  With screen x = -(col + .5) and
        # y = -(row + .5) (no xy flip), a point moving right by d pixels
        # gives cx = +d and one moving down cy = +d.
        xy = pixel_coords_screen[..., :2]
        q_to_center = torch.floor(xy) - xy + 0.5
        cx, cy = q_to_center[..., 0], q_to_center[..., 1]

        norm_const = _splat_kernel_normalization(sigma)
        inv2s2 = 1.0 / (2.0 * sigma**2)
        accum = [colors.new_zeros((N, H, W, K, 5)) for _ in range(3)]  # background / surface / foreground
        layer_ids = torch.arange(K, device=colors.device)
        for d, (dy, dx) in enumerate(_OFFSETS):
            # the splat from p lands on q = p - (dy, dx); its Gaussian distance
            # to q's centre is |(cx, cy) + (dx, dy)|
            d2 = (cx + dx) ** 2 + (cy + dy) ** 2
            w = torch.exp(-d2 * inv2s2) * alpha * norm_const  # (N, H, W, K)
            cw = torch.cat([colors * w[..., None], w[..., None]], dim=-1)  # (N, H, W, K, 5) at p
            cw_at_q = _shift2d(cw, dy, dx)  # out[q] = cw[p], p = q + (dy, dx)
            occ_d = occlusion[:, :, :, None, d]  # (N, H, W, 1)
            masks = (occ_d < layer_ids, occ_d == layer_ids, occ_d > layer_ids)
            for i, m in enumerate(masks):
                accum[i] = accum[i] + cw_at_q * m[..., None]

        # the K layers of each buffer summed, normalised by their weight (>= 1)
        buffers = []
        for i in range(3):
            tot = torch.sum(accum[i], dim=3)  # (N, H, W, 5)
            scale = 1.0 / torch.clamp(tot[..., 4:5], min=1.0)
            buffers.append(tot[..., :4] * scale)

        bg = torch.as_tensor(blend_params.background_color, dtype=colors.dtype, device=colors.device)
        out = torch.cat([bg, bg.new_zeros(1)]).expand(N, H, W, 4)
        for buf in buffers:  # background, surface, foreground
            a = buf[..., 3:4]
            out = buf + (1.0 - a) * out
        return out


def pixel_coords_screen_from_fragments(fragments, meshes, cameras, image_size):
    """Differentiable per-fragment screen positions (N, H, W, K, 2).

    The world positions are the face's vertices weighted by the DETACHED
    barycentrics: with differentiable ones the point stays on the pixel
    centre's ray and its projection has no vertex gradient, which is what
    splatting is for.  Projected with `transform_points_screen(
    with_xyflip=False)`, so forward values are (col + .5, row + .5) up to
    sign.  Empty slots take the centroid of the face they gather, which
    stays finite under the projection; the blender gives them weight 0.
    """
    H, W = image_size
    verts = meshes.verts_padded()  # world space
    N = verts.shape[0]
    faces_verts = verts.reshape(-1, 3)[meshes.faces_packed().clamp(min=0)]  # (F, 3, 3)
    fv = gather_rows(faces_verts, fragments.pix_to_face)  # (N, H, W, K, 3, 3)
    bary = fragments.bary_coords.detach()
    bary = torch.where((fragments.pix_to_face >= 0)[..., None], bary, 1.0 / 3.0)
    pix_world = bary[..., 0:1] * fv[..., 0, :] + bary[..., 1:2] * fv[..., 1, :] + bary[..., 2:3] * fv[..., 2, :]
    screen = cameras.transform_points_screen(
        pix_world.reshape(N, -1, 3), image_size=(H, W), with_xyflip=False
    ).reshape(N, H, W, -1, 3)
    return screen[..., :2]
