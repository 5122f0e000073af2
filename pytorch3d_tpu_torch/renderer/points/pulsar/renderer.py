"""Pulsar-style differentiable sphere renderer
(port of pytorch3d_tpu/renderer/points/pulsar/renderer.py).

Spheres project to NDC discs; per pixel the K = n_track nearest spheres
(ascending z) are selected, and their colours blend by the softmax of the
pulsar paper (arXiv:2004.07484, Eq. 2):

    w_i = o_i d_i exp(o_i z'_i / gamma) / (sum_j o_j d_j exp(o_j z'_j / gamma)
          + exp(eps / gamma))

with z'_i the normalized inverse depth in [0, 1] (closest = 1) and d_i the
in-disc closeness of the pixel centre.  On CUDA tensors the selection is
the select-only points kernel (#6, `select_points_cuda`) over one exact CSR
binning (`bin_points_for_pulsar`), and the blend's backward is the pulsar
gradient kernel (#8, `pulsar_blend_grads_cuda`) over the same binning; on
CPU tensors both are their plain PyTorch versions.  The projection, the
packed sphere table and the blend's forward are plain torch, so gradients
reach positions, radii, colours, opacities, the background colour and the
camera parameters.

Camera parameter vector: [px, py, pz, rx, ry, rz, focal_length,
sensor_width] with (rx, ry, rz) an axis-angle rotation; 10 floats add the
principal point offsets in pixels; 11 and 13 floats use the 6D rotation
representation in place of the axis angle.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ....transforms.rotation_conversions import axis_angle_to_matrix, rotation_6d_to_matrix
from ...mesh.rasterize_cuda import box_tiles
from ..rasterize_points_cuda import (
    bin_points_for_pulsar, point_boxes, pulsar_blend_grads_cuda, pulsar_depth_logit, pulsar_pixel_grid,
    select_points_cuda,
)

# mode=1 hit maps are refused above this many pixels, as in the JAX package
# (whose blend runs in row slabs there).
_HIT_MAP_MAX_PIXELS = 2 * 1024 * 1024


def _blend_core(table, idx, bg_col, gamma, min_depth, max_depth, bg_norm_depth, H, W):
    """The pulsar softmax blend over the K selected spheres per pixel.

    Returns (image, denom, logit_max, w_raw, g): the (H, W, C) image, the
    per-pixel environment the backward needs, and the per-hit weights and
    gathered table rows (for forward info)."""
    hit = idx >= 0
    ys, xs = pulsar_pixel_grid(H, W, table.dtype, table.device)
    g = table[idx.long().clamp(min=0)]  # (H, W, K, 5 + C)
    cx, cy, cz, cr, co = g.unbind(-1)[:5]
    d2 = (xs[None, :, None] - cx) ** 2 + (ys[:, None, None] - cy) ** 2
    closeness = torch.clamp(1.0 - d2 / (cr * cr), 0.0, 1.0)
    bg_logit = bg_norm_depth / gamma
    logit = torch.where(hit, pulsar_depth_logit(cz, co, gamma, min_depth, max_depth)[2], -torch.inf)
    logit_max = torch.clamp(logit.amax(dim=-1), min=bg_logit)  # the background in the shift
    w_raw = torch.where(hit, co * closeness * torch.exp(logit - logit_max[..., None]), 0.0)
    w_bg = torch.exp(bg_logit - logit_max)
    denom = w_raw.sum(-1) + w_bg
    image = ((w_raw[..., None] * g[..., 5:]).sum(-2) + w_bg[..., None] * bg_col) / denom[..., None]
    return image, denom, logit_max, w_raw, g


class _PulsarBlend(torch.autograd.Function):
    """The blend over the packed (P, 5 + C) table: its forward is the plain
    blend, its backward the pulsar gradient kernel on CUDA tensors and
    `pulsar_blend_grads_plain` on CPU tensors, plus d(bg_col)."""

    @staticmethod
    def forward(ctx, table, bg_col, idx, bins, gamma, min_depth, max_depth, bg_norm_depth, H, W):
        image, denom, logit_max, _, _ = _blend_core(
            table, idx, bg_col, gamma, min_depth, max_depth, bg_norm_depth, H, W
        )
        ctx.save_for_backward(table, idx, bg_col, denom, logit_max)
        ctx.bins = bins
        ctx.blend = (gamma, min_depth, max_depth, bg_norm_depth, H, W)
        return image

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        table, idx, bg_col, denom, logit_max = ctx.saved_tensors
        gamma, min_depth, max_depth, bg_norm_depth, H, W = ctx.blend
        ct = ct.to(table.dtype).contiguous()
        dtable = dbg = None
        if ctx.needs_input_grad[0]:
            dtable = pulsar_blend_grads_cuda(
                table.contiguous(), idx, ct, denom, logit_max, bg_col.to(table.dtype).contiguous(), (H, W),
                gamma, min_depth, max_depth, bg_norm_depth, ctx.bins,
            )
        if ctx.needs_input_grad[1]:
            # dI_c / dbg_c = w_bg / denom: w_bg depends on no sphere field.
            w_bg = torch.exp(bg_norm_depth / gamma - logit_max)
            dbg = (ct * (w_bg / denom)[..., None]).sum(dim=(0, 1))
        return dtable, dbg, None, None, None, None, None, None, None, None


class Renderer:
    """Pulsar renderer: spheres (positions, colours, radii, opacities) and a
    camera vector to an (H, W, C) image.  The device is the inputs'."""

    def __init__(
        self,
        width: int,
        height: int,
        max_num_balls: int,
        orthogonal_projection: bool = False,
        right_handed_system: bool = False,
        background_normalized_depth: float = 0.0,
        n_channels: int = 3,
        n_track: int = 5,
    ) -> None:
        self._width = width
        self._height = height
        self._max_num_balls = max_num_balls
        self._orthogonal = orthogonal_projection
        self._right_handed = right_handed_system
        self._bg_norm_depth = background_normalized_depth
        self._n_channels = n_channels
        self._n_track = n_track

    @staticmethod
    def _parse_cam(cam_params: torch.Tensor):
        """The {8, 10, 11, 13}-float layouts: axis-angle rotation at 8/10,
        6D rotation at 11/13, trailing principal-point offsets at 10/13."""
        n = cam_params.shape[0]
        if n in (11, 13):
            rot = rotation_6d_to_matrix(cam_params[3:9])
            focal, sensor_width = cam_params[9], cam_params[10]
            pp = cam_params[11:13] if n == 13 else None
        else:
            rot = axis_angle_to_matrix(cam_params[3:6])
            focal, sensor_width = cam_params[6], cam_params[7]
            pp = cam_params[8:10] if n == 10 else None
        return cam_params[0:3], rot, focal, sensor_width, pp

    def _project_ndc(self, vert_pos, vert_rad, cam_params, min_depth, max_depth):
        """Sphere centres and radii in NDC (+x left, as the point
        rasterizer's), view z, and the validity mask min_depth < z <
        max_depth."""
        H, W = self._height, self._width
        cam_pos, cam_rot, focal, sensor_width, pp = self._parse_cam(cam_params)
        view = (vert_pos - cam_pos[None]) @ cam_rot
        if self._right_handed:
            view = view * view.new_tensor([1.0, 1.0, -1.0])
        z = view[:, 2]
        if self._orthogonal:
            scale = 2.0 / sensor_width
            x_ndc, y_ndc, r_ndc = view[:, 0] * scale, view[:, 1] * scale, vert_rad * scale
        else:
            # perspective: NDC x = f X / Z / (sensor / 2)
            inv_z = 1.0 / torch.clamp(z, min=1e-6)
            scale = focal / (sensor_width / 2.0)
            x_ndc = view[:, 0] * inv_z * scale
            y_ndc = view[:, 1] * inv_z * scale
            r_ndc = vert_rad * inv_z * scale
        if pp is not None:  # principal-point offsets in pixels
            x_ndc = x_ndc + pp[0] / (0.5 * W)
            y_ndc = y_ndc + pp[1] / (0.5 * H)
        # pulsar's image +x is right; the point rasterizer's NDC +x is left.
        x_ndc = -x_ndc
        valid = (z > min_depth) & (z < max_depth)
        return torch.stack([x_ndc, y_ndc, z], dim=-1), r_ndc, valid

    def _select(self, pts_ndc, r_ndc, valid):
        """(H, W, K) selected sphere ids and the binning they came from
        (None on the CPU, where the plain selection runs)."""
        size = (self._height, self._width)
        pts, rad = pts_ndc.detach().contiguous(), r_ndc.detach().contiguous()
        bins = bin_points_for_pulsar(pts, rad, valid, size) if pts.device.type == "cuda" else None
        return select_points_cuda(pts, rad, valid, size, self._n_track, bins), bins

    def _prepare(self, vert_pos, vert_col, vert_rad, cam_params, min_depth, max_depth, opacity=None):
        """The blend's inputs: the packed (P, 5 + C) sphere table (x, y, z,
        r clipped at 1e-8, opacity, colours; differentiable), the (H, W, K)
        selected ids and their binning (None on the CPU)."""
        if opacity is None:
            opacity = torch.ones((vert_pos.shape[0],), dtype=vert_pos.dtype, device=vert_pos.device)
        pts_ndc, r_ndc, valid = self._project_ndc(vert_pos, vert_rad, cam_params, min_depth, max_depth)
        idx, bins = self._select(pts_ndc, r_ndc, valid)
        table = torch.cat(
            [pts_ndc, torch.clamp(r_ndc, min=1e-8)[:, None], opacity[:, None], vert_col], dim=-1
        )
        return table, idx, bins

    def compute_binning_hints(
        self,
        vert_pos: torch.Tensor,
        vert_rad: torch.Tensor,
        cam_params: torch.Tensor,
        max_depth: float,
        min_depth: float = 0.0,
    ) -> tuple:
        """(max_points_per_tile rounded up to a power of two, (y_tiles,
        x_tiles) the most tiles a sphere spans) of this scene on the port's
        16x16 tiles.  The port's binning is exact and sized at run time, so
        `forward` accepts these hints and does not need them."""
        size = (self._height, self._width)
        with torch.no_grad():
            pts, rad, valid = self._project_ndc(vert_pos, vert_rad, cam_params, min_depth, max_depth)
            tile_start = bin_points_for_pulsar(pts.contiguous(), rad.contiguous(), valid, size)[1]
            need = int((tile_start[1:] - tile_start[:-1]).max()) if tile_start.numel() > 1 else 0
            (_, ny), (_, nx) = box_tiles(*point_boxes(pts, rad, size), size)
            ok = valid & (pts[:, 2] >= 0)
            ty = int(torch.where(ok, ny, 0).max()) if ok.numel() else 0
            tx = int(torch.where(ok, nx, 0).max()) if ok.numel() else 0
        return 1 << max(need - 1, 0).bit_length(), (max(ty, 1), max(tx, 1))

    def forward(
        self,
        vert_pos: torch.Tensor,  # (P, 3)
        vert_col: torch.Tensor,  # (P, C)
        vert_rad: torch.Tensor,  # (P,)
        cam_params: torch.Tensor,  # (8,), (10,), (11,) or (13,)
        gamma: float,
        max_depth: float,
        min_depth: float = 0.0,
        bg_col: Optional[torch.Tensor] = None,
        opacity: Optional[torch.Tensor] = None,  # (P,)
        percent_allowed_difference: float = 0.01,
        max_n_hits: Optional[int] = None,
        mode: int = 0,
        return_forward_info: bool = False,
        binning_hints: Optional[tuple] = None,
    ):
        """Render the spheres to an (H, W, C) image; mode=1 returns the
        (H, W, 1) hit map instead.  `percent_allowed_difference`,
        `max_n_hits` and `binning_hints` are accepted for API parity: the
        selection is exact."""
        H, W = self._height, self._width
        if mode == 1 and H * W > _HIT_MAP_MAX_PIXELS:
            raise NotImplementedError("mode=1 hit maps above 2M pixels are not chunked yet")
        if bg_col is None:  # None means all ones
            bg_col = torch.ones((self._n_channels,), dtype=vert_col.dtype, device=vert_col.device)
        table, idx, bins = self._prepare(vert_pos, vert_col, vert_rad, cam_params, min_depth, max_depth, opacity)
        hit = idx >= 0

        if mode == 1:
            # hit map: the number of selected spheres whose disc covers the pixel
            with torch.no_grad():
                g = table[idx.long().clamp(min=0)]
                ys, xs = pulsar_pixel_grid(H, W, table.dtype, table.device)
                d2 = (xs[None, :, None] - g[..., 0]) ** 2 + (ys[:, None, None] - g[..., 1]) ** 2
                closeness = 1.0 - d2 / (g[..., 3] * g[..., 3])
                return (hit & (closeness > 0.0)).to(vert_pos.dtype).sum(-1)[..., None]

        image = _PulsarBlend.apply(
            table, bg_col, idx, bins, float(gamma), float(min_depth), float(max_depth),
            float(self._bg_norm_depth), H, W,
        )
        if not return_forward_info:
            return image
        with torch.no_grad():
            _, denom, _, w_raw, g = _blend_core(
                table, idx, bg_col, gamma, min_depth, max_depth, self._bg_norm_depth, H, W
            )
        info = {
            "closest_ids": idx,
            "weights": w_raw / denom[..., None],
            "depths": torch.where(hit, g[..., 2], -1.0),
        }
        return image, info

    __call__ = forward

    @staticmethod
    def sphere_ids_from_result_info_nograd(info) -> torch.Tensor:
        """Ids of the spheres hit per pixel, (H, W, K), -1 for none."""
        return info["closest_ids"]

    @staticmethod
    def depth_map_from_result_info_nograd(info) -> torch.Tensor:
        """The nearest hit's depth per pixel, -1 for none."""
        return info["depths"][..., 0]
