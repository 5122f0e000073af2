"""Bilinear / trilinear grid sampling (port of pytorch3d_tpu/ops/grid_sample.py).

The JAX package's arithmetic, not `torch.nn.functional.grid_sample`'s:
`nearest` rounds half to even, `border` clamps the integer corner indices
(not the coordinates), and every `padding_mode` other than `border`,
`reflection` included, takes the zeros branch.  `grid` values lie in
[-1, 1], its last axis ordered (x, y) for 4D input and (x, y, z) for 5D,
where x indexes W, y indexes H and z indexes D.

The corners are row gathers of a channel-last table (`index_select`, whose
backward is an `index_add_`).  `sample_channels_last` is the 2D case on an
(N, H, W, C) image, which `TexturesUV` calls on its maps as they are stored.
"""

from __future__ import annotations

from typing import Optional

import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _corner(table: torch.Tensor, idx, sizes, base: torch.Tensor, padding_mode: str,
            spread: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows of the channel-last `table` (N * prod(sizes), C) at integer
    indices `idx` (slowest axis first, each shaped like `base`), 0 where a
    zeros-padded corner falls off the image.  `base` is each sample's image
    offset n * prod(sizes).  Where `spread` (flat row ids, -1 elsewhere)
    holds a row, the sample reads it instead: the caller replaces those
    samples' values."""
    valid = None
    flat = base
    for i, n in zip(idx, sizes):
        if padding_mode != "border":
            ok = (i >= 0) & (i <= n - 1)
            valid = ok if valid is None else valid & ok
        flat = flat * n + i.clamp(0, n - 1)
    flat = flat.reshape(-1)
    if spread is not None:
        flat = torch.where(spread >= 0, spread, flat)
    rows = table.index_select(0, flat).reshape(*base.shape, table.shape[1])
    return rows if valid is None else torch.where(valid[..., None], rows, 0.0)


def sample_channels_last(
    image: torch.Tensor,  # (N, H, W, C)
    x: torch.Tensor,  # (N, ...) grid x in [-1, 1]
    y: torch.Tensor,  # (N, ...) grid y in [-1, 1]
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
    spread: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2D `grid_sample` of a channel-last image: (N, ..., C).

    `spread` (bool, shaped like x) marks samples whose values the caller
    discards; they gather from rows spread over the image, so that the
    backward does not pile their zero gradients onto one texel."""
    N, H, W, C = image.shape
    table = image.reshape(N * H * W, C)
    if spread is not None:
        flat = spread.reshape(-1)
        spread = torch.where(flat, torch.arange(flat.numel(), device=flat.device) % table.shape[0], -1)
    xf = _unnormalize(x, W, align_corners)
    yf = _unnormalize(y, H, align_corners)
    base = torch.arange(N, device=x.device).reshape(N, *([1] * (x.ndim - 1))).expand(x.shape)
    if mode == "nearest":
        ix = torch.round(xf).long()
        iy = torch.round(yf).long()
        return _corner(table, (iy, ix), (H, W), base, padding_mode, spread)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    wx = (xf - x0)[..., None]
    wy = (yf - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    v00 = _corner(table, (y0, x0), (H, W), base, padding_mode, spread)
    v01 = _corner(table, (y0, x0 + 1), (H, W), base, padding_mode, spread)
    v10 = _corner(table, (y0 + 1, x0), (H, W), base, padding_mode, spread)
    v11 = _corner(table, (y0 + 1, x0 + 1), (H, W), base, padding_mode, spread)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _sample_3d(vol, x, y, z, mode, padding_mode, align_corners):
    """3D sampling of a channel-last volume (N, D, H, W, C): (N, ..., C)."""
    N, D, H, W, C = vol.shape
    table = vol.reshape(N * D * H * W, C)
    xf = _unnormalize(x, W, align_corners)
    yf = _unnormalize(y, H, align_corners)
    zf = _unnormalize(z, D, align_corners)
    base = torch.arange(N, device=x.device).reshape(N, *([1] * (x.ndim - 1))).expand(x.shape)
    sizes = (D, H, W)
    if mode == "nearest":
        idx = tuple(torch.round(c).long() for c in (zf, yf, xf))
        return _corner(table, idx, sizes, base, padding_mode, None)
    x0, y0, z0 = torch.floor(xf), torch.floor(yf), torch.floor(zf)
    wx, wy, wz = xf - x0, yf - y0, zf - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    out = 0.0
    for dz, fz in ((0, 1 - wz), (1, wz)):
        for dy, fy in ((0, 1 - wy), (1, wy)):
            for dx, fx in ((0, 1 - wx), (1, wx)):
                v = _corner(table, (z0 + dz, y0 + dy, x0 + dx), sizes, base, padding_mode, None)
                out = out + v * (fx * fy * fz)[..., None]
    return out


def grid_sample(
    input: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """2D: input (N, C, H, W), grid (N, Ho, Wo, 2) -> (N, C, Ho, Wo).
    3D: input (N, C, D, H, W), grid (N, Do, Ho, Wo, 3) -> (N, C, Do, Ho, Wo).
    """
    if input.ndim == 4:
        out = sample_channels_last(
            input.permute(0, 2, 3, 1).contiguous(), grid[..., 0], grid[..., 1],
            mode, padding_mode, align_corners,
        )
    elif input.ndim == 5:
        out = _sample_3d(
            input.permute(0, 2, 3, 4, 1).contiguous(), grid[..., 0], grid[..., 1], grid[..., 2],
            mode, padding_mode, align_corners,
        )
    else:
        raise ValueError(f"grid_sample expects 4D or 5D input; got {input.ndim}D")
    return torch.movedim(out, -1, 1)
