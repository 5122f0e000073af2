"""The points-rasterizer kernels: binning, wrappers and the autograd op
(port of pytorch3d_tpu/renderer/points/rasterize_points_pallas.py).

`rasterize_points_cuda` replaces the TPU kernel `_fine_kernel`
(rasterize_points_pallas.py:285, its pallas_call at :497 in `_rpf_fwd`
behind `rasterize_points_fragments_pallas` :428).  On CUDA tensors it bins
the points to 16x16 pixel tiles with plain torch (`bin_points`) and
launches the hand-written kernel `csrc/rasterize_points.cu` once for the
whole batch; on CPU tensors it runs `rasterize_points_plain`, the plain
PyTorch version the kernel is held against on the card.  The kernel tests
a point only in the warps whose 4x8 pixel rectangle its pixel box meets,
the box it finds for itself from the point's own test on each axis (its
header says why that cull is exact); its outputs equal, bit for bit, those
of the design before the cull, which tested every pixel of a tile against
the tile's whole list.

Its backward, `rasterize_points_grad_cuda`, replaces the TPU kernel
`_grad_kernel` (rasterize_points_pallas.py:365, its pallas_call at :562 in
`_rpf_bwd`): on CUDA tensors it launches `csrc/rasterize_points_grad.cu`,
per-tile point sums over the forward's binning and then a fixed-order sum
per point (`face_pair_rows`), so two runs give the same bits; on CPU
tensors it runs `rasterize_points_grad_plain`.  Each source's header says
what bounds it on an H100 and how its design meets that.

Pulsar's two kernels sit here too.  `select_points_cuda` replaces the
select-only `_fine_kernel` (rasterize_points_pallas.py:285, its pallas_call
at :791 in `select_from_binned` :766): the ids-only build of
`csrc/rasterize_points.cu` (the same walk, storing ids only) over
`bin_points_for_pulsar`'s binning, with `rasterize_points_topk` as its
plain version.  `pulsar_blend_grads_cuda`
replaces `_pulsar_grad_kernel` (:618, its pallas_call at :905 in
`pulsar_blend_grads` :830): `csrc/pulsar_grad.cu` over the same binning,
with `pulsar_blend_grads_plain` as its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ... import _build
from ..mesh.rasterize_cuda import TILE, _pixel_grid, _ptr, bin_boxes, face_pair_rows, half_pixel
from ..mesh.rasterize_meshes import pixel_grid_ndc
from .rasterize_points import rasterize_points_grad_plain, rasterize_points_plain, rasterize_points_topk

MAX_POINTS_PER_PIXEL = 64  # largest K bucket the kernel is built for


def bin_points(
    points: torch.Tensor,  # (N, P, 3) NDC xy + view z
    radius: torch.Tensor,  # (N, P)
    valid: torch.Tensor,  # (N, P) bool
    image_size: Tuple[int, int],
):
    """Per-tile point lists as CSR: (tile_points, tile_start, n_ty, n_tx),
    from `bin_boxes` on each live point's box, center +- |radius| grown by
    half a pixel (as `_tile_axis_masks` at rasterize_points_pallas.py:38-70).
    Live points are the valid ones with z >= 0; the lists hold them in
    ascending id and are exact: no capacity, nothing dropped."""
    ok = valid & (points[..., 2] >= 0)
    return bin_boxes(*point_boxes(points, radius, image_size), ok, image_size)


def point_boxes(points: torch.Tensor, radius: torch.Tensor, image_size: Tuple[int, int]):
    """(xmin, xmax, ymin, ymax) of each point's box: its center +- |radius|
    grown by half a pixel."""
    grow = radius.abs() + half_pixel(*image_size)
    x, y = points[..., 0], points[..., 1]
    return x - grow, x + grow, y - grow, y + grow


def _library() -> ctypes.CDLL:
    lib = _build.load("rasterize_points")
    if not lib.select_points.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.select_points.argtypes = [p] * 6 + [i] * 7 + [p] * 2
        lib.select_points.restype = ctypes.c_int
    if not lib.rasterize_points.argtypes:
        rows, cols = ctypes.c_int(), ctypes.c_int()
        lib.rasterize_points_tile(ctypes.byref(rows), ctypes.byref(cols))
        if (rows.value, cols.value) != TILE:
            raise RuntimeError(
                f"rasterize_points.cu rasterizes {rows.value}x{cols.value} tiles but"
                f" the binning makes {TILE[0]}x{TILE[1]} tiles"
            )
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_points.argtypes = [p] * 6 + [i] * 7 + [p] * 4
        lib.rasterize_points.restype = ctypes.c_int
    return lib


def _grad_library() -> ctypes.CDLL:
    lib = _build.load("rasterize_points_grad")
    if not lib.rasterize_points_grad.argtypes:
        rows, cols = ctypes.c_int(), ctypes.c_int()
        lib.rasterize_points_grad_tile(ctypes.byref(rows), ctypes.byref(cols))
        if (rows.value, cols.value) != TILE:
            raise RuntimeError(
                f"rasterize_points_grad.cu sums {rows.value}x{cols.value} tiles but"
                f" the binning makes {TILE[0]}x{TILE[1]} tiles"
            )
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_points_grad.argtypes = [p] * 10 + [i] * 7 + [p] * 4
        lib.rasterize_points_grad.restype = ctypes.c_int
    return lib


def _run_kernel(points, radius, bins, image_size, K):
    """One launch of the points kernel over binned points; counts the launch."""
    tile_points, tile_start, n_ty, n_tx = bins
    N, P = points.shape[:2]
    H, W = image_size
    device = points.device
    idx = torch.empty((N, H, W, K), dtype=torch.int32, device=device)
    zbuf = torch.empty((N, H, W, K), dtype=torch.float32, device=device)
    dists = torch.empty((N, H, W, K), dtype=torch.float32, device=device)
    if N == 0:
        return idx, zbuf, dists
    if P == 0:
        return idx.fill_(-1), zbuf.fill_(-1.0), dists.fill_(-1.0)
    ys, xs = pixel_grid_ndc(H, W, device)
    lib = _library()
    with torch.cuda.device(device):  # launch in the tensors' context
        err = lib.rasterize_points(
            points.data_ptr(), radius.data_ptr(), tile_points.data_ptr(), tile_start.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), N, P, H, W, n_ty, n_tx, K,
            idx.data_ptr(), zbuf.data_ptr(), dists.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_points launch failed: CUDA error {err}")
    rasterize_points_cuda.launches += 1
    return idx, zbuf, dists


def rasterize_points_grad_cuda(
    points: torch.Tensor,  # (N, P, 3)
    idx: torch.Tensor,  # (N, H, W, K) int32 local ids, -1 = empty
    gz: Optional[torch.Tensor],  # (N, H, W, K) or None (= 0)
    gdists: Optional[torch.Tensor],  # (N, H, W, K) or None
    image_size: Tuple[int, int],
    bins=None,  # the forward's `bin_points` (tile_points, tile_start, n_ty, n_tx)
) -> torch.Tensor:
    """(N, P, 3) gradient of (zbuf, dists) w.r.t. `points`.

    CUDA tensors launch the backward kernel (and count the launch in
    `rasterize_points_grad_cuda.launches`) over `bins`, the binning the
    forward rasterized `idx` with; CPU tensors run the plain version, which
    needs no binning.  The kernel takes float32 contiguous tensors and int32
    ids; anything else raises.  It sums per (tile, point) pair of `bins`,
    then each point's pairs in ascending tile order: no atomics, so two runs
    on the same inputs give the same bits.  A filled slot whose point is
    missing from its tile's list in `bins` makes that point's row NaN, and
    an id >= P every row of its cloud: the fault shows without a host sync.
    """
    if points.device.type == "cpu":
        return rasterize_points_grad_plain(points, idx, gz, gdists, image_size)
    if points.device.type != "cuda":
        raise ValueError(f"rasterize_points_grad_cuda: unsupported device {points.device}")
    if points.dtype != torch.float32 or points.ndim != 3 or points.shape[2] != 3:
        raise TypeError("rasterize_points_grad_cuda: points must be a float32 (N, P, 3) tensor")
    N, P = points.shape[:2]
    if idx.dtype != torch.int32 or idx.ndim != 4 or idx.shape[0] != N or idx.device != points.device:
        raise TypeError("rasterize_points_grad_cuda: idx must be an int32 (N, H, W, K) tensor on the points' device")
    H, W = image_size
    if idx.shape[1:3] != (H, W):
        raise ValueError(f"rasterize_points_grad_cuda: idx {tuple(idx.shape)} is not {H}x{W}")
    if idx.shape[3] > MAX_POINTS_PER_PIXEL:
        raise ValueError(
            f"rasterize_points_grad_cuda: K={idx.shape[3]} is past the forward kernel's {MAX_POINTS_PER_PIXEL}"
        )
    for name, g in (("gz", gz), ("gdists", gdists)):
        if g is None:
            continue
        if g.dtype != torch.float32 or g.shape != idx.shape or g.device != points.device:
            raise TypeError(f"rasterize_points_grad_cuda: {name} must be float32 {tuple(idx.shape)} on the points' device")
        if not g.is_contiguous():
            raise ValueError(f"rasterize_points_grad_cuda: {name} must be contiguous")
    if not (points.is_contiguous() and idx.is_contiguous()):
        raise ValueError("rasterize_points_grad_cuda: points and idx must be contiguous")
    if bins is None:
        raise ValueError("rasterize_points_grad_cuda: CUDA tensors need the binning the ids were rasterized on")
    device = points.device
    if points.numel() == 0 or idx.numel() == 0 or (gz is None and gdists is None):
        return torch.zeros((N, P, 3), dtype=torch.float32, device=device)
    tile_points, tile_start, n_ty, n_tx = bins
    if (n_ty, n_tx) != (-(-H // TILE[0]), -(-W // TILE[1])) or tile_start.numel() != N * n_ty * n_tx + 1:
        raise ValueError(f"rasterize_points_grad_cuda: bins of {n_ty}x{n_tx} tiles are not of {N} {H}x{W} images")
    if any(t.dtype != torch.int32 or t.device != device or not t.is_contiguous() for t in (tile_points, tile_start)):
        raise TypeError("rasterize_points_grad_cuda: bins must be contiguous int32 tensors on the points' device")
    pair_rows, point_start = face_pair_rows(tile_points, tile_start, N, P)
    gpair = torch.empty((max(tile_points.numel(), 1), 3), dtype=torch.float32, device=device)
    flagged = torch.zeros((N * P + N,), dtype=torch.int32, device=device)
    grad = torch.empty((N, P, 3), dtype=torch.float32, device=device)
    ys, xs = _pixel_grid(H, W, device)
    lib = _grad_library()
    with torch.cuda.device(device):
        err = lib.rasterize_points_grad(
            points.data_ptr(), tile_points.data_ptr(), tile_start.data_ptr(), pair_rows.data_ptr(),
            point_start.data_ptr(), idx.data_ptr(), _ptr(gz), _ptr(gdists), xs.data_ptr(), ys.data_ptr(),
            N, P, H, W, idx.shape[3], n_ty, n_tx, gpair.data_ptr(), flagged.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_points_grad launch failed: CUDA error {err}")
    rasterize_points_grad_cuda.launches += 1
    return grad


rasterize_points_grad_cuda.launches = 0


class _RasterizePoints(torch.autograd.Function):
    """The CUDA points rasterizer as an autograd op: forward and backward
    are the two kernels."""

    @staticmethod
    def forward(ctx, points, radius, valid, image_size, K):
        pts = points.detach()
        bins = bin_points(pts, radius, valid, image_size)
        idx, zbuf, dists = _run_kernel(pts, radius, bins, image_size, K)
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        ctx.save_for_backward(pts, idx, bins[0], bins[1])  # the backward sums over the same tiles
        ctx.raster = (image_size, bins[2], bins[3])
        return idx, zbuf, dists

    @staticmethod
    @once_differentiable
    def backward(ctx, _gidx, gz, gdists):
        pts, idx, tile_points, tile_start = ctx.saved_tensors
        image_size, n_ty, n_tx = ctx.raster
        gz, gdists = (None if g is None else g.float().contiguous() for g in (gz, gdists))
        grad = rasterize_points_grad_cuda(pts, idx, gz, gdists, image_size, (tile_points, tile_start, n_ty, n_tx))
        return grad, None, None, None, None


def rasterize_points_cuda(
    points: torch.Tensor,  # (N, P, 3) NDC xy + view z
    radius: torch.Tensor,  # (N, P)
    valid: torch.Tensor,  # (N, P) bool
    image_size: Tuple[int, int],
    points_per_pixel: int = 8,
):
    """(idx, zbuf, dists) (N, H, W, K) of a batch, per-cloud local point ids.

    CUDA tensors launch the points kernel (and count the launch in
    `rasterize_points_cuda.launches`); CPU tensors run the plain version.
    The per-tile point lists are exact, so nothing is dropped at any
    density (the JAX Pallas path drops points past its per-tile capacity,
    `_resolve_mpt` at rasterize_points_pallas.py:450-463; its XLA path does
    not).  Anything the kernel does not take raises.
    """
    if points.device.type == "cpu":
        return rasterize_points_plain(points, radius, valid, image_size, points_per_pixel)
    if points.device.type != "cuda":
        raise ValueError(f"rasterize_points_cuda: unsupported device {points.device}")
    if points.dtype != torch.float32:
        raise TypeError(f"rasterize_points_cuda: points must be float32, got {points.dtype}")
    if points.ndim != 3 or points.shape[2] != 3:
        raise ValueError(f"rasterize_points_cuda: points must be (N, P, 3), got {tuple(points.shape)}")
    if not (points.is_contiguous() and radius.is_contiguous()):
        raise ValueError("rasterize_points_cuda: points and radius must be contiguous")
    for name, t, dtype in (("radius", radius, torch.float32), ("valid", valid, torch.bool)):
        if t.shape != points.shape[:2] or t.dtype != dtype or t.device != points.device:
            raise ValueError(f"rasterize_points_cuda: {name} must be an (N, P) {dtype} tensor on the points' device")
    if not 1 <= points_per_pixel <= MAX_POINTS_PER_PIXEL:
        raise ValueError(
            f"rasterize_points_cuda: points_per_pixel={points_per_pixel} is outside"
            f" the kernel's 1..{MAX_POINTS_PER_PIXEL}"
        )
    return _RasterizePoints.apply(points, radius.detach(), valid, tuple(image_size), int(points_per_pixel))


rasterize_points_cuda.launches = 0


# --------------------------------------------------------------------------- #
# Pulsar: one binning, the select (#6) and the blend backward (#8)
# --------------------------------------------------------------------------- #


def bin_points_for_pulsar(
    points: torch.Tensor,  # (P, 3) NDC xy + view z
    radius: torch.Tensor,  # (P,)
    valid: torch.Tensor,  # (P,) bool
    image_size: Tuple[int, int],
):
    """One binning for pulsar's select and its blend backward (JAX
    `bin_points_for_pulsar`, rasterize_points_pallas.py:723).

    Returns (tile_points, tile_start, n_ty, n_tx, slot_rows, sphere_start):
    `bin_points`' exact CSR tile lists of one image, plus each sphere's rows
    into the per-slot gradient table, the counterpart of
    `_replica_grad_rows_from_sorted` (:815).  Slot q is the q-th
    (tile, sphere) pair of the tile-major lists; a stable sort of the pairs
    by sphere id gives `slot_rows`, and sphere p owns
    `slot_rows[sphere_start[p]:sphere_start[p + 1]]`, its slots in
    ascending tile order.  Exact: no capacity, nothing dropped."""
    tile_points, tile_start, n_ty, n_tx = bin_points(points[None], radius[None], valid[None], image_size)
    P = points.shape[0]
    slot_rows = torch.sort(tile_points, stable=True).indices.to(torch.int32)
    sphere_start = torch.zeros(P + 1, dtype=torch.int64, device=points.device)
    sphere_start[1:] = torch.cumsum(torch.bincount(tile_points, minlength=P), 0)
    return tile_points, tile_start, n_ty, n_tx, slot_rows, sphere_start.to(torch.int32)


def select_points_cuda(
    points: torch.Tensor,  # (P, 3) NDC xy + view z
    radius: torch.Tensor,  # (P,)
    valid: torch.Tensor,  # (P,) bool
    image_size: Tuple[int, int],
    points_per_pixel: int,
    bins=None,
) -> torch.Tensor:
    """(H, W, K) per-pixel ascending-z point ids, -1 where fewer cover.

    CUDA tensors launch the select-only points kernel (and count the launch
    in `select_points_cuda.launches`) over `bins`, `bin_points_for_pulsar`'s
    binning of the same points (made here when None); CPU tensors run the
    plain version, `rasterize_points_topk`.  Anything the kernel does not
    take raises.
    """
    if points.device.type == "cpu":
        return rasterize_points_topk(points, radius, valid, image_size, points_per_pixel)
    if points.device.type != "cuda":
        raise ValueError(f"select_points_cuda: unsupported device {points.device}")
    if points.dtype != torch.float32 or points.ndim != 2 or points.shape[1] != 3:
        raise TypeError("select_points_cuda: points must be a float32 (P, 3) tensor")
    P = points.shape[0]
    for name, t, dtype in (("radius", radius, torch.float32), ("valid", valid, torch.bool)):
        if t.shape != (P,) or t.dtype != dtype or t.device != points.device:
            raise ValueError(f"select_points_cuda: {name} must be a ({P},) {dtype} tensor on the points' device")
    if not (points.is_contiguous() and radius.is_contiguous()):
        raise ValueError("select_points_cuda: points and radius must be contiguous")
    if not 1 <= points_per_pixel <= MAX_POINTS_PER_PIXEL:
        raise ValueError(
            f"select_points_cuda: points_per_pixel={points_per_pixel} is outside the kernel's 1..{MAX_POINTS_PER_PIXEL}"
        )
    H, W = image_size
    K = int(points_per_pixel)
    if bins is None:
        bins = bin_points_for_pulsar(points, radius, valid, image_size)
    tile_points, tile_start, n_ty, n_tx = bins[:4]
    idx = torch.empty((H, W, K), dtype=torch.int32, device=points.device)
    if P == 0:
        return idx.fill_(-1)
    ys, xs = pixel_grid_ndc(H, W, points.device)
    lib = _library()
    with torch.cuda.device(points.device):
        err = lib.select_points(
            points.data_ptr(), radius.data_ptr(), tile_points.data_ptr(), tile_start.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), 1, P, H, W, n_ty, n_tx, K, idx.data_ptr(),
            torch.cuda.current_stream(points.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"select_points launch failed: CUDA error {err}")
    select_points_cuda.launches += 1
    return idx


select_points_cuda.launches = 0


def pulsar_depth_logit(cz, co, gamma: float, min_depth: float, max_depth: float):
    """(normalized depth before its clip, after it, the logit o zn / gamma)
    of pulsar's blend, in the one sequence of float operations that the
    forward, `pulsar_blend_grads_plain` and `csrc/pulsar_grad.cu` all
    follow: zn = 1 - (z - min_depth) * (1 / (max_depth - min_depth)) and
    logit = o * zn * (1 / gamma), each reciprocal rounded once to the
    data's dtype.  At gamma 1e-4 logits reach 1e4, where one ulp moves a
    weight by ~1e-3, and the gradient's weights must be the forward's."""
    zn_raw = 1.0 - (cz - min_depth) * (1.0 / (max_depth - min_depth))
    zn = zn_raw.clamp(0.0, 1.0)
    return zn_raw, zn, co * zn * (1.0 / gamma)


def pulsar_pixel_grid(H: int, W: int, dtype, device):
    """(H,) y and (W,) x NDC pixel centres of pulsar's blend: the float32
    centres in `dtype`, so that a float64 evaluation of the blend or its
    gradient is of the float32 one's function at the same points."""
    return tuple(t.to(dtype) for t in pixel_grid_ndc(H, W, device))


def pulsar_blend_grads_plain(
    table: torch.Tensor,  # (P, 5 + C): x, y, z, clipped r, o, col
    idx: torch.Tensor,  # (H, W, K) selected ids, -1 = miss
    ct_image: torch.Tensor,  # (H, W, C) image cotangent
    denom: torch.Tensor,  # (H, W)
    logit_max: torch.Tensor,  # (H, W)
    bg_col: torch.Tensor,  # (C,)
    image_size: Tuple[int, int],
    gamma: float,
    min_depth: float,
    max_depth: float,
    bg_norm_depth: float,
) -> torch.Tensor:
    """(P, 5 + C) gradient of pulsar's blend w.r.t. the sphere table, the
    plain version of `csrc/pulsar_grad.cu` (whose header writes out the
    formulas): each hit's contribution over the (H, W, K) hits, added into
    the table's rows with `index_add_`.  In the table's dtype.

    dL/dw_j = ct . (col_j - I) / denom takes col_j - I as
    (sum_k w_k (col_j - col_k) + w_bg (col_j - bg)) / denom over the
    pixel's hits, in the kernel's order: where one sphere makes the pixel,
    col_j - I computed from the image is the image's rounding, which
    1 / denom (small at a disc's rim) scales up; the pairwise form is
    exactly 0 there, as the exact gradient is."""
    H, W = image_size
    P, F = table.shape
    ids = idx.long()
    hit = ids >= 0
    g = table[ids.clamp(min=0)]  # (H, W, K, F)
    ys, xs = pulsar_pixel_grid(H, W, table.dtype, table.device)
    cx, cy, cz, cr, co = g.unbind(-1)[:5]
    cols = g[..., 5:]
    inv_denom = 1.0 / denom
    ctp = ct_image.to(table.dtype) * inv_denom[..., None]  # (H, W, C)
    inv_range, inv_gamma = 1.0 / (max_depth - min_depth), 1.0 / gamma
    zn_raw, zn, logit = pulsar_depth_logit(cz, co, gamma, min_depth, max_depth)
    e = torch.exp(logit - logit_max[..., None])
    dx = xs[None, :, None] - cx
    dy = ys[:, None, None] - cy
    d2 = dx * dx + dy * dy
    u = 1.0 - d2 / (cr * cr)
    clos = u.clamp(0.0, 1.0)
    w0 = clos * e
    w = torch.where(hit, co * clos * e, 0.0)  # the forward's weights
    w_bg = torch.exp(bg_norm_depth / gamma - logit_max)
    num = w_bg[..., None, None] * (cols - bg_col.to(table.dtype))  # (H, W, K, C): (col_j - I) denom
    for k in range(ids.shape[-1]):
        num = num + w[..., k, None, None] * (cols - cols[:, :, k, None, :])
    A = (ctp[:, :, None, :] * num).sum(-1) * inv_denom[..., None]
    gb = torch.where((u > 0.0) & (u < 1.0), A * e, 0.0)
    s = 2.0 * co / (cr * cr)
    S = A * w0
    grads = torch.cat([
        torch.stack([
            s * gb * dx,
            s * gb * dy,
            torch.where((zn_raw > 0.0) & (zn_raw < 1.0), -(co * co * inv_gamma) * inv_range * S, 0.0),
            s / cr * gb * d2,
            (1.0 + logit) * S,
        ], dim=-1),
        (co * w0)[..., None] * ctp[:, :, None, :],
    ], dim=-1)  # (H, W, K, F)
    out = torch.zeros((P, F), dtype=table.dtype, device=table.device)
    return out.index_add_(0, ids[hit], grads[hit])


def _pulsar_grad_library() -> ctypes.CDLL:
    lib = _build.load("pulsar_grad")
    if not lib.pulsar_grad.argtypes:
        rows, cols = ctypes.c_int(), ctypes.c_int()
        lib.pulsar_grad_tile(ctypes.byref(rows), ctypes.byref(cols))
        if (rows.value, cols.value) != TILE:
            raise RuntimeError(
                f"pulsar_grad.cu reduces {rows.value}x{cols.value} tiles but the binning makes {TILE[0]}x{TILE[1]} tiles"
            )
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pulsar_grad.argtypes = [p] * 12 + [i] * 8 + [f] * 4 + [p] * 4
        lib.pulsar_grad.restype = ctypes.c_int
    return lib


MAX_PULSAR_TRACK = 32  # largest K bucket pulsar_grad.cu is built for


def pulsar_blend_grads_cuda(
    table: torch.Tensor,  # (P, 5 + C)
    idx: torch.Tensor,  # (H, W, K) selected ids, -1 = miss
    ct_image: torch.Tensor,  # (H, W, C)
    denom: torch.Tensor,  # (H, W)
    logit_max: torch.Tensor,  # (H, W)
    bg_col: torch.Tensor,  # (C,)
    image_size: Tuple[int, int],
    gamma: float,
    min_depth: float,
    max_depth: float,
    bg_norm_depth: float,
    bins=None,
) -> torch.Tensor:
    """(P, 5 + C) gradient of pulsar's blend w.r.t. the sphere table.

    CUDA tensors launch `csrc/pulsar_grad.cu` (and count the launch in
    `pulsar_blend_grads_cuda.launches`) over `bins`, the
    `bin_points_for_pulsar` binning the ids were selected on; CPU tensors
    run `pulsar_blend_grads_plain`.  The kernel takes float32 contiguous
    tensors and int32 ids; anything else raises.  Deterministic: per-tile
    sums, then each sphere's slots in a fixed order.  A hit whose sphere is
    missing from its tile's list in `bins` (or an id >= P) makes that
    sphere's row (every row) NaN: the fault shows without a host sync.
    """
    if table.device.type == "cpu":
        return pulsar_blend_grads_plain(
            table, idx, ct_image, denom, logit_max, bg_col, image_size, gamma, min_depth, max_depth, bg_norm_depth
        )
    if table.device.type != "cuda":
        raise ValueError(f"pulsar_blend_grads_cuda: unsupported device {table.device}")
    if bins is None:
        raise ValueError("pulsar_blend_grads_cuda: CUDA tensors need the binning the ids were selected on")
    H, W = image_size
    if table.dtype != torch.float32 or table.ndim != 2 or table.shape[1] < 6:
        raise TypeError("pulsar_blend_grads_cuda: table must be a float32 (P, 5 + C) tensor")
    P, F = table.shape
    C = F - 5
    if idx.dtype != torch.int32 or idx.ndim != 3 or idx.shape[:2] != (H, W):
        raise TypeError(f"pulsar_blend_grads_cuda: idx must be an int32 ({H}, {W}, K) tensor")
    if not 1 <= idx.shape[2] <= MAX_PULSAR_TRACK:
        raise ValueError(f"pulsar_blend_grads_cuda: K={idx.shape[2]} is outside the kernel's 1..{MAX_PULSAR_TRACK}")
    for name, t, shape in (("ct_image", ct_image, (H, W, C)), ("denom", denom, (H, W)),
                           ("logit_max", logit_max, (H, W)), ("bg_col", bg_col, (C,))):
        if t.dtype != torch.float32 or t.shape != shape or t.device != table.device:
            raise TypeError(f"pulsar_blend_grads_cuda: {name} must be float32 {shape} on the table's device")
    tensors = (table, idx, ct_image, denom, logit_max, bg_col)
    if not all(t.is_contiguous() for t in tensors) or any(t.device != table.device for t in tensors):
        raise ValueError("pulsar_blend_grads_cuda: inputs must be contiguous and on one device")
    tile_points, tile_start, n_ty, n_tx, slot_rows, sphere_start = bins
    if sphere_start.numel() != P + 1:
        raise ValueError(f"pulsar_blend_grads_cuda: the binning is of {sphere_start.numel() - 1} points, not {P}")
    dtable = torch.empty((P, F), dtype=torch.float32, device=table.device)
    if P == 0:
        return dtable
    pairs = tile_points.numel()
    gslot = torch.empty((max(pairs, 1), F), dtype=torch.float32, device=table.device)
    flagged = torch.zeros((P + 1,), dtype=torch.int32, device=table.device)
    ys, xs = pulsar_pixel_grid(H, W, torch.float32, table.device)
    lib = _pulsar_grad_library()
    with torch.cuda.device(table.device):
        err = lib.pulsar_grad(
            table.data_ptr(), tile_points.data_ptr(), tile_start.data_ptr(), idx.data_ptr(),
            ct_image.data_ptr(), bg_col.data_ptr(), denom.data_ptr(), logit_max.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), slot_rows.data_ptr(), sphere_start.data_ptr(),
            P, C, H, W, n_ty, n_tx, idx.shape[2], pairs,
            1.0 / gamma, float(min_depth), 1.0 / (max_depth - min_depth), bg_norm_depth / gamma,
            gslot.data_ptr(), flagged.data_ptr(), dtable.data_ptr(),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pulsar_grad launch failed: CUDA error {err}")
    pulsar_blend_grads_cuda.launches += 1
    return dtable


pulsar_blend_grads_cuda.launches = 0
