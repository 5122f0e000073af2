"""The points-rasterizer kernels: binning, wrappers and the autograd op
(port of pytorch3d_tpu/renderer/points/rasterize_points_pallas.py).

`rasterize_points_cuda` replaces the TPU kernel `_fine_kernel`
(rasterize_points_pallas.py:285, its pallas_call at :497 in `_rpf_fwd`
behind `rasterize_points_fragments_pallas` :428).  On CUDA tensors it bins
the points to 16x16 pixel tiles with plain torch (`bin_points`) and
launches the hand-written kernel `csrc/rasterize_points.cu` once for the
whole batch; on CPU tensors it runs `rasterize_points_plain`, the plain
PyTorch version the kernel is held against on the card.

Its backward, `rasterize_points_grad_cuda`, replaces the TPU kernel
`_grad_kernel` (rasterize_points_pallas.py:365, its pallas_call at :562 in
`_rpf_bwd`): on CUDA tensors it launches `csrc/rasterize_points_grad.cu`,
one thread per (pixel, slot) with atomic adds per point; on CPU tensors it
runs `rasterize_points_grad_plain`.  Each source's header says what bounds
it on an H100 and how its design meets that.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ... import _build
from ..mesh.rasterize_cuda import TILE, _ptr, bin_boxes, half_pixel
from ..mesh.rasterize_meshes import pixel_grid_ndc
from .rasterize_points import rasterize_points_grad_plain, rasterize_points_plain

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
    H, W = image_size
    grow = radius.abs() + half_pixel(H, W)
    x, y = points[..., 0], points[..., 1]
    ok = valid & (points[..., 2] >= 0)
    return bin_boxes(x - grow, x + grow, y - grow, y + grow, ok, image_size)


def _library() -> ctypes.CDLL:
    lib = _build.load("rasterize_points")
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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_points_grad.argtypes = [p] * 6 + [i] * 5 + [p] * 2
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
) -> torch.Tensor:
    """(N, P, 3) gradient of (zbuf, dists) w.r.t. `points`.

    CUDA tensors launch the backward kernel (and count the launch in
    `rasterize_points_grad_cuda.launches`); CPU tensors run the plain
    version.  The kernel takes float32 contiguous tensors and int32 ids;
    anything else raises.  Its fp32 atomics add in an order that changes
    from run to run, so two runs agree to rounding, not bit for bit.
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
    grad = torch.zeros((N, P, 3), dtype=torch.float32, device=points.device)
    if grad.numel() == 0 or idx.numel() == 0 or (gz is None and gdists is None):
        return grad
    ys, xs = pixel_grid_ndc(H, W, points.device)
    lib = _grad_library()
    with torch.cuda.device(points.device):
        err = lib.rasterize_points_grad(
            points.data_ptr(), idx.data_ptr(), _ptr(gz), _ptr(gdists), xs.data_ptr(), ys.data_ptr(),
            N, P, H, W, idx.shape[3], grad.data_ptr(),
            torch.cuda.current_stream(points.device).cuda_stream,
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
        ctx.save_for_backward(pts, idx)
        ctx.image_size = image_size
        return idx, zbuf, dists

    @staticmethod
    @once_differentiable
    def backward(ctx, _gidx, gz, gdists):
        pts, idx = ctx.saved_tensors
        gz, gdists = (None if g is None else g.float().contiguous() for g in (gz, gdists))
        grad = rasterize_points_grad_cuda(pts, idx, gz, gdists, ctx.image_size)
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
