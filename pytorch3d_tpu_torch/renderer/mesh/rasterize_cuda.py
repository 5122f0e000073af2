"""The fine mesh-rasterizer kernels: binning, wrappers and plain versions
(port of pytorch3d_tpu/renderer/mesh/rasterize_pallas.py, fragments path).

`rasterize_fragments_cuda` replaces the TPU kernel `_fine_kernel` with
emit_fragments=True (rasterize_pallas.py:324, its pallas_call at :1235 in
`_rfp_fwd_impl` behind `rasterize_fragments_pallas` :1121).  On CUDA
tensors it bins the faces to 16x16 pixel tiles with plain torch (`bin_faces`)
and launches the hand-written kernel `csrc/rasterize_fine.cu` once for the
whole batch; that source's header says what bounds it on an H100 (the
per-pixel arithmetic, with the bytes of the fragments it writes close
behind) and how the design meets it.  On CPU tensors it
runs `rasterize_fragments_plain`, the plain PyTorch version of the same
function, which the kernel is held against on the card.

Its backward, `rasterize_grad_cuda`, replaces the TPU kernel `_grad_kernel`
(rasterize_pallas.py:809, its pallas_call at :1092 in
`rasterize_grad_pallas`): on CUDA tensors it launches
`csrc/rasterize_grad.cu`, one thread per (pixel, slot) with atomic adds
per face; on CPU tensors it runs `rasterize_grad_plain`.  On CPU the
forward is the plain version, which autograd differentiates directly.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ... import _build
from .rasterize_meshes import (
    _face_culls,
    interpolate_fragments,
    non_square_ndc_range,
    pixel_grid_ndc,
    rasterize_grad_plain,
    rasterize_topk,
)

TILE = (16, 16)  # pixel tile (rows, cols) of one thread block; checked against the .cu at load
MAX_FACES_PER_PIXEL = 64  # largest K bucket the kernel is built for


def _tile_range(lo: torch.Tensor, hi: torch.Tensor, n_pix: int, t: int):
    """First tile and tile count along one axis for float pixel ranges
    [lo, hi]; NaN bounds widen to the whole axis, ranges off the image give
    count 0."""
    lo = torch.nan_to_num(lo, nan=-1.0).clamp(-1.0, float(n_pix)).floor().long()
    hi = torch.nan_to_num(hi, nan=float(n_pix)).clamp(-1.0, float(n_pix)).ceil().long()
    hit = (hi >= 0) & (lo <= n_pix - 1)
    first = lo.clamp(min=0) // t
    last = hi.clamp(max=n_pix - 1) // t
    return first, torch.where(hit, last - first + 1, 0)


def half_pixel(H: int, W: int) -> float:
    """Half the larger NDC pixel side: how far a bounding box is grown so
    that float rounding at its edge cannot drop a pixel center."""
    return max(non_square_ndc_range(H, W) / H, non_square_ndc_range(W, H) / W) / 2.0


def bin_boxes(xmin, xmax, ymin, ymax, ok, image_size: Tuple[int, int]):
    """Per-tile lists of NDC boxes as CSR: (tile_items, tile_start, n_ty, n_tx).

    The boxes are (N, M) tensors of bounds, one batch item of M boxes per
    image.  Tile `(n * n_ty + ty) * n_tx + tx` of image n owns
    `tile_items[tile_start[i]:tile_start[i + 1]]`, the local ids of the ok
    boxes that reach a pixel center of the tile, in ascending id.  The
    lists are exact: no capacity, nothing dropped.  The face and the point
    binnings share it.
    """
    N, M = ok.shape
    H, W = image_size
    TH, TW = TILE
    n_ty, n_tx = -(-H // TH), -(-W // TW)
    device = ok.device
    # Pixel c's center is x = -o + (r * (W - 1 - c) + o) / W (r the NDC span,
    # o = r / 2): x falls as c grows, so the largest x gives the first column.
    rx, ry = non_square_ndc_range(W, H), non_square_ndc_range(H, W)
    c_lo = W - 1 - ((xmax + rx / 2) * W - rx / 2) / rx
    c_hi = W - 1 - ((xmin + rx / 2) * W - rx / 2) / rx
    r_lo = H - 1 - ((ymax + ry / 2) * H - ry / 2) / ry
    r_hi = H - 1 - ((ymin + ry / 2) * H - ry / 2) / ry
    tx0, nx = _tile_range(c_lo, c_hi, W, TW)
    ty0, ny = _tile_range(r_lo, r_hi, H, TH)

    counts = torch.where(ok, nx * ny, 0).reshape(-1)  # (N*M,)
    P = int(counts.sum())
    item = torch.repeat_interleave(torch.arange(N * M, device=device), counts, output_size=P)
    j = torch.arange(P, device=device) - (torch.cumsum(counts, 0) - counts)[item]
    nx_f = nx.reshape(-1)[item]
    ty = ty0.reshape(-1)[item] + j // nx_f
    tx = tx0.reshape(-1)[item] + j % nx_f
    n = item // M
    key = ((n * n_ty + ty) * n_tx + tx) * M + item % M
    key = torch.sort(key).values  # by tile, then ascending id
    n_tiles = N * n_ty * n_tx
    tile_start = torch.zeros(n_tiles + 1, dtype=torch.int64, device=device)
    tile_start[1:] = torch.cumsum(torch.bincount(key // M, minlength=n_tiles), 0)
    return (key % M).to(torch.int32), tile_start.to(torch.int32), n_ty, n_tx


def bin_faces(
    face_verts: torch.Tensor,  # (N, F, 3, 3)
    ok: torch.Tensor,  # (N, F) bool: faces that may cover any pixel
    image_size: Tuple[int, int],
    blur_radius: float,
):
    """Per-tile face lists as CSR: (tile_faces, tile_start, n_ty, n_tx), from
    `bin_boxes` on each face's bounding box grown by sqrt(blur_radius) and
    half a pixel (as `_tile_overlap` at rasterize_pallas.py:148-173)."""
    H, W = image_size
    grow = (math.sqrt(blur_radius) if blur_radius > 0 else 0.0) + half_pixel(H, W)
    x, y = face_verts[..., 0], face_verts[..., 1]  # (N, F, 3)
    return bin_boxes(
        x.amin(-1) - grow, x.amax(-1) + grow, y.amin(-1) - grow, y.amax(-1) + grow, ok, image_size
    )


def rasterize_fragments_plain(
    face_verts: torch.Tensor,  # (N, F, 3, 3)
    valid: torch.Tensor,  # (N, F) bool
    image_size: Tuple[int, int],
    blur_radius: float = 0.0,
    faces_per_pixel: int = 1,
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    cull_backfaces: bool = False,
):
    """The plain PyTorch version of the kernel: `rasterize_topk` then
    `interpolate_fragments`, image by image.

    Returns (pix_to_face, zbuf, bary, dists) with per-image local face ids.
    zbuf/bary/dists are differentiable with respect to `face_verts`.
    """
    pix, zbuf, bary, dists = [], [], [], []
    for fv, m in zip(face_verts, valid):
        idx = rasterize_topk(
            fv.detach(), m, image_size, blur_radius, faces_per_pixel,
            perspective_correct, clip_barycentric_coords, cull_backfaces,
        )
        z, b, d = interpolate_fragments(
            fv, idx, image_size, perspective_correct, clip_barycentric_coords
        )
        pix.append(idx)
        zbuf.append(z)
        bary.append(b)
        dists.append(d)
    return torch.stack(pix), torch.stack(zbuf), torch.stack(bary), torch.stack(dists)


def _library() -> ctypes.CDLL:
    lib = _build.load("rasterize_fine")
    if not lib.rasterize_fine.argtypes:
        rows, cols = ctypes.c_int(), ctypes.c_int()
        lib.rasterize_fine_tile(ctypes.byref(rows), ctypes.byref(cols))
        if (rows.value, cols.value) != TILE:
            raise RuntimeError(
                f"rasterize_fine.cu rasterizes {rows.value}x{cols.value} tiles but"
                f" the binning makes {TILE[0]}x{TILE[1]} tiles"
            )
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_fine.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, i, i, i] + [p] * 5
        lib.rasterize_fine.restype = ctypes.c_int
    return lib


def _run_kernel(face_verts, bins, image_size, blur_radius, K, perspective_correct,
                clip_barycentric_coords):
    """One launch of the fine kernel over binned faces; counts the launch."""
    tile_faces, tile_start, n_ty, n_tx = bins
    N, F = face_verts.shape[:2]
    H, W = image_size
    device = face_verts.device
    ys, xs = pixel_grid_ndc(H, W, device)
    idx = torch.empty((N, H, W, K), dtype=torch.int32, device=device)
    zbuf = torch.empty((N, H, W, K), dtype=torch.float32, device=device)
    bary = torch.empty((N, H, W, K, 3), dtype=torch.float32, device=device)
    dists = torch.empty((N, H, W, K), dtype=torch.float32, device=device)
    if N == 0:
        return idx, zbuf, bary, dists
    lib = _library()
    with torch.cuda.device(device):  # launch in the tensors' context
        err = lib.rasterize_fine(
            face_verts.data_ptr(), tile_faces.data_ptr(), tile_start.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), N, F, H, W, n_ty, n_tx,
            float(blur_radius), K, int(perspective_correct), int(clip_barycentric_coords),
            idx.data_ptr(), zbuf.data_ptr(), bary.data_ptr(), dists.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_fine launch failed: CUDA error {err}")
    rasterize_fragments_cuda.launches += 1
    return idx, zbuf, bary, dists


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's device pointer; None (a null pointer) for a zero cotangent."""
    return None if t is None else t.data_ptr()


def _grad_library() -> ctypes.CDLL:
    lib = _build.load("rasterize_grad")
    if not lib.rasterize_grad.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_grad.argtypes = [p] * 7 + [i] * 7 + [p, p]
        lib.rasterize_grad.restype = ctypes.c_int
    return lib


def rasterize_grad_cuda(
    face_verts: torch.Tensor,  # (N, F, 3, 3)
    pix_to_face: torch.Tensor,  # (N, H, W, K) int32 local ids, -1 = empty
    gz: Optional[torch.Tensor],  # (N, H, W, K) or None (= 0)
    gbary: Optional[torch.Tensor],  # (N, H, W, K, 3) or None
    gdists: Optional[torch.Tensor],  # (N, H, W, K) or None
    image_size: Tuple[int, int],
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
) -> torch.Tensor:
    """(N, F, 3, 3) gradient of (zbuf, bary, dists) w.r.t. `face_verts`.

    CUDA tensors launch the backward kernel (and count the launch in
    `rasterize_grad_cuda.launches`); CPU tensors run the plain version.
    The kernel takes float32 contiguous tensors and int32 ids; anything
    else raises.  Its fp32 atomics add in an order that changes from run
    to run, so two runs agree to rounding, not bit for bit.
    """
    if face_verts.device.type == "cpu":
        return rasterize_grad_plain(
            face_verts, pix_to_face, gz, gbary, gdists, image_size,
            perspective_correct, clip_barycentric_coords,
        )
    if face_verts.device.type != "cuda":
        raise ValueError(f"rasterize_grad_cuda: unsupported device {face_verts.device}")
    if face_verts.dtype != torch.float32 or face_verts.ndim != 4 or face_verts.shape[2:] != (3, 3):
        raise TypeError("rasterize_grad_cuda: face_verts must be a float32 (N, F, 3, 3) tensor")
    N, F = face_verts.shape[:2]
    if pix_to_face.dtype != torch.int32 or pix_to_face.ndim != 4 or pix_to_face.shape[0] != N:
        raise TypeError("rasterize_grad_cuda: pix_to_face must be an int32 (N, H, W, K) tensor")
    H, W = image_size
    if pix_to_face.shape[1:3] != (H, W):
        raise ValueError(f"rasterize_grad_cuda: pix_to_face {tuple(pix_to_face.shape)} is not {H}x{W}")
    shapes = (pix_to_face.shape, (*pix_to_face.shape, 3), pix_to_face.shape)
    for name, g, shape in zip(("gz", "gbary", "gdists"), (gz, gbary, gdists), shapes):
        if g is None:
            continue
        if g.dtype != torch.float32 or g.shape != shape or g.device != face_verts.device:
            raise TypeError(f"rasterize_grad_cuda: {name} must be float32 {tuple(shape)} on the faces' device")
        if not g.is_contiguous():
            raise ValueError(f"rasterize_grad_cuda: {name} must be contiguous")
    if not (face_verts.is_contiguous() and pix_to_face.is_contiguous()):
        raise ValueError("rasterize_grad_cuda: face_verts and pix_to_face must be contiguous")
    grad = torch.zeros((N, F, 3, 3), dtype=torch.float32, device=face_verts.device)
    K = pix_to_face.shape[3]
    if grad.numel() == 0 or pix_to_face.numel() == 0:
        return grad
    ys, xs = pixel_grid_ndc(H, W, face_verts.device)
    lib = _grad_library()
    with torch.cuda.device(face_verts.device):
        err = lib.rasterize_grad(
            face_verts.data_ptr(), pix_to_face.data_ptr(), _ptr(gz), _ptr(gbary), _ptr(gdists),
            xs.data_ptr(), ys.data_ptr(), N, F, H, W, K, int(perspective_correct),
            int(clip_barycentric_coords), grad.data_ptr(),
            torch.cuda.current_stream(face_verts.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_grad launch failed: CUDA error {err}")
    rasterize_grad_cuda.launches += 1
    return grad


rasterize_grad_cuda.launches = 0


class _RasterizeFine(torch.autograd.Function):
    """The CUDA fine rasterizer as an autograd op: forward and backward are
    the two kernels."""

    @staticmethod
    def forward(ctx, face_verts, valid, image_size, blur_radius, K,
                perspective_correct, clip_barycentric_coords, cull_backfaces):
        fv = face_verts.detach()
        bins = bin_faces(fv, _face_culls(fv, valid, cull_backfaces), image_size, blur_radius)
        idx, zbuf, bary, dists = _run_kernel(
            fv, bins, image_size, blur_radius, K, perspective_correct,
            clip_barycentric_coords,
        )
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        ctx.save_for_backward(fv, idx)
        ctx.raster = (image_size, perspective_correct, clip_barycentric_coords)
        return idx, zbuf, bary, dists

    @staticmethod
    @once_differentiable
    def backward(ctx, _gidx, gz, gbary, gdists):
        fv, idx = ctx.saved_tensors
        image_size, perspective_correct, clip_barycentric_coords = ctx.raster
        gz, gbary, gdists = (None if g is None else g.float().contiguous() for g in (gz, gbary, gdists))
        grad = rasterize_grad_cuda(
            fv, idx, gz, gbary, gdists, image_size,
            perspective_correct, clip_barycentric_coords,
        )
        return grad, None, None, None, None, None, None, None


def rasterize_fragments_cuda(
    face_verts: torch.Tensor,  # (N, F, 3, 3) NDC xy + view z
    valid: torch.Tensor,  # (N, F) bool
    image_size: Tuple[int, int],
    blur_radius: float = 0.0,
    faces_per_pixel: int = 1,
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    cull_backfaces: bool = False,
):
    """(pix_to_face, zbuf, bary, dists) of a batch, per-image local face ids.

    CUDA tensors launch the fine kernel (and count the launch in
    `rasterize_fragments_cuda.launches`); CPU tensors run the plain version.
    Anything the kernel does not take raises.
    """
    if face_verts.device.type == "cpu":
        return rasterize_fragments_plain(
            face_verts, valid, image_size, blur_radius, faces_per_pixel,
            perspective_correct, clip_barycentric_coords, cull_backfaces,
        )
    if face_verts.device.type != "cuda":
        raise ValueError(f"rasterize_fragments_cuda: unsupported device {face_verts.device}")
    if face_verts.dtype != torch.float32:
        raise TypeError(f"rasterize_fragments_cuda: face_verts must be float32, got {face_verts.dtype}")
    if face_verts.ndim != 4 or face_verts.shape[2:] != (3, 3):
        raise ValueError(f"rasterize_fragments_cuda: face_verts must be (N, F, 3, 3), got {tuple(face_verts.shape)}")
    if not face_verts.is_contiguous():
        raise ValueError("rasterize_fragments_cuda: face_verts must be contiguous")
    if valid.shape != face_verts.shape[:2] or valid.dtype != torch.bool or valid.device != face_verts.device:
        raise ValueError("rasterize_fragments_cuda: valid must be an (N, F) bool tensor on the faces' device")
    if not 1 <= faces_per_pixel <= MAX_FACES_PER_PIXEL:
        raise ValueError(
            f"rasterize_fragments_cuda: faces_per_pixel={faces_per_pixel} is outside"
            f" the kernel's 1..{MAX_FACES_PER_PIXEL}"
        )
    return _RasterizeFine.apply(
        face_verts, valid, tuple(image_size), float(blur_radius), int(faces_per_pixel),
        bool(perspective_correct), bool(clip_barycentric_coords), bool(cull_backfaces),
    )


rasterize_fragments_cuda.launches = 0
