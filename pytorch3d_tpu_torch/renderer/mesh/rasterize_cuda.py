"""The fine mesh-rasterizer kernels: binning, wrappers and plain versions
(port of pytorch3d_tpu/renderer/mesh/rasterize_pallas.py, fragments path).

`rasterize_fragments_cuda` replaces the TPU kernel `_fine_kernel` with
emit_fragments=True (rasterize_pallas.py:324, its pallas_call at :1235 in
`_rfp_fwd_impl` behind `rasterize_fragments_pallas` :1121).  On CUDA
tensors it bins the faces to 16x16 pixel tiles with plain torch (`bin_faces`)
and launches the hand-written kernel `csrc/rasterize_fine.cu` once for the
whole batch; that source's header says what bounds it on an H100 (the bytes
of the fragments it writes, the tests close behind), how the design meets
it and why its cull to each face's pixel box, which the kernel computes
for itself, is exact.  On CPU tensors it
runs `rasterize_fragments_plain`, the plain PyTorch version of the same
function, which the kernel is held against on the card.

Its backward, `rasterize_grad_cuda`, replaces the TPU kernel `_grad_kernel`
(rasterize_pallas.py:809, its pallas_call at :1092 in
`rasterize_grad_pallas`): on CUDA tensors it launches
`csrc/rasterize_grad.cu`, per-tile face sums over the forward's binning
and then a fixed-order sum per face (`face_pair_rows`), so two runs give
the same bits; on CPU tensors it runs `rasterize_grad_plain`.  On CPU the
forward is the plain version, which autograd differentiates directly.

Two more entry points share the binning.  `rasterize_topk_cuda` replaces
the ids-only `_fine_kernel` (emit_fragments=False, its pallas_call at :601
in `rasterize_topk_pallas` :549): the ids-only build of
`csrc/rasterize_fine.cu`, with `rasterize_topk` as its plain version.
`rasterize_hard_cuda` replaces `_hard_kernel` (:635, its pallas_call at
:770 in `rasterize_hard_pallas` :735), the K=1 z-min of
`MeshRasterizerOpenGL`: `csrc/rasterize_hard.cu`, which tests a face only
in the warps whose 4x8 pixel rectangle meets its pixel box (the same cull
as `csrc/rasterize_fine.cu`'s), with `rasterize_hard_plain` as its plain
version.
"""

from __future__ import annotations

import ctypes
import functools
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


def box_tiles(xmin, xmax, ymin, ymax, image_size: Tuple[int, int]):
    """((first tile row, tile rows), (first tile column, tile columns)) of
    NDC boxes: the tiles holding a pixel center inside each box."""
    H, W = image_size
    # Pixel c's center is x = -o + (r * (W - 1 - c) + o) / W (r the NDC span,
    # o = r / 2): x falls as c grows, so the largest x gives the first column.
    rx, ry = non_square_ndc_range(W, H), non_square_ndc_range(H, W)
    c_lo = W - 1 - ((xmax + rx / 2) * W - rx / 2) / rx
    c_hi = W - 1 - ((xmin + rx / 2) * W - rx / 2) / rx
    r_lo = H - 1 - ((ymax + ry / 2) * H - ry / 2) / ry
    r_hi = H - 1 - ((ymin + ry / 2) * H - ry / 2) / ry
    return _tile_range(r_lo, r_hi, H, TILE[0]), _tile_range(c_lo, c_hi, W, TILE[1])


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
    n_ty, n_tx = -(-H // TILE[0]), -(-W // TILE[1])
    device = ok.device
    (ty0, ny), (tx0, nx) = box_tiles(xmin, xmax, ymin, ymax, image_size)

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
    return bin_boxes(*face_boxes(face_verts, image_size, blur_radius), ok, image_size)


def box_grow(image_size: Tuple[int, int], blur_radius: float) -> float:
    """How far a face's bounding box is grown: sqrt(blur_radius) and half a
    pixel, so that no pixel center outside it can be covered, rounding
    included."""
    return (math.sqrt(blur_radius) if blur_radius > 0 else 0.0) + half_pixel(*image_size)


def face_boxes(face_verts: torch.Tensor, image_size: Tuple[int, int], blur_radius: float):
    """(xmin, xmax, ymin, ymax) of each face's NDC bounding box grown by
    `box_grow`."""
    grow = box_grow(image_size, blur_radius)
    xmin, xmax = torch.aminmax(face_verts[..., 0], dim=-1)  # (..., F)
    ymin, ymax = torch.aminmax(face_verts[..., 1], dim=-1)
    return xmin - grow, xmax + grow, ymin - grow, ymax + grow


@functools.lru_cache(maxsize=16)
def _pixel_grid(H: int, W: int, device: torch.device):
    """`pixel_grid_ndc(H, W, device)`, made once per image size: the
    kernels' calls are short, so the wrappers' host time counts."""
    return pixel_grid_ndc(H, W, device)


def face_pair_rows(tile_faces: torch.Tensor, tile_start: torch.Tensor, N: int, F: int):
    """The face-major CSR of a binning's (tile, face) pairs: (pair_rows,
    face_start).

    Pair q is the q-th entry of the tile-major lists (`tile_faces`, with
    `tile_start` over N images' tiles) and owns row q of the backward's
    per-pair table.  Face f of image n owns
    `pair_rows[face_start[n * F + f]:face_start[n * F + f + 1]]`, its pairs
    in ascending tile order (a stable sort of the pairs by face).  Built on
    the binning's device without a host sync."""
    device = tile_faces.device
    per_image = (tile_start.numel() - 1) // N
    dtype = torch.int32 if N * F < 2**31 - 1 else torch.int64
    key = tile_faces.to(dtype)
    if N > 1:
        # The image of pair q: the count of images 1..N-1 whose first pair
        # lies at or before q.
        firsts = tile_start[per_image:-1:per_image].contiguous()
        q = torch.arange(tile_faces.numel(), dtype=firsts.dtype, device=device)
        key = key + torch.searchsorted(firsts, q, right=True).to(dtype) * F
    key, pair_rows = torch.sort(key, stable=True)
    face_start = torch.searchsorted(key, torch.arange(N * F + 1, dtype=dtype, device=device), out_int32=True)
    return pair_rows.to(torch.int32), face_start


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
        lib.rasterize_fine.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, ctypes.c_float, i, i, i] + [p] * 5
        lib.rasterize_fine.restype = ctypes.c_int
        lib.rasterize_topk.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, ctypes.c_float, i, i, i] + [p] * 2
        lib.rasterize_topk.restype = ctypes.c_int
    return lib


def _run_kernel(face_verts, bins, image_size, blur_radius, K, perspective_correct,
                clip_barycentric_coords):
    """One launch of the fine kernel over binned faces; counts the launch."""
    tile_faces, tile_start, n_ty, n_tx = bins
    N, F = face_verts.shape[:2]
    H, W = image_size
    device = face_verts.device
    ys, xs = _pixel_grid(H, W, device)
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
            xs.data_ptr(), ys.data_ptr(), N, F, H, W, n_ty, n_tx, float(blur_radius),
            box_grow(image_size, blur_radius), K, int(perspective_correct), int(clip_barycentric_coords),
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
        rows, cols = ctypes.c_int(), ctypes.c_int()
        lib.rasterize_grad_tile(ctypes.byref(rows), ctypes.byref(cols))
        if (rows.value, cols.value) != TILE:
            raise RuntimeError(
                f"rasterize_grad.cu sums {rows.value}x{cols.value} tiles but"
                f" the binning makes {TILE[0]}x{TILE[1]} tiles"
            )
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_grad.argtypes = [p] * 11 + [i] * 9 + [p] * 4
        lib.rasterize_grad.restype = ctypes.c_int
    return lib


def _raise_on_missing(error: torch.Tensor) -> None:
    """Raise where pass 1 set its error flag: a filled slot whose face is
    missing from its tile's list.  Reading the flag is the backward's one
    host sync."""
    if int(error.item()):
        raise RuntimeError("rasterize_grad_cuda: a filled slot's face is missing from its tile's list in bins")


def rasterize_grad_cuda(
    face_verts: torch.Tensor,  # (N, F, 3, 3)
    pix_to_face: torch.Tensor,  # (N, H, W, K) int32 local ids, -1 = empty
    gz: Optional[torch.Tensor],  # (N, H, W, K) or None (= 0)
    gbary: Optional[torch.Tensor],  # (N, H, W, K, 3) or None
    gdists: Optional[torch.Tensor],  # (N, H, W, K) or None
    image_size: Tuple[int, int],
    bins,  # the forward's `bin_faces` (tile_faces, tile_start, n_ty, n_tx)
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
) -> torch.Tensor:
    """(N, F, 3, 3) gradient of (zbuf, bary, dists) w.r.t. `face_verts`.

    CUDA tensors launch the backward kernel (and count the launch in
    `rasterize_grad_cuda.launches`); CPU tensors run the plain version,
    which needs no binning.  The kernel takes float32 contiguous tensors
    and int32 ids; anything else raises.  It sums per (tile, face) pair of
    `bins`, the binning the forward rasterized `pix_to_face` with; a
    filled slot whose face is missing from its tile's list raises (the
    backward's one host sync reads that flag).  No atomics: two runs on
    the same inputs give the same bits.
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
    K = pix_to_face.shape[3]
    if N * F == 0 or pix_to_face.numel() == 0:
        return torch.zeros((N, F, 3, 3), dtype=torch.float32, device=face_verts.device)
    tile_faces, tile_start, n_ty, n_tx = bins
    if (n_ty, n_tx) != (-(-H // TILE[0]), -(-W // TILE[1])) or tile_start.numel() != N * n_ty * n_tx + 1:
        raise ValueError(f"rasterize_grad_cuda: bins of {n_ty}x{n_tx} tiles are not of {N} {H}x{W} images")
    if any(t.dtype != torch.int32 or t.device != face_verts.device or not t.is_contiguous()
           for t in (tile_faces, tile_start)):
        raise TypeError("rasterize_grad_cuda: bins must be contiguous int32 tensors on the faces' device")
    device = face_verts.device
    pair_rows, face_start = face_pair_rows(tile_faces, tile_start, N, F)
    gpair = torch.empty((max(tile_faces.numel(), 1), 9), dtype=torch.float32, device=device)
    error = torch.zeros((1,), dtype=torch.int32, device=device)
    grad = torch.empty((N, F, 3, 3), dtype=torch.float32, device=device)
    ys, xs = _pixel_grid(H, W, device)
    lib = _grad_library()
    with torch.cuda.device(device):
        err = lib.rasterize_grad(
            face_verts.data_ptr(), tile_faces.data_ptr(), tile_start.data_ptr(), pair_rows.data_ptr(),
            face_start.data_ptr(), pix_to_face.data_ptr(), _ptr(gz), _ptr(gbary), _ptr(gdists),
            xs.data_ptr(), ys.data_ptr(), N, F, H, W, K, n_ty, n_tx, int(perspective_correct),
            int(clip_barycentric_coords), gpair.data_ptr(), error.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_grad launch failed: CUDA error {err}")
    rasterize_grad_cuda.launches += 1
    _raise_on_missing(error)
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
        ctx.save_for_backward(fv, idx, bins[0], bins[1])  # the backward sums over the same tiles
        ctx.raster = (image_size, perspective_correct, clip_barycentric_coords, bins[2], bins[3])
        return idx, zbuf, bary, dists

    @staticmethod
    @once_differentiable
    def backward(ctx, _gidx, gz, gbary, gdists):
        fv, idx, tile_faces, tile_start = ctx.saved_tensors
        image_size, perspective_correct, clip_barycentric_coords, n_ty, n_tx = ctx.raster
        gz, gbary, gdists = (None if g is None else g.float().contiguous() for g in (gz, gbary, gdists))
        grad = rasterize_grad_cuda(
            fv, idx, gz, gbary, gdists, image_size, (tile_faces, tile_start, n_ty, n_tx),
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


def _check_faces(name: str, face_verts: torch.Tensor, valid: torch.Tensor, ndim: int) -> None:
    """Raise on what the kernels do not take: float32, contiguous
    (..., F, 3, 3) face verts with a matching bool mask."""
    if face_verts.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {face_verts.device}")
    if face_verts.dtype != torch.float32:
        raise TypeError(f"{name}: face_verts must be float32, got {face_verts.dtype}")
    if face_verts.ndim != ndim or face_verts.shape[-2:] != (3, 3):
        raise ValueError(f"{name}: face_verts must have {ndim} dims ending (3, 3), got {tuple(face_verts.shape)}")
    if not face_verts.is_contiguous():
        raise ValueError(f"{name}: face_verts must be contiguous")
    if valid.shape != face_verts.shape[:-2] or valid.dtype != torch.bool or valid.device != face_verts.device:
        raise ValueError(f"{name}: valid must be a bool {tuple(face_verts.shape[:-2])} tensor on the faces' device")


def rasterize_topk_cuda(
    face_verts: torch.Tensor,  # (F, 3, 3) one image's faces, NDC xy + view z
    valid: torch.Tensor,  # (F,) bool
    image_size: Tuple[int, int],
    blur_radius: float = 0.0,
    faces_per_pixel: int = 1,
    perspective_correct: bool = False,
    clip_barycentric_coords: bool = False,
    cull_backfaces: bool = False,
) -> torch.Tensor:
    """(H, W, K) per-pixel ascending-z face ids, -1 where fewer cover
    (JAX `rasterize_topk_pallas`).

    CUDA tensors launch the ids-only fine kernel (and count the launch in
    `rasterize_topk_cuda.launches`); its ids equal `rasterize_fragments_cuda`'s
    pix_to_face bit for bit.  CPU tensors run the plain version,
    `rasterize_topk`.  Anything the kernel does not take raises.
    """
    if face_verts.device.type == "cpu":
        return rasterize_topk(
            face_verts, valid, image_size, blur_radius, faces_per_pixel,
            perspective_correct, clip_barycentric_coords, cull_backfaces,
        )
    _check_faces("rasterize_topk_cuda", face_verts, valid, 3)
    if not 1 <= faces_per_pixel <= MAX_FACES_PER_PIXEL:
        raise ValueError(
            f"rasterize_topk_cuda: faces_per_pixel={faces_per_pixel} is outside the kernel's 1..{MAX_FACES_PER_PIXEL}"
        )
    H, W = image_size
    K = int(faces_per_pixel)
    fv = face_verts.detach()[None]
    tile_faces, tile_start, n_ty, n_tx = bin_faces(
        fv, _face_culls(fv, valid[None], cull_backfaces), (H, W), blur_radius
    )
    idx = torch.empty((H, W, K), dtype=torch.int32, device=fv.device)
    ys, xs = _pixel_grid(H, W, fv.device)
    lib = _library()
    with torch.cuda.device(fv.device):
        err = lib.rasterize_topk(
            fv.data_ptr(), tile_faces.data_ptr(), tile_start.data_ptr(), xs.data_ptr(), ys.data_ptr(),
            1, fv.shape[1], H, W, n_ty, n_tx, float(blur_radius), box_grow((H, W), blur_radius), K,
            int(perspective_correct),
            int(clip_barycentric_coords), idx.data_ptr(), torch.cuda.current_stream(fv.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_topk launch failed: CUDA error {err}")
    rasterize_topk_cuda.launches += 1
    return idx


rasterize_topk_cuda.launches = 0


def rasterize_hard_plain(
    face_verts: torch.Tensor,  # (N, F, 3, 3)
    valid: torch.Tensor,  # (N, F) bool
    image_size: Tuple[int, int],
):
    """The plain PyTorch version of the hard kernel, the JAX package's CPU
    route of `MeshRasterizerOpenGL` (mesh/rasterizer.py:196-203): per image
    `rasterize_topk(fv, valid, size, 0.0, 1)`, then
    `interpolate_fragments(..., perspective_correct=True)`.

    Returns (pix_to_face (N, H, W, 1) local ids, zbuf (N, H, W, 1), bary
    (N, H, W, 1, 3)); empty pixels hold -1."""
    pix, zbuf, bary = [], [], []
    for fv, m in zip(face_verts.detach(), valid):
        idx = rasterize_topk(fv, m, image_size, 0.0, 1)
        z, b, _ = interpolate_fragments(fv, idx, image_size, perspective_correct=True)
        pix.append(idx)
        zbuf.append(z)
        bary.append(b)
    return torch.stack(pix), torch.stack(zbuf), torch.stack(bary)


def _hard_library() -> ctypes.CDLL:
    lib = _build.load("rasterize_hard")
    if not lib.rasterize_hard.argtypes:
        rows, cols = ctypes.c_int(), ctypes.c_int()
        lib.rasterize_hard_tile(ctypes.byref(rows), ctypes.byref(cols))
        if (rows.value, cols.value) != TILE:
            raise RuntimeError(
                f"rasterize_hard.cu rasterizes {rows.value}x{cols.value} tiles but"
                f" the binning makes {TILE[0]}x{TILE[1]} tiles"
            )
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_hard.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float] + [p] * 4
        lib.rasterize_hard.restype = ctypes.c_int
    return lib


def rasterize_hard_cuda(
    face_verts: torch.Tensor,  # (N, F, 3, 3) NDC xy + view z
    valid: torch.Tensor,  # (N, F) bool
    image_size: Tuple[int, int],
):
    """(pix_to_face, zbuf, bary) of a batch at K=1 with no blur: the nearest
    covering face per pixel and its perspective-correct z and barycentrics
    (JAX `rasterize_hard_pallas`, one launch for the batch where JAX loops
    over meshes).  Local face ids; not differentiable.

    CUDA tensors launch the hard kernel (and count the launch in
    `rasterize_hard_cuda.launches`); CPU tensors run `rasterize_hard_plain`.
    Anything the kernel does not take raises.
    """
    if face_verts.device.type == "cpu":
        return rasterize_hard_plain(face_verts, valid, image_size)
    _check_faces("rasterize_hard_cuda", face_verts, valid, 4)
    H, W = image_size
    N, F = face_verts.shape[:2]
    fv = face_verts.detach()
    device = fv.device
    idx = torch.empty((N, H, W, 1), dtype=torch.int32, device=device)
    zbuf = torch.empty((N, H, W, 1), dtype=torch.float32, device=device)
    bary = torch.empty((N, H, W, 1, 3), dtype=torch.float32, device=device)
    if N == 0:
        return idx, zbuf, bary
    tile_faces, tile_start, n_ty, n_tx = bin_faces(fv, _face_culls(fv, valid, False), (H, W), 0.0)
    ys, xs = _pixel_grid(H, W, device)
    lib = _hard_library()
    with torch.cuda.device(device):
        err = lib.rasterize_hard(
            fv.data_ptr(), tile_faces.data_ptr(), tile_start.data_ptr(), xs.data_ptr(), ys.data_ptr(),
            N, F, H, W, n_ty, n_tx, box_grow((H, W), 0.0), idx.data_ptr(), zbuf.data_ptr(), bary.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_hard launch failed: CUDA error {err}")
    rasterize_hard_cuda.launches += 1
    return idx, zbuf, bary


rasterize_hard_cuda.launches = 0
