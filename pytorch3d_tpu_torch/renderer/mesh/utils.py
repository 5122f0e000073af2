"""Mesh-renderer utilities: barycentric fixes and rectangle packing
(port of pytorch3d_tpu/renderer/mesh/utils.py).

The packing is host-side Python, kept here as the JAX package has it (it
lays out UV maps); the two barycentric helpers are torch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ...ops.interp_face_attrs import interpolate_face_attributes


def _clip_barycentric_coordinates(bary: torch.Tensor) -> torch.Tensor:
    """Clamp negatives to 0 and renormalize, (..., 3)."""
    clipped = torch.clamp(bary, min=0.0)
    return clipped / torch.clamp(clipped.sum(dim=-1, keepdim=True), min=1e-5)


def _interpolate_zbuf(pix_to_face, barycentric_coords, meshes) -> torch.Tensor:
    """Re-interpolate the z buffer with (possibly clipped) barycentrics;
    -1 where no face covers."""
    verts = meshes.verts_packed()
    faces = meshes.faces_packed()
    faces_verts_z = verts[faces.clamp(min=0)][..., 2][..., None]
    zbuf = interpolate_face_attributes(pix_to_face, barycentric_coords, faces_verts_z)[..., 0]
    return torch.where(pix_to_face >= 0, zbuf, -1.0)


class Rectangle(NamedTuple):
    xsize: int
    ysize: int
    identifier: int


class PackedRectangle(NamedTuple):
    x: int
    y: int
    flipped: bool
    is_first: bool


class PackedRectangles(NamedTuple):
    total_size: Tuple[int, int]
    locations: List[PackedRectangle]


class _Shelf:
    """One horizontal band of the packing: rectangles are appended left to
    right; the band's height is fixed by its first (tallest) occupant."""

    __slots__ = ("y", "height", "cursor")

    def __init__(self, y: int, height: int) -> None:
        self.y = y
        self.height = height
        self.cursor = 0


def pack_rectangles(sizes: List[Tuple[int, int]]) -> PackedRectangles:
    """Pack axis-aligned rectangles (90-degree flips allowed) into one
    enclosing rectangle; used to lay out UV maps for TexturesUV.join_scene.

    Original shelf-first-fit design (NOT the reference's interval-scan
    packer; only the API matches reference renderer/mesh/utils.py:210):
    every rectangle is normalized landscape (w >= h, recording a flip),
    the bin width is the widest normalized rectangle, and rectangles are
    placed tallest-first onto horizontal shelves. Each rectangle goes to
    the first shelf with room (trying both orientations), else opens a
    new shelf. Placements differ from the reference packer; callers only
    rely on in-bounds, non-overlapping locations.
    """
    if len(sizes) < 2:
        raise ValueError("Cannot pack less than two boxes")

    # Normalize to landscape; flipped=True means the stored (w, h) is the
    # caller's (ysize, xsize).
    norm = []
    for i, (x, y) in enumerate(sizes):
        if x < y:
            norm.append((y, x, i, True))
        else:
            norm.append((x, y, i, False))

    bin_width = max(w for w, _, _, _ in norm)
    # Tallest first so each shelf's height is set by its first occupant;
    # ties broken widest-first to keep shelves dense.
    order = sorted(norm, key=lambda r: (r[1], r[0]), reverse=True)

    placed = [PackedRectangle(-1, -1, False, False)] * len(sizes)
    shelves: List[_Shelf] = []
    total_height = 0

    for w, h, ind, flipped in order:
        spot = None  # (shelf, w, h, flipped) chosen for this rectangle
        for shelf in shelves:
            if h <= shelf.height and shelf.cursor + w <= bin_width:
                spot = (shelf, w, h, flipped)
                break
            # Portrait orientation can slot into a tall shelf whose
            # remaining width is too narrow for landscape.
            if w <= shelf.height and shelf.cursor + h <= bin_width:
                spot = (shelf, h, w, not flipped)
                break
        if spot is None:
            shelf = _Shelf(total_height, h)
            total_height += h
            shelves.append(shelf)
            spot = (shelf, w, h, flipped)
        shelf, pw, _, pflip = spot
        placed[ind] = PackedRectangle(shelf.cursor, shelf.y, pflip, True)
        shelf.cursor += pw

    return PackedRectangles((bin_width, total_height), placed)


def pack_unique_rectangles(rectangles: List[Rectangle]) -> PackedRectangles:
    """pack_rectangles over identifier-deduplicated inputs; duplicates
    share a location, only the first has is_first=True (reference :268)."""
    input_map = {}
    input_indices = []
    unique_sizes = []
    for rect in rectangles:
        if rect.identifier not in input_map:
            input_map[rect.identifier] = len(unique_sizes)
            input_indices.append((len(unique_sizes), True))
            unique_sizes.append((rect.xsize, rect.ysize))
        else:
            input_indices.append((input_map[rect.identifier], False))
    if len(unique_sizes) == 1:
        w, h = unique_sizes[0]
        locs = [
            PackedRectangle(0, 0, False, is_first)
            for _, is_first in input_indices
        ]
        return PackedRectangles((w, h), locs)
    packed = pack_rectangles(unique_sizes)
    locs = [
        PackedRectangle(
            packed.locations[ui].x,
            packed.locations[ui].y,
            packed.locations[ui].flipped,
            is_first,
        )
        for ui, is_first in input_indices
    ]
    return PackedRectangles(packed.total_size, locs)
