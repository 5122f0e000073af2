"""Marching cubes isosurface extraction (port of pytorch3d_tpu/ops/marching_cubes.py).

The same vectorised pipeline as the JAX package: per-cell cube indices from
the tables, per-edge vertex interpolation with the endpoint snap, vertex
dedup by a canonical global edge key (axis * NV + lower endpoint, or the
endpoint itself where the interpolation snapped to it) through a stable
sort and cumsum ranks, and prefix compaction of the triangles.  So the
vertex and face order equal JAX's.  Not differentiable.

Conventions (PyTorch3D's Cube class): local vertex v has offsets
(dx, dy, dz) = (v & 1, v >> 1 & 1, v >> 2 & 1); bit i of the cube index is
set when vol[corner INDEX[i]] < isolevel; vertices come out as (x, y, z).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .marching_cubes_data import EDGE_TO_VERTICES, INDEX, TRI_TABLE

_EPS = 1e-5
_SENTINEL = torch.iinfo(torch.int32).max
# Local vertex offsets (dx, dy, dz) for v in 0..7 (bit coding).
_OFFSETS = [[v & 1, (v >> 1) & 1, (v >> 2) & 1] for v in range(8)]


def _mc_one(vol: torch.Tensor, isolevel: float, eps: float = _EPS):
    """vol (D, H, W) -> (verts (n_verts, 3) grid coords, faces (n_faces, 3))."""
    D, H, W = vol.shape
    device = vol.device
    NV = D * H * W
    off = torch.tensor(_OFFSETS, dtype=torch.int64, device=device)
    tri_table = torch.as_tensor(TRI_TABLE, device=device).long()
    e2v = torch.as_tensor(EDGE_TO_VERTICES, device=device).long()
    index = torch.as_tensor(INDEX, device=device).long()

    zz, yy, xx = torch.meshgrid(
        torch.arange(D - 1, device=device), torch.arange(H - 1, device=device), torch.arange(W - 1, device=device),
        indexing="ij",
    )
    cx, cy, cz = xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)
    NCELL = cx.shape[0]

    # Corner values for bit-coded vertex v: vol[z + dz, y + dy, x + dx].
    corner_vals = torch.stack([vol[cz + o[2], cy + o[1], cx + o[0]] for o in _OFFSETS], dim=-1)  # (NCELL, 8)
    bits = (corner_vals[:, index] < isolevel).long()
    cube_index = (bits * (2 ** torch.arange(8, device=device))).sum(dim=-1)

    tris = tri_table[cube_index]  # (NCELL, 5, 3) edge ids, -1 padded
    tri_ok = tris[..., 0] >= 0
    edges = tris.clamp(min=0)
    v1, v2 = e2v[edges][..., 0], e2v[edges][..., 1]  # (NCELL, 5, 3) local vertex ids

    def vert_pos_val(vloc):
        o = off[vloc]
        px = cx[:, None, None] + o[..., 0]
        py = cy[:, None, None] + o[..., 1]
        pz = cz[:, None, None] + o[..., 2]
        return torch.stack([px, py, pz], dim=-1).to(vol.dtype), vol[pz, py, px], px + py * W + pz * W * H

    p1, val1, gid1 = vert_pos_val(v1)
    p2, val2, gid2 = vert_pos_val(v2)

    # Linear interpolation with the endpoint snap (PyTorch3D's vert_interp).
    denom = val2 - val1
    degen = denom.abs() < eps
    mu = (isolevel - val1) / torch.where(degen, torch.ones_like(denom), denom)
    point = p1 + mu[..., None] * (p2 - p1)
    snap1 = (isolevel - val1).abs() < eps
    snap2 = (isolevel - val2).abs() < eps
    point = torch.where((snap1 | (degen & ~snap2))[..., None], p1, point)
    point = torch.where((snap2 & ~snap1)[..., None], p2, point)

    # Canonical key: the edge's axis * NV + its lower endpoint, or 3 NV + the
    # endpoint the interpolation snapped to, so coincident snapped vertices
    # merge.
    gmin = torch.minimum(gid1, gid2)
    dgid = (gid2 - gid1).abs()
    axis = torch.where(dgid == 1, 0, torch.where(dgid == W, 1, 2))
    key = axis * NV + gmin
    key = torch.where(snap1, 3 * NV + gid1, key)
    key = torch.where(snap2 & ~snap1, 3 * NV + gid2, key)

    # Drop triangles whose three keys are not pairwise distinct.
    k0, k1, k2 = key[..., 0], key[..., 1], key[..., 2]
    tri_ok = tri_ok & (k0 != k1) & (k1 != k2) & (k2 != k0)

    # Dedup the vertices over every (cell, triangle, corner) entry.
    keys_flat = torch.where(tri_ok[..., None], key, _SENTINEL).reshape(-1)
    order = torch.sort(keys_flat, stable=True).indices
    ks = keys_flat[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    uniq = first & (ks != _SENTINEL)
    ranks_sorted = torch.cumsum(uniq, dim=0) - 1
    verts = point.reshape(-1, 3)[order][uniq]  # the first entry of each key, in key order
    entry_rank = torch.empty_like(ranks_sorted)
    entry_rank[order] = ranks_sorted
    faces = entry_rank.reshape(NCELL * 5, 3)[tri_ok.reshape(-1)]
    return verts, faces


def marching_cubes(
    vol_batch: torch.Tensor,  # (N, D, H, W)
    isolevel: Optional[float] = None,
    return_local_coords: bool = True,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Isosurfaces of a batch of volumes: ([verts_i (Vi, 3)], [faces_i
    (Fi, 3)]), on the volumes' device.  Vertices are in [-1, 1]^3 with
    `return_local_coords` (PyTorch3D's convention), else grid coordinates
    (x in [0, W-1], ...).  Without `isolevel`, each volume's is the mean of
    its max and min."""
    N, D, H, W = vol_batch.shape
    batched_verts, batched_faces = [], []
    for n in range(N):
        vol = vol_batch[n]
        iso = float((vol.max() + vol.min()) / 2.0) if isolevel is None else isolevel
        verts, faces = _mc_one(vol, iso)
        if return_local_coords and verts.shape[0] > 0:
            scale = torch.tensor([W - 1, H - 1, D - 1], dtype=vol.dtype, device=vol.device) * 0.5
            verts = verts / scale - 1.0
        batched_verts.append(verts)
        batched_faces.append(faces)
    return batched_verts, batched_faces


def marching_cubes_naive(vol_batch, isolevel=None, return_local_coords=True):
    """PyTorch3D's name for the same function."""
    return marching_cubes(vol_batch, isolevel, return_local_coords)
