"""Voxel grid -> mesh conversion, "cubify" (port of pytorch3d_tpu/ops/cubify.py).

Each voxel contributes up to 12 triangles (6 cube faces x 2), kept where the
voxel is occupied and its neighbour across the face is empty or outside the
grid.  Vertices live on the (D+1)(H+1)(W+1) corner lattice and are compacted
to a prefix by a cumsum rank over the used corners, and the kept faces by a
cumsum rank over the kept triangles: the same static capacities, vertex
order and face order as the JAX package, batched over the N grids.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..structures.meshes import Meshes

# 12 triangles of a unit cube as corner offsets (dz, dy, dx), outward
# winding, each with the offset of the neighbour across its face.
_CUBE_TRIS = (
    # -x ("left") face
    (((0, 0, 0), (1, 0, 0), (0, 1, 0)), (0, 0, -1)),
    (((0, 1, 0), (1, 0, 0), (1, 1, 0)), (0, 0, -1)),
    # +y ("bottom") face
    (((0, 1, 0), (1, 1, 1), (0, 1, 1)), (0, 1, 0)),
    (((0, 1, 0), (1, 1, 0), (1, 1, 1)), (0, 1, 0)),
    # -z ("front") face
    (((0, 0, 0), (0, 1, 1), (0, 0, 1)), (-1, 0, 0)),
    (((0, 0, 0), (0, 1, 0), (0, 1, 1)), (-1, 0, 0)),
    # -y ("up") face
    (((0, 0, 0), (1, 0, 1), (1, 0, 0)), (0, -1, 0)),
    (((0, 0, 0), (0, 0, 1), (1, 0, 1)), (0, -1, 0)),
    # +x ("right") face
    (((0, 0, 1), (1, 1, 1), (1, 0, 1)), (0, 0, 1)),
    (((0, 0, 1), (0, 1, 1), (1, 1, 1)), (0, 0, 1)),
    # +z ("back") face
    (((1, 0, 0), (1, 1, 1), (1, 1, 0)), (1, 0, 0)),
    (((1, 0, 0), (1, 0, 1), (1, 1, 1)), (1, 0, 0)),
)


def unravel_index(idx: torch.Tensor, dims) -> torch.Tensor:
    """np.unravel_index for dims=(N, H, W, D): (n, h, w, d) per row."""
    if len(dims) != 4:
        raise ValueError("Expects a 4-element list.")
    N, H, W, D = dims
    n = idx // (H * W * D)
    h = (idx - n * H * W * D) // (W * D)
    w = (idx - n * H * W * D - h * W * D) // D
    d = idx - n * H * W * D - h * W * D - w * D
    return torch.stack((n, h, w, d), dim=1)


def ravel_index(idx: torch.Tensor, dims) -> torch.Tensor:
    """Linear index into an array of shape dims=(H, W, D); the inverse of
    `unravel_index` without the batch."""
    if len(dims) != 3:
        raise ValueError("Expects a 3-element list")
    if idx.shape[1] != 3:
        raise ValueError("Expects an index tensor of shape Nx3")
    H, W, D = dims
    return idx[:, 0] * W * D + idx[:, 1] * D + idx[:, 2]


def _compact(values: torch.Tensor, keep: torch.Tensor, ranks: torch.Tensor, fill) -> torch.Tensor:
    """(N, C, ...) rows of `values` moved to their `ranks` where `keep`,
    `fill` elsewhere: the JAX package's `.at[where(keep, rank, C)].set(...,
    mode="drop")` into a buffer of C rows."""
    N, C = keep.shape
    out = values.new_full((N, C + 1) + tuple(values.shape[2:]), fill)
    dest = torch.where(keep, ranks, C)
    index = dest.reshape(N, C, *([1] * (values.ndim - 2))).expand(values.shape)
    out.scatter_(1, index, values)
    return out[:, :C]


def _cubify_batch(vox: torch.Tensor, thresh: float, align: str):
    """vox (N, D, H, W) -> verts (N, NC, 3), faces (N, 12 DHW, 3), the
    counts (N,), and each compacted face's voxel (flat z*H*W + y*W + x, -1
    past the count)."""
    N, D, H, W = vox.shape
    device = vox.device
    occ = vox > thresh
    CH, CW = H + 1, W + 1
    NC = (D + 1) * CH * CW
    zz, yy, xx = torch.meshgrid(
        torch.arange(D, device=device), torch.arange(H, device=device), torch.arange(W, device=device), indexing="ij"
    )

    tri_faces, tri_valid = [], []
    for tri, (dz, dy, dx) in _CUBE_TRIS:
        nz, ny, nx = zz + dz, yy + dy, xx + dx
        inb = (nz >= 0) & (nz < D) & (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
        nocc = occ[:, nz.clamp(0, D - 1), ny.clamp(0, H - 1), nx.clamp(0, W - 1)] & inb
        tri_valid.append(occ & ~nocc)
        tri_faces.append(torch.stack([((zz + c[0]) * CH + yy + c[1]) * CW + xx + c[2] for c in tri], dim=-1))
    faces_all = torch.stack(tri_faces, dim=3).reshape(-1, 3)  # (DHW*12, 3) corner ids
    valid_all = torch.stack(tri_valid, dim=4).reshape(N, -1)  # (N, DHW*12)
    FCAP = faces_all.shape[0]

    # The corners some kept face uses, ranked in corner order.
    dest = torch.where(valid_all[..., None], faces_all, NC).reshape(N, -1)
    used = torch.zeros((N, NC + 1), dtype=torch.bool, device=device)
    used.scatter_(1, dest, True)
    used = used[:, :NC]
    ranks = torch.cumsum(used, dim=1) - 1
    n_verts = used.sum(dim=1)

    # Corner coordinates (the JAX package's normalisation, float32).
    cz, cy, cx = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=device) for n in (D + 1, CH, CW)), indexing="ij"
    )
    if align == "center":
        cx, cy, cz = cx - 0.5, cy - 0.5, cz - 0.5
    margin = 0.0 if align == "corner" else 1.0
    xs = cx * 2.0 / (W - margin) - 1.0
    ys = cy * 2.0 / (H - margin) - 1.0
    zs = cz * 2.0 / (D - margin) - 1.0
    coords = torch.stack([xs, ys, zs], dim=-1).reshape(1, NC, 3).expand(N, NC, 3)
    verts = _compact(coords, used, ranks, 0.0)

    faces_remap = torch.gather(ranks, 1, faces_all.reshape(1, -1).expand(N, -1)).reshape(N, FCAP, 3)
    franks = torch.cumsum(valid_all, dim=1) - 1
    n_faces = valid_all.sum(dim=1)
    faces = _compact(faces_remap, valid_all, franks, -1)
    src_vox = (torch.arange(FCAP, device=device) // 12).expand(N, FCAP)
    vox_ids = _compact(src_vox, valid_all, franks, -1)
    return verts, faces, n_verts, n_faces, vox_ids


def cubify(
    voxels: torch.Tensor,  # (N, D, H, W)
    thresh: float,
    feats: Optional[torch.Tensor] = None,
    device=None,
    align: str = "topleft",
) -> Meshes:
    """Threshold a voxel batch into a `Meshes` batch on the voxels' device
    (or `device`).  Mesh n holds up to (D+1)(H+1)(W+1) vertices and 12 DHW
    faces, compacted in corner and voxel order.  With `feats` (N, K, D, H,
    W) and align "center", each face takes its voxel's feature vector as a
    1x1 `TexturesAtlas`."""
    if align not in ("topleft", "corner", "center"):
        raise ValueError("Align mode must be one of (topleft, corner, center).")
    if voxels.ndim != 4:
        raise ValueError("voxels must be (N, D, H, W)")
    if device is not None:
        voxels = voxels.to(device)
    verts, faces, nv, nf, vox_ids = _cubify_batch(voxels, thresh, align)
    textures = None
    if feats is not None and align == "center":
        if feats.ndim != 5:
            raise ValueError("feats must be (N, K, D, H, W)")
        from ..renderer.mesh.textures import TexturesAtlas

        N, K = feats.shape[:2]
        feats_flat = torch.movedim(feats.to(voxels.device), 1, -1).reshape(N, -1, K)  # (N, DHW, K)
        atlas = torch.gather(feats_flat, 1, vox_ids.clamp(min=0)[..., None].expand(-1, -1, K))
        atlas = torch.where(vox_ids[..., None] >= 0, atlas, 0.0)
        textures = TexturesAtlas.create(atlas[:, :, None, None, :], device=voxels.device)
    return Meshes.create(
        verts, faces, textures=textures, num_verts_per_mesh=nv, num_faces_per_mesh=nf, device=voxels.device
    )
