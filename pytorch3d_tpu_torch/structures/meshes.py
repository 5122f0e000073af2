"""Heterogeneous batches of triangle meshes (port of pytorch3d_tpu/structures/meshes.py).

The storage follows the JAX package exactly, so outputs compare element by
element:

- **Padded-first**: verts `(N, V, 3)` and faces `(N, F, 3)` with per-mesh
  counts; faces are padded with -1, verts with 0.
- **Packed views are reshapes**: mesh i's packed vertex rows are
  `[i*V, (i+1)*V)` and its packed face rows `[i*F, (i+1)*F)`.  Padding rows
  of `faces_packed()` are -1; `verts_packed()[faces_packed()]` through such
  a row wraps to the last vertex in both frameworks, so every consumer masks
  with `faces_packed_mask()`.

`Meshes` is a plain class holding tensors.  `create` builds one on a device
(CUDA unless the caller names another) and `replace` returns a copy with
some fields swapped, as the flax dataclass does in the JAX package.
`offset_verts_` and `scale_verts_` update the vertex tensor in place and
return the same object, where the JAX package returns a new one.

The list accessors, `get_mesh_verts_faces`, `check_shapes`, `submeshes`
and `laplacian_packed` read sizes on the host (one sync each); nothing on
the rendering and fitting paths calls them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..common import DEFAULT_DEVICE
from .utils import list_to_padded

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Meshes:
    """A batch of N triangle meshes with up to V verts / F faces each."""

    _verts_padded: torch.Tensor  # (N, V, 3) float
    _faces_padded: torch.Tensor  # (N, F, 3) int64, -1 padded
    _num_verts_per_mesh: torch.Tensor  # (N,) int64
    _num_faces_per_mesh: torch.Tensor  # (N,) int64
    textures: Optional[Any] = None

    # ------------------------------------------------------------------ #
    # Construction
    # ------------------------------------------------------------------ #
    @classmethod
    def create(
        cls,
        verts: Union[Sequence[torch.Tensor], torch.Tensor],
        faces: Union[Sequence[torch.Tensor], torch.Tensor],
        textures: Optional[Any] = None,
        num_verts_per_mesh: Optional[torch.Tensor] = None,
        num_faces_per_mesh: Optional[torch.Tensor] = None,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> "Meshes":
        """Build from lists of per-mesh arrays or already-padded tensors.

        Lists may be heterogeneous; padded tensors are (N, V, 3)/(N, F, 3).
        Items may be tensors or numpy arrays; all are moved to `device`.
        When padded tensors are given without counts, all meshes use the
        full vertex capacity and count faces as the rows without a -1.
        """
        device = torch.device(device)
        if isinstance(verts, (list, tuple)):
            vs = [torch.as_tensor(v, dtype=torch.float32, device=device) for v in verts]
            nv = torch.tensor([v.shape[0] for v in vs], dtype=torch.int64, device=device)
            verts_padded = (
                list_to_padded(vs)
                if vs
                else torch.zeros((0, 0, 3), dtype=torch.float32, device=device)
            )
        else:
            verts_padded = torch.as_tensor(verts, dtype=torch.float32, device=device)
            if verts_padded.ndim != 3 or verts_padded.shape[-1] != 3:
                raise ValueError("verts must be (N, V, 3)")
            if num_verts_per_mesh is not None:
                nv = torch.as_tensor(num_verts_per_mesh, dtype=torch.int64, device=device)
            else:
                nv = torch.full(
                    (verts_padded.shape[0],), verts_padded.shape[1],
                    dtype=torch.int64, device=device,
                )
        if isinstance(faces, (list, tuple)):
            fs = [torch.as_tensor(f, dtype=torch.int64, device=device) for f in faces]
            nf = torch.tensor([f.shape[0] for f in fs], dtype=torch.int64, device=device)
            faces_padded = (
                list_to_padded(fs, pad_value=-1)
                if fs
                else torch.zeros((0, 0, 3), dtype=torch.int64, device=device)
            )
        else:
            faces_padded = torch.as_tensor(faces, dtype=torch.int64, device=device)
            if faces_padded.ndim != 3 or faces_padded.shape[-1] != 3:
                raise ValueError("faces must be (N, F, 3)")
            if num_faces_per_mesh is not None:
                nf = torch.as_tensor(num_faces_per_mesh, dtype=torch.int64, device=device)
            else:
                nf = torch.sum(torch.all(faces_padded >= 0, dim=-1), dim=-1)
        if verts_padded.shape[0] != faces_padded.shape[0]:
            raise ValueError("verts and faces must have the same batch dimension")
        return cls(
            _verts_padded=verts_padded,
            _faces_padded=faces_padded,
            _num_verts_per_mesh=nv,
            _num_faces_per_mesh=nf,
            textures=textures,
        )

    def replace(self, **changes) -> "Meshes":
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------------ #
    # Basic properties
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return self._verts_padded.shape[0]

    @property
    def device(self) -> torch.device:
        return self._verts_padded.device

    @property
    def max_verts(self) -> int:
        return self._verts_padded.shape[1]

    @property
    def max_faces(self) -> int:
        return self._faces_padded.shape[1]

    def isempty(self) -> bool:
        return len(self) == 0 or self.max_verts == 0

    def num_verts_per_mesh(self) -> torch.Tensor:
        return self._num_verts_per_mesh

    def num_faces_per_mesh(self) -> torch.Tensor:
        return self._num_faces_per_mesh

    # ------------------------------------------------------------------ #
    # Padded views
    # ------------------------------------------------------------------ #
    def verts_padded(self) -> torch.Tensor:
        return self._verts_padded

    def faces_padded(self) -> torch.Tensor:
        return self._faces_padded

    def verts_padded_mask(self) -> torch.Tensor:
        """(N, V) bool — which padded vertex slots are real."""
        ar = torch.arange(self.max_verts, device=self.device)
        return ar[None, :] < self._num_verts_per_mesh[:, None]

    def faces_padded_mask(self) -> torch.Tensor:
        """(N, F) bool — which padded face slots are real."""
        ar = torch.arange(self.max_faces, device=self.device)
        return ar[None, :] < self._num_faces_per_mesh[:, None]

    # ------------------------------------------------------------------ #
    # Packed views (reshapes + masks)
    # ------------------------------------------------------------------ #
    def verts_packed(self) -> torch.Tensor:
        """(N*V, 3) — mesh i occupies rows [i*V, (i+1)*V)."""
        N, V, _ = self._verts_padded.shape
        return self._verts_padded.reshape(N * V, 3)

    def verts_packed_mask(self) -> torch.Tensor:
        return self.verts_padded_mask().reshape(-1)

    def verts_packed_to_mesh_idx(self) -> torch.Tensor:
        N, V, _ = self._verts_padded.shape
        return torch.arange(N, device=self.device).repeat_interleave(V)

    def mesh_to_verts_packed_first_idx(self) -> torch.Tensor:
        return torch.arange(len(self), device=self.device) * self.max_verts

    def faces_packed(self) -> torch.Tensor:
        """(N*F, 3) faces with *global* packed vertex indices; padding rows
        are -1 (mask with `faces_packed_mask`)."""
        N, F, _ = self._faces_padded.shape
        offsets = (torch.arange(N, device=self.device) * self.max_verts)[:, None, None]
        faces = torch.where(self._faces_padded >= 0, self._faces_padded, 0)
        packed = (faces + offsets).reshape(N * F, 3)
        return torch.where(self.faces_packed_mask()[:, None], packed, -1)

    def faces_packed_mask(self) -> torch.Tensor:
        return self.faces_padded_mask().reshape(-1)

    def faces_packed_to_mesh_idx(self) -> torch.Tensor:
        N, F, _ = self._faces_padded.shape
        return torch.arange(N, device=self.device).repeat_interleave(F)

    def mesh_to_faces_packed_first_idx(self) -> torch.Tensor:
        return torch.arange(len(self), device=self.device) * self.max_faces

    # ------------------------------------------------------------------ #
    # Edges (sort-dedup, capacity 3*N*F)
    # ------------------------------------------------------------------ #
    @functools.cached_property
    def _edges(self):
        """(edges_packed, edges_mask, faces_to_edges, num_edges), computed
        once per instance (topology and vertex count are fixed for it)."""
        faces = self.faces_packed()  # (NF, 3) global ids
        valid = self.faces_packed_mask()  # (NF,)
        NF = faces.shape[0]
        NV = self.verts_packed().shape[0]
        device = faces.device

        # Edge order per face as in the JAX package: (v1,v2), (v0,v2), (v0,v1).
        edges_all = torch.cat([faces[:, 1:3], faces[:, 0:3:2], faces[:, 0:2]], dim=0)  # (3NF, 2)
        valid_all = valid.repeat(3)
        a = torch.minimum(edges_all[:, 0], edges_all[:, 1])
        b = torch.maximum(edges_all[:, 0], edges_all[:, 1])
        # Invalid edges go to a sentinel that sorts last.
        a = torch.where(valid_all, a, NV)
        b = torch.where(valid_all, b, NV)
        # Sort by a, then b (a stable two-pass sort, as jnp.lexsort).
        order = torch.sort(b, stable=True).indices
        order = order[torch.sort(a[order], stable=True).indices]
        a_s, b_s = a[order], b[order]
        first = torch.ones_like(a_s, dtype=torch.bool)
        first[1:] = (a_s[1:] != a_s[:-1]) | (b_s[1:] != b_s[:-1])
        uniq = first & (a_s < NV)
        ranks = torch.cumsum(uniq.long(), 0) - 1  # rank of each sorted edge's unique id
        num_edges = uniq.sum()

        E_cap = 3 * NF
        # Unique edges compacted in rank order; padding rows stay -1.
        edges_packed = torch.full((E_cap, 2), -1, dtype=torch.int64, device=device)
        edges_packed[ranks[uniq]] = torch.stack([a_s, b_s], dim=-1)[uniq]
        edges_mask = torch.arange(E_cap, device=device) < num_edges
        # Each (face, slot) to its unique edge index.
        inverse = torch.zeros(E_cap, dtype=torch.int64, device=device)
        inverse[order] = ranks
        faces_to_edges = torch.stack([inverse[0:NF], inverse[NF : 2 * NF], inverse[2 * NF :]], dim=1)
        return edges_packed, edges_mask, faces_to_edges, num_edges

    def edges_packed(self) -> torch.Tensor:
        """(3*N*F, 2) unique edges (global vert ids, smaller first), in
        ascending order, -1 past `num_edges()`."""
        return self._edges[0]

    def edges_packed_mask(self) -> torch.Tensor:
        return self._edges[1]

    def faces_packed_to_edges_packed(self) -> torch.Tensor:
        """(N*F, 3): per-face unique-edge ids; column k is the edge opposite
        vertex k."""
        return self._edges[2]

    def num_edges(self) -> torch.Tensor:
        return self._edges[3]

    def edges_packed_to_mesh_idx(self) -> torch.Tensor:
        edges, mask, _, _ = self._edges
        return torch.where(mask, edges[:, 0] // self.max_verts, -1)

    def num_edges_per_mesh(self) -> torch.Tensor:
        mask = self.edges_packed_mask()
        idx = torch.where(mask, self.edges_packed_to_mesh_idx(), 0)
        counts = torch.zeros(len(self), dtype=torch.int64, device=self.device)
        return counts.index_add_(0, idx, mask.long())

    # ------------------------------------------------------------------ #
    # Normals and areas
    # ------------------------------------------------------------------ #
    def faces_verts_packed(self) -> torch.Tensor:
        """(N*F, 3, 3) — the three vertex positions of each packed face."""
        return self.verts_packed()[self.faces_packed()]

    def _face_areas_normals(self):
        fv = self.faces_verts_packed()
        v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
        n = torch.linalg.cross(v1 - v0, v2 - v0)
        nn2 = torch.sum(n * n, dim=-1, keepdim=True)
        # Degenerate faces (padding included) get zero area and normal with
        # zero, not NaN, gradients.
        degenerate = nn2 < 1e-20
        nn = torch.sqrt(torch.where(degenerate, torch.ones_like(nn2), nn2))
        areas = torch.where(degenerate[..., 0], 0.0, 0.5 * nn[..., 0])
        normals = torch.where(degenerate, 0.0, n / nn)
        mask = self.faces_packed_mask()
        return torch.where(mask, areas, 0.0), torch.where(mask[:, None], normals, 0.0)

    def faces_areas_packed(self) -> torch.Tensor:
        return self._face_areas_normals()[0]

    def faces_normals_packed(self) -> torch.Tensor:
        return self._face_areas_normals()[1]

    def faces_normals_padded(self) -> torch.Tensor:
        N, F, _ = self._faces_padded.shape
        return self.faces_normals_packed().reshape(N, F, 3)

    def verts_normals_packed(self) -> torch.Tensor:
        """Area-weighted vertex normals.

        Each face adds its unnormalized cross product to its three vertices
        and the sums are normalized.  Padding faces add zero to vertex 0
        (torch's `index_add_` refuses the -1 index JAX would wrap).
        """
        verts = self.verts_packed()
        faces = self.faces_packed()
        mask = self.faces_packed_mask()
        fv = verts[faces]
        n = torch.linalg.cross(fv[:, 2] - fv[:, 1], fv[:, 0] - fv[:, 1])
        n = torch.where(mask[:, None], n, 0.0)
        idx = faces.clamp(min=0)
        acc = torch.zeros_like(verts)
        for k in range(3):
            acc = acc.index_add(0, idx[:, k], n)
        nn2 = torch.sum(acc * acc, dim=-1, keepdim=True)
        zero = nn2 < 1e-20
        return torch.where(zero, 0.0, acc / torch.sqrt(torch.where(zero, torch.ones_like(nn2), nn2)))

    def verts_normals_padded(self) -> torch.Tensor:
        N, V, _ = self._verts_padded.shape
        return self.verts_normals_packed().reshape(N, V, 3)

    # ------------------------------------------------------------------ #
    # Updates (functional)
    # ------------------------------------------------------------------ #
    def update_padded(self, new_verts_padded: torch.Tensor) -> "Meshes":
        """Replace vertex positions, keeping topology and textures."""
        if new_verts_padded.shape != self._verts_padded.shape:
            raise ValueError("new values must have the same shape as the current.")
        return self.replace(_verts_padded=new_verts_padded)

    def _vert_offsets(self, vert_offsets_packed: torch.Tensor) -> torch.Tensor:
        """A (3,) offset or one (N*V, 3) row per packed vertex as (N, V, 3)."""
        offs = torch.as_tensor(vert_offsets_packed, dtype=self._verts_padded.dtype, device=self.device)
        if offs.shape == (3,):
            return offs.expand(self._verts_padded.shape)
        if offs.shape != (len(self) * self.max_verts, 3):
            raise ValueError("Verts offsets must have dimension (all_v, 3).")
        return offs.reshape(self._verts_padded.shape)

    def _mesh_scales(self, scale) -> torch.Tensor:
        scale = torch.as_tensor(scale, dtype=self._verts_padded.dtype, device=self.device)
        if scale.ndim == 0:
            scale = scale.expand(len(self))
        return scale[:, None, None]

    def offset_verts(self, vert_offsets_packed: torch.Tensor) -> "Meshes":
        """Verts moved by a (3,) offset or one (N*V, 3) row per packed vertex."""
        return self.update_padded(self._verts_padded + self._vert_offsets(vert_offsets_packed))

    def offset_verts_(self, vert_offsets_packed: torch.Tensor) -> "Meshes":
        """`offset_verts` in place on the vertex tensor; returns self."""
        self._verts_padded.add_(self._vert_offsets(vert_offsets_packed))
        return self

    def scale_verts(self, scale) -> "Meshes":
        """Each mesh scaled by a scalar or by its entry of an (N,) tensor."""
        return self.update_padded(self._verts_padded * self._mesh_scales(scale))

    def scale_verts_(self, scale) -> "Meshes":
        """`scale_verts` in place on the vertex tensor; returns self."""
        self._verts_padded.mul_(self._mesh_scales(scale))
        return self

    def _apply(self, fn) -> "Meshes":
        """`fn` applied to every tensor and to the textures' tensors."""
        return Meshes(
            _verts_padded=fn(self._verts_padded),
            _faces_padded=fn(self._faces_padded),
            _num_verts_per_mesh=fn(self._num_verts_per_mesh),
            _num_faces_per_mesh=fn(self._num_faces_per_mesh),
            textures=None if self.textures is None else self.textures._map_tensors(fn),
        )

    def detach(self) -> "Meshes":
        return self._apply(torch.Tensor.detach)

    def clone(self) -> "Meshes":
        return self._apply(torch.clone)

    def to(self, device: Device) -> "Meshes":
        return self._apply(lambda t: t.to(device))

    def cpu(self) -> "Meshes":
        return self.to("cpu")

    def cuda(self) -> "Meshes":
        return self.to("cuda")

    def check_shapes(self) -> bool:
        """Raise unless the padded tensors and counts agree (one host sync)."""
        N = len(self)
        ok = (
            self._verts_padded.ndim == 3 and self._verts_padded.shape[-1] == 3
            and self._faces_padded.ndim == 3 and self._faces_padded.shape[-1] == 3
            and self._num_verts_per_mesh.shape == (N,) and self._num_faces_per_mesh.shape == (N,)
            and bool((self._num_verts_per_mesh <= self.max_verts).all()
                     & (self._num_faces_per_mesh <= self.max_faces).all())
        )
        if not ok:
            raise ValueError("Meshes padded/count shapes are inconsistent.")
        return True

    def get_bounding_boxes(self) -> torch.Tensor:
        """(N, 3, 2) per-mesh min and max corners over the real verts."""
        mask = self.verts_padded_mask()[..., None]
        mins = torch.where(mask, self._verts_padded, torch.inf).amin(dim=1)
        maxs = torch.where(mask, self._verts_padded, -torch.inf).amax(dim=1)
        return torch.stack([mins, maxs], dim=-1)

    def has_verts_normals(self) -> bool:
        """Vertex normals are computed on demand, so always available."""
        return True

    def verts_padded_to_packed_idx(self) -> torch.Tensor:
        """Packed position -> padded flat index: the identity over all N*V
        slots in this padded-first layout; compose with
        `verts_packed_mask()` for validity."""
        return torch.arange(len(self) * self.max_verts, device=self.device)

    def mesh_to_edges_packed_first_idx(self) -> torch.Tensor:
        """(N,) first row of each mesh in `edges_packed()`."""
        num = self.num_edges_per_mesh()
        return torch.cumsum(num, 0) - num

    def laplacian_packed(self) -> torch.Tensor:
        """The uniform Laplacian over the packed verts, a sparse (N*V, N*V)
        COO tensor (the real edges are cut out on the host)."""
        from ..ops.laplacian_matrices import laplacian

        edges = self.edges_packed()
        return laplacian(self.verts_packed(), edges[self.edges_packed_mask()])

    # ------------------------------------------------------------------ #
    # Batch manipulation
    # ------------------------------------------------------------------ #
    def __getitem__(self, index) -> "Meshes":
        """The meshes at `index` (an int, a list, a slice or an index
        tensor), as one batch of the same padded widths."""
        if isinstance(index, int):
            index = [index]
        if isinstance(index, (list, tuple)):
            index = torch.as_tensor(index, dtype=torch.int64, device=self.device)
        return Meshes(
            _verts_padded=self._verts_padded[index],
            _faces_padded=self._faces_padded[index],
            _num_verts_per_mesh=self._num_verts_per_mesh[index],
            _num_faces_per_mesh=self._num_faces_per_mesh[index],
            textures=self.textures[index] if self.textures is not None else None,
        )

    def extend(self, N: int) -> "Meshes":
        """Each mesh repeated N times, consecutively."""
        if not isinstance(N, int) or N <= 0:
            raise ValueError("N must be > 0.")
        return self[torch.arange(len(self), device=self.device).repeat_interleave(N)]

    # ------------------------------------------------------------------ #
    # List accessors (host-side)
    # ------------------------------------------------------------------ #
    def verts_list(self) -> List[torch.Tensor]:
        counts = self._num_verts_per_mesh.tolist()
        return [self._verts_padded[i, :n] for i, n in enumerate(counts)]

    def faces_list(self) -> List[torch.Tensor]:
        counts = self._num_faces_per_mesh.tolist()
        return [self._faces_padded[i, :n] for i, n in enumerate(counts)]

    def verts_normals_list(self) -> List[torch.Tensor]:
        normals = self.verts_normals_padded()
        return [normals[i, :n] for i, n in enumerate(self._num_verts_per_mesh.tolist())]

    def faces_normals_list(self) -> List[torch.Tensor]:
        normals = self.faces_normals_padded()
        return [normals[i, :n] for i, n in enumerate(self._num_faces_per_mesh.tolist())]

    def get_mesh_verts_faces(self, index: int):
        """(verts, faces) of mesh `index`, cut to its counts."""
        if not isinstance(index, int):
            raise ValueError("Mesh index must be an integer.")
        if index < 0 or index >= len(self):
            raise ValueError("Mesh index out of bounds.")
        nv, nf = int(self._num_verts_per_mesh[index]), int(self._num_faces_per_mesh[index])
        return self._verts_padded[index, :nv], self._faces_padded[index, :nf]

    def split(self, split_sizes: List[int]) -> List["Meshes"]:
        """The batch cut into consecutive sub-batches of the given sizes."""
        if sum(int(s) for s in split_sizes) != len(self):
            raise ValueError("Split sizes must sum to the batch size.")
        out, start = [], 0
        for s in split_sizes:
            out.append(self[slice(start, start + int(s))])
            start += int(s)
        return out

    def submeshes(self, face_indices) -> "Meshes":
        """Sub-meshes cut by per-mesh lists of face-index tensors (local face
        ids), one per inner tensor, in order, without textures; each keeps
        the verts its faces use, in ascending order (host-side)."""
        if len(face_indices) != len(self):
            raise ValueError(
                "You must specify exactly one set of submeshes for each mesh in this Meshes object."
            )
        sub_verts, sub_faces = [], []
        for i, per_mesh in enumerate(face_indices):
            for idx in per_mesh:
                idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device).reshape(-1)
                faces = self._faces_padded[i][idx]  # (S, 3) local vert ids
                uniq, inverse = torch.unique(faces.reshape(-1), sorted=True, return_inverse=True)
                sub_verts.append(self._verts_padded[i][uniq])
                sub_faces.append(inverse.reshape(-1, 3))
        return Meshes.create(sub_verts, sub_faces, device=self.device)

    def sample_textures(self, fragments):
        if self.textures is None:
            raise ValueError("Meshes does not have textures")
        return self.textures.sample_textures(fragments, faces_packed=self.faces_packed())



def join_meshes_as_batch(meshes: List[Meshes], include_textures: bool = True) -> Meshes:
    """Several batches concatenated into one, padded to the widest verts
    and faces; textures join when every batch has them."""
    if isinstance(meshes, Meshes):
        raise ValueError("Wrong first argument to join_meshes_as_batch.")
    V = max(m.max_verts for m in meshes)
    Fm = max(m.max_faces for m in meshes)
    tex = None
    if include_textures and all(m.textures is not None for m in meshes):
        tex = type(meshes[0].textures).join_batch([m.textures for m in meshes])
    return Meshes(
        _verts_padded=torch.cat([F.pad(m._verts_padded, (0, 0, 0, V - m.max_verts)) for m in meshes]),
        _faces_padded=torch.cat([F.pad(m._faces_padded, (0, 0, 0, Fm - m.max_faces), value=-1) for m in meshes]),
        _num_verts_per_mesh=torch.cat([m._num_verts_per_mesh for m in meshes]),
        _num_faces_per_mesh=torch.cat([m._num_faces_per_mesh for m in meshes]),
        textures=tex,
    )


def join_meshes_as_scene(meshes, include_textures: bool = True) -> Meshes:
    """One scene mesh from a batch (or a list, joined as a batch first).

    The scene keeps all N*V padded verts (vertex ids are the packed ones);
    its faces are the real faces moved to the front in packed order by a
    stable sort, padded with -1 to N*F.  Per-face texture data follows the
    same order (`join_scene(face_order=...)`).  No host sync.
    """
    if isinstance(meshes, (list, tuple)):
        meshes = join_meshes_as_batch(list(meshes), include_textures=include_textures)
    fmask = meshes.faces_packed_mask()
    order = torch.argsort((~fmask).to(torch.int8), stable=True)
    faces = torch.where(fmask[order][:, None], meshes.faces_packed()[order], -1)
    tex = None
    if include_textures and meshes.textures is not None:
        tex = meshes.textures.join_scene(face_order=order)
    return Meshes(
        _verts_padded=meshes.verts_packed()[None],
        _faces_padded=faces[None],
        _num_verts_per_mesh=torch.full((1,), len(meshes) * meshes.max_verts, dtype=torch.int64, device=meshes.device),
        _num_faces_per_mesh=fmask.sum()[None],
        textures=tex,
    )
