"""Mesh textures (port of pytorch3d_tpu/renderer/mesh/textures.py).

Three texture types, frozen dataclasses with padded storage:

- `TexturesVertex`: per-vertex colours, barycentric-interpolated;
- `TexturesUV`: per-face-corner UVs into one map per mesh, sampled with
  `ops/grid_sample.py` (u, v in [0, 1], v = 0 at the bottom);
- `TexturesAtlas`: an R x R texel patch per face, indexed by barycentrics.

`sample_textures(fragments, faces_packed=...)` returns texels (N, H, W, K, C).
`create` builds one on a device (CUDA unless the caller names another).
Per-mesh counts are recorded when a texture is made from lists, so that
the list accessors can unpad; None means every padded slot is real.
"""

from __future__ import annotations

import abc
import dataclasses
import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ...common import DEFAULT_DEVICE
from ...common.gather import gather_rows
from ...ops.grid_sample import sample_channels_last
from ...ops.interp_face_attrs import interpolate_face_attributes
from ...structures.utils import list_to_padded

Device = Union[str, torch.device]


def _subset_counts(counts, index):
    """A per-mesh count tuple at a batch index (int list, tensor or slice)."""
    if counts is None:
        return None
    if isinstance(index, slice):
        return tuple(counts[index])
    if isinstance(index, torch.Tensor):
        index = index.tolist()
    return tuple(int(counts[int(i)]) for i in np.asarray(index).reshape(-1))


def _batch_index(index, device):
    """An int or a list of ints as an index tensor; tensors and slices pass."""
    if isinstance(index, int):
        index = [index]
    if isinstance(index, (list, tuple)):
        index = torch.as_tensor(index, dtype=torch.int64, device=device)
    return index


def _repeat_counts(counts, N: int):
    return tuple(n for n in counts for _ in range(N)) if counts else None


def _repeat_index(batch: int, N: int, device) -> torch.Tensor:
    if not isinstance(N, int) or N <= 0:
        raise ValueError("N must be > 0.")
    return torch.arange(batch, device=device).repeat_interleave(N)


def _pad_dim1(x: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad axis 1 of x up to `size`."""
    pad = [0, 0] * (x.ndim - 2) + [0, size - x.shape[1]]
    return torch.nn.functional.pad(x, pad)


class TexturesBase(abc.ABC):
    """Common interface of the texture classes."""

    def sample_textures(self, fragments, faces_packed=None):
        raise NotImplementedError

    def faces_verts_textures_packed(self, *args, **kwargs):
        raise NotImplementedError

    def join_batch(self, textures):
        raise NotImplementedError

    def join_scene(self, face_order=None):
        raise NotImplementedError

    def replace(self, **changes):
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)

    def _map_tensors(self, fn):
        """A copy with `fn` applied to every tensor field."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def clone(self):
        return self._map_tensors(torch.clone)

    def detach(self):
        return self._map_tensors(torch.Tensor.detach)


@dataclasses.dataclass(frozen=True)
class TexturesVertex(TexturesBase):
    """Per-vertex color textures, barycentric-interpolated."""

    _verts_features_padded: torch.Tensor  # (N, V, C)
    _num_verts: Optional[Tuple[int, ...]] = None

    @classmethod
    def create(cls, verts_features, device: Device = DEFAULT_DEVICE) -> "TexturesVertex":
        """From a list of (V_i, C) features or an (N, V, C) tensor."""
        num = None
        if isinstance(verts_features, (list, tuple)):
            num = tuple(int(f.shape[0]) for f in verts_features)
            verts_features = list_to_padded(
                [torch.as_tensor(f, dtype=torch.float32, device=device) for f in verts_features]
            )
        else:
            verts_features = torch.as_tensor(verts_features, dtype=torch.float32, device=device)
        if verts_features.ndim != 3:
            raise ValueError("verts_features must be (N, V, C)")
        return cls(_verts_features_padded=verts_features, _num_verts=num)

    def verts_features_padded(self) -> torch.Tensor:
        return self._verts_features_padded

    def verts_features_list(self) -> List[torch.Tensor]:
        """Per-mesh (V_i, C) features."""
        x = self._verts_features_padded
        counts = self._num_verts or (x.shape[1],) * x.shape[0]
        return [x[i, :n] for i, n in enumerate(counts)]

    def verts_features_packed(self) -> torch.Tensor:
        N, V, C = self._verts_features_padded.shape
        return self._verts_features_padded.reshape(N * V, C)

    def faces_verts_textures_packed(self, faces_packed=None) -> torch.Tensor:
        """(N*F, 3, C) features at each face's vertices; `faces_packed` are
        the mesh's packed vertex ids."""
        if faces_packed is None:
            raise ValueError(
                "TexturesVertex.faces_verts_textures_packed needs the mesh's faces_packed()."
            )
        return self.verts_features_packed()[faces_packed.clamp(min=0)]

    def extend(self, N: int) -> "TexturesVertex":
        """Each texture repeated N times, consecutively."""
        idx = _repeat_index(self._verts_features_padded.shape[0], N, self._verts_features_padded.device)
        return self.replace(
            _verts_features_padded=self._verts_features_padded[idx],
            _num_verts=_repeat_counts(self._num_verts, N),
        )

    def check_shapes(self) -> bool:
        if self._verts_features_padded.ndim != 3:
            raise ValueError("verts_features must be (N, V, C)")
        return True

    def submeshes(self, vertex_ids_list, faces_ids_list) -> "TexturesVertex":
        """One texture per (mesh, vertex-id set), as Meshes.submeshes cuts."""
        out = []
        for per_mesh_ids, f in zip(vertex_ids_list, self.verts_features_list()):
            for ids in per_mesh_ids:
                out.append(f[torch.as_tensor(ids, device=f.device)])
        return TexturesVertex.create(out, device=self._verts_features_padded.device)

    def sample_textures(self, fragments, faces_packed: torch.Tensor) -> torch.Tensor:
        faces_feats = self.verts_features_packed()[faces_packed]  # (F, 3, C)
        return interpolate_face_attributes(
            fragments.pix_to_face, fragments.bary_coords, faces_feats
        )

    def __getitem__(self, index) -> "TexturesVertex":
        index = _batch_index(index, self._verts_features_padded.device)
        return TexturesVertex(
            _verts_features_padded=self._verts_features_padded[index],
            _num_verts=_subset_counts(self._num_verts, index),
        )

    @classmethod
    def join_batch(cls, textures: List["TexturesVertex"]) -> "TexturesVertex":
        V = max(t._verts_features_padded.shape[1] for t in textures)
        return cls(_verts_features_padded=torch.cat([_pad_dim1(t._verts_features_padded, V) for t in textures]))

    def join_scene(self, face_order=None) -> "TexturesVertex":
        """One texture for the whole batch: the features follow
        verts_packed, so face compaction leaves them as they are."""
        N, V, C = self._verts_features_padded.shape
        return TexturesVertex(_verts_features_padded=self._verts_features_padded.reshape(1, N * V, C))


@dataclasses.dataclass(frozen=True)
class TexturesUV(TexturesBase):
    """UV-mapped texture images, one map per mesh."""

    _maps_padded: torch.Tensor  # (N, Hm, Wm, C)
    _faces_uvs_padded: torch.Tensor  # (N, F, 3) int64 into verts_uvs, padded with 0
    _verts_uvs_padded: torch.Tensor  # (N, Vuv, 2)
    padding_mode: str = "border"
    align_corners: bool = True
    sampling_mode: str = "bilinear"
    _num_faces: Optional[Tuple[int, ...]] = None
    _num_verts_uvs: Optional[Tuple[int, ...]] = None

    @classmethod
    def create(
        cls,
        maps,
        faces_uvs,
        verts_uvs,
        padding_mode: str = "border",
        align_corners: bool = True,
        sampling_mode: str = "bilinear",
        device: Device = DEFAULT_DEVICE,
    ) -> "TexturesUV":
        """From lists of per-mesh arrays or batched tensors: maps (N, H, W,
        C), faces_uvs (N, F, 3), verts_uvs (N, Vuv, 2)."""
        num_f = num_v = None
        if isinstance(maps, (list, tuple)):
            maps = torch.stack([torch.as_tensor(m, dtype=torch.float32, device=device) for m in maps])
        else:
            maps = torch.as_tensor(maps, dtype=torch.float32, device=device)
        if isinstance(faces_uvs, (list, tuple)):
            fs = [torch.as_tensor(f, dtype=torch.int64, device=device) for f in faces_uvs]
            num_f = tuple(int(f.shape[0]) for f in fs)
            faces_uvs = list_to_padded(fs, pad_value=0)
        else:
            faces_uvs = torch.as_tensor(faces_uvs, dtype=torch.int64, device=device)
        if isinstance(verts_uvs, (list, tuple)):
            vs = [torch.as_tensor(v, dtype=torch.float32, device=device) for v in verts_uvs]
            num_v = tuple(int(v.shape[0]) for v in vs)
            verts_uvs = list_to_padded(vs)
        else:
            verts_uvs = torch.as_tensor(verts_uvs, dtype=torch.float32, device=device)
        if maps.ndim != 4:
            raise ValueError("maps must be (N, H, W, C)")
        if not maps.shape[0] == faces_uvs.shape[0] == verts_uvs.shape[0]:
            raise ValueError("maps, faces_uvs and verts_uvs must have the same batch dimension")
        return cls(
            _maps_padded=maps, _faces_uvs_padded=faces_uvs, _verts_uvs_padded=verts_uvs,
            padding_mode=padding_mode, align_corners=align_corners, sampling_mode=sampling_mode,
            _num_faces=num_f, _num_verts_uvs=num_v,
        )

    def maps_padded(self) -> torch.Tensor:
        return self._maps_padded

    def maps_list(self) -> List[torch.Tensor]:
        return list(self._maps_padded.unbind(0))

    def faces_uvs_padded(self) -> torch.Tensor:
        return self._faces_uvs_padded

    def faces_uvs_list(self) -> List[torch.Tensor]:
        x = self._faces_uvs_padded
        counts = self._num_faces or (x.shape[1],) * x.shape[0]
        return [x[i, :n] for i, n in enumerate(counts)]

    def verts_uvs_padded(self) -> torch.Tensor:
        return self._verts_uvs_padded

    def verts_uvs_list(self) -> List[torch.Tensor]:
        x = self._verts_uvs_padded
        counts = self._num_verts_uvs or (x.shape[1],) * x.shape[0]
        return [x[i, :n] for i, n in enumerate(counts)]

    def maps_ids_padded(self):
        """One map per mesh, so None, as for single-map textures."""
        return None

    def maps_ids_list(self):
        return None

    def _sample(self, gx: torch.Tensor, gy: torch.Tensor, spread=None) -> torch.Tensor:
        return sample_channels_last(
            self._maps_padded, gx, gy, self.sampling_mode, self.padding_mode, self.align_corners, spread,
        )

    def faces_verts_textures_packed(self) -> torch.Tensor:
        """(N*F, 3, C) texels at each face vertex's UV."""
        N, F = self._faces_uvs_padded.shape[:2]
        fuv = self.faces_verts_uvs_packed().reshape(N, F * 3, 2)
        texels = self._sample(fuv[..., 0] * 2.0 - 1.0, 1.0 - 2.0 * fuv[..., 1])  # (N, F*3, C)
        return texels.reshape(N * F, 3, -1)

    def centers_for_image(self, index: int) -> torch.Tensor:
        """(V, 2) texture-image pixel coordinates of one mesh's verts_uvs."""
        if self._maps_padded.shape[0] != 1:
            raise ValueError("This function only supports plotting textures for one mesh.")
        _, H, W, _ = self._maps_padded.shape
        verts_uvs = self.verts_uvs_list()[index]
        return torch.stack([verts_uvs[:, 0] * (W - 1), (1.0 - verts_uvs[:, 1]) * (H - 1)], dim=1)

    def extend(self, N: int) -> "TexturesUV":
        idx = _repeat_index(self._maps_padded.shape[0], N, self._maps_padded.device)
        return self.replace(
            _maps_padded=self._maps_padded[idx],
            _faces_uvs_padded=self._faces_uvs_padded[idx],
            _verts_uvs_padded=self._verts_uvs_padded[idx],
            _num_faces=_repeat_counts(self._num_faces, N),
            _num_verts_uvs=_repeat_counts(self._num_verts_uvs, N),
        )

    def check_shapes(self) -> bool:
        m, f, v = self._maps_padded, self._faces_uvs_padded, self._verts_uvs_padded
        ok = (
            m.ndim == 4 and f.ndim == 3 and f.shape[-1] == 3 and v.ndim == 3 and v.shape[-1] == 2
            and m.shape[0] == f.shape[0] == v.shape[0]
        )
        if not ok:
            raise ValueError("TexturesUV shapes are inconsistent.")
        return True

    def submeshes(self, vertex_ids_list, faces_ids_list) -> "TexturesUV":
        """Each submesh's faces' UV rows, verts_uvs reindexed to the used
        subset.  Host-side."""
        fl, vl, ml = self.faces_uvs_list(), self.verts_uvs_list(), self.maps_list()
        maps, faces_out, verts_out = [], [], []
        for mesh_i, per_mesh_fids in enumerate(faces_ids_list):
            for fids in per_mesh_fids:
                f = fl[mesh_i].cpu().numpy()[np.asarray(fids)]
                used, inv = np.unique(f.reshape(-1), return_inverse=True)
                faces_out.append(inv.reshape(f.shape))
                verts_out.append(vl[mesh_i][torch.as_tensor(used, device=vl[mesh_i].device)])
                maps.append(ml[mesh_i])
        return TexturesUV.create(
            maps=maps, faces_uvs=faces_out, verts_uvs=verts_out, padding_mode=self.padding_mode,
            align_corners=self.align_corners, sampling_mode=self.sampling_mode,
            device=self._maps_padded.device,
        )

    def faces_verts_uvs_packed(self) -> torch.Tensor:
        """(N*F, 3, 2) uv coordinates of each face's three corners."""
        N, F = self._faces_uvs_padded.shape[:2]
        idx = self._faces_uvs_padded.reshape(N, F * 3, 1).expand(-1, -1, 2)
        return torch.gather(self._verts_uvs_padded, 1, idx).reshape(N * F, 3, 2)

    def sample_textures(self, fragments, faces_packed=None) -> torch.Tensor:
        """Interpolate per-pixel UVs, then sample the maps: (N, H, W, K, C).

        Grid x = 2u - 1, y = 1 - 2v.  An empty slot's uv is 0
        (`interpolate_face_attributes`), so it takes the map's texel at
        grid (-1, 1), which is sampled once per image: the slots gather
        spread rows, so the map's backward does not pile their zeros onto
        one texel."""
        pix_to_face = fragments.pix_to_face
        N = pix_to_face.shape[0]
        pixel_uvs = interpolate_face_attributes(
            pix_to_face, fragments.bary_coords, self.faces_verts_uvs_packed()
        )  # (N, H, W, K, 2)
        empty = pix_to_face < 0
        texels = self._sample(pixel_uvs[..., 0] * 2.0 - 1.0, 1.0 - 2.0 * pixel_uvs[..., 1], spread=empty)
        corner = self._sample(pixel_uvs.new_full((N, 1), -1.0), pixel_uvs.new_full((N, 1), 1.0))  # (N, 1, C)
        corner = corner.reshape(N, *([1] * (pix_to_face.ndim - 1)), -1)
        return torch.where(empty[..., None], corner, texels)

    def __getitem__(self, index) -> "TexturesUV":
        index = _batch_index(index, self._maps_padded.device)
        return self.replace(
            _maps_padded=self._maps_padded[index],
            _faces_uvs_padded=self._faces_uvs_padded[index],
            _verts_uvs_padded=self._verts_uvs_padded[index],
            _num_faces=_subset_counts(self._num_faces, index),
            _num_verts_uvs=_subset_counts(self._num_verts_uvs, index),
        )

    def join_scene(self, face_order=None) -> "TexturesUV":
        """One texture for the batch: the maps side by side, each mesh's u
        clamped half a texel inside its own map (so that the bilinear
        support never reaches the next map) and offset into the row.

        `face_order` is the packed-face permutation with which the scene's
        valid faces are compacted; the face UV rows follow it."""
        N, Hm, Wm, C = self._maps_padded.shape
        packed = torch.cat(list(self._maps_padded.unbind(0)), dim=1)[None]  # (1, Hm, N*Wm, C)
        half_texel = 0.5 / max(Wm - 1, 1)
        new_uvs = []
        for i in range(N):
            uv = self._verts_uvs_padded[i]
            u = (torch.clamp(uv[:, 0], half_texel, 1.0 - half_texel) + i) / N
            new_uvs.append(torch.stack([u, uv[:, 1]], dim=1))
        verts_uvs = torch.cat(new_uvs, dim=0)[None]
        Vuv = self._verts_uvs_padded.shape[1]
        offsets = (torch.arange(N, device=packed.device) * Vuv)[:, None, None]
        faces_uvs = (self._faces_uvs_padded + offsets).reshape(1, -1, 3)
        if face_order is not None:
            faces_uvs = faces_uvs[:, face_order]
        return TexturesUV(
            _maps_padded=packed, _faces_uvs_padded=faces_uvs, _verts_uvs_padded=verts_uvs,
            padding_mode=self.padding_mode, align_corners=self.align_corners, sampling_mode=self.sampling_mode,
        )

    @classmethod
    def join_batch(cls, textures: List["TexturesUV"]) -> "TexturesUV":
        first = textures[0]
        Hm = max(t._maps_padded.shape[1] for t in textures)
        Wm = max(t._maps_padded.shape[2] for t in textures)
        F = max(t._faces_uvs_padded.shape[1] for t in textures)
        V = max(t._verts_uvs_padded.shape[1] for t in textures)

        def pad_map(x):
            return torch.nn.functional.pad(x, (0, 0, 0, Wm - x.shape[2], 0, Hm - x.shape[1]))

        return cls(
            _maps_padded=torch.cat([pad_map(t._maps_padded) for t in textures]),
            _faces_uvs_padded=torch.cat([_pad_dim1(t._faces_uvs_padded, F) for t in textures]),
            _verts_uvs_padded=torch.cat([_pad_dim1(t._verts_uvs_padded, V) for t in textures]),
            padding_mode=first.padding_mode, align_corners=first.align_corners,
            sampling_mode=first.sampling_mode,
        )


@dataclasses.dataclass(frozen=True)
class TexturesAtlas(TexturesBase):
    """An R x R texel patch per face."""

    _atlas_padded: torch.Tensor  # (N, F, R, R, C)
    _num_faces: Optional[Tuple[int, ...]] = None

    @classmethod
    def create(cls, atlas, device: Device = DEFAULT_DEVICE) -> "TexturesAtlas":
        """From a list of (F_i, R, R, C) atlases or an (N, F, R, R, C) tensor."""
        num = None
        if isinstance(atlas, (list, tuple)):
            atlas = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in atlas]
            num = tuple(int(a.shape[0]) for a in atlas)
            atlas = list_to_padded(atlas)
        else:
            atlas = torch.as_tensor(atlas, dtype=torch.float32, device=device)
        if atlas.ndim != 5:
            raise ValueError("atlas must be (N, F, R, R, C)")
        return cls(_atlas_padded=atlas, _num_faces=num)

    def atlas_padded(self) -> torch.Tensor:
        return self._atlas_padded

    def atlas_list(self) -> List[torch.Tensor]:
        x = self._atlas_padded
        counts = self._num_faces or (x.shape[1],) * x.shape[0]
        return [x[i, :n] for i, n in enumerate(counts)]

    def atlas_packed(self) -> torch.Tensor:
        N, F = self._atlas_padded.shape[:2]
        return self._atlas_padded.reshape(N * F, *self._atlas_padded.shape[2:])

    def faces_verts_textures_packed(self) -> torch.Tensor:
        """(N*F, 3, C): the atlas texels at barycentric corners (1, 0),
        (0, 1) and (0, 0)."""
        atlas = self.atlas_packed()
        return torch.stack([atlas[:, 0, -1], atlas[:, -1, 0], atlas[:, 0, 0]], dim=1)

    def extend(self, N: int) -> "TexturesAtlas":
        idx = _repeat_index(self._atlas_padded.shape[0], N, self._atlas_padded.device)
        return self.replace(_atlas_padded=self._atlas_padded[idx], _num_faces=_repeat_counts(self._num_faces, N))

    def check_shapes(self) -> bool:
        if self._atlas_padded.ndim != 5:
            raise ValueError("atlas must be (N, F, R, R, C)")
        return True

    def submeshes(self, vertex_ids_list, faces_ids_list) -> "TexturesAtlas":
        """Each submesh's faces' patches.  Host-side."""
        al = self.atlas_list()
        out = []
        for mesh_i, per_mesh_fids in enumerate(faces_ids_list):
            for fids in per_mesh_fids:
                out.append(al[mesh_i][torch.as_tensor(fids, device=al[mesh_i].device)])
        return TexturesAtlas.create(out, device=self._atlas_padded.device)

    def sample_textures(self, fragments, faces_packed=None) -> torch.Tensor:
        """The texel of each slot's patch that its barycentrics fall in
        (bary * R truncated toward zero, mirrored above the diagonal); 0
        in empty slots."""
        atlas = self.atlas_packed()  # (N*F, R, R, C)
        R, C = atlas.shape[1], atlas.shape[-1]
        pix_to_face = fragments.pix_to_face
        if R == 1:
            texels = gather_rows(atlas.reshape(-1, C), pix_to_face)
        else:
            bary = fragments.bary_coords[..., :2]
            w_xy = torch.clamp((bary * R).to(torch.int32), 0, R - 1).long()
            below_diag = (bary.sum(dim=-1) * R - w_xy.to(bary.dtype).sum(dim=-1)) <= 1.0
            w_x = torch.where(below_diag, w_xy[..., 0], R - 1 - w_xy[..., 0])
            w_y = torch.where(below_diag, w_xy[..., 1], R - 1 - w_xy[..., 1])
            ids = torch.where(pix_to_face >= 0, (pix_to_face * R + w_y) * R + w_x, -1)
            texels = gather_rows(atlas.reshape(-1, C), ids)
        return torch.where((pix_to_face >= 0)[..., None], texels, 0.0)

    def __getitem__(self, index) -> "TexturesAtlas":
        index = _batch_index(index, self._atlas_padded.device)
        return TexturesAtlas(
            _atlas_padded=self._atlas_padded[index], _num_faces=_subset_counts(self._num_faces, index)
        )

    def join_scene(self, face_order=None) -> "TexturesAtlas":
        """One per-face atlas for the batch, in the scene's compacted face
        order."""
        atlas = self.atlas_packed()
        if face_order is not None:
            atlas = atlas[face_order]
        return TexturesAtlas(_atlas_padded=atlas[None])

    @classmethod
    def join_batch(cls, textures: List["TexturesAtlas"]) -> "TexturesAtlas":
        F = max(t._atlas_padded.shape[1] for t in textures)
        return cls(_atlas_padded=torch.cat([_pad_dim1(t._atlas_padded, F) for t in textures]))


def Textures(maps=None, faces_uvs=None, verts_uvs=None, verts_rgb=None, device: Device = DEFAULT_DEVICE):
    """Deprecated factory: TexturesUV when maps, faces_uvs and verts_uvs
    are all given, TexturesVertex when verts_rgb is."""
    warnings.warn(
        "Textures is deprecated; use TexturesUV, TexturesAtlas, or TexturesVertex instead.",
        PendingDeprecationWarning,
        stacklevel=2,
    )
    if faces_uvs is not None and verts_uvs is not None and maps is not None:
        return TexturesUV.create(maps=maps, faces_uvs=faces_uvs, verts_uvs=verts_uvs, device=device)
    if verts_rgb is not None:
        return TexturesVertex.create(verts_rgb, device=device)
    raise ValueError("Textures either requires all three of (faces uvs, verts uvs, maps) or verts rgb")
