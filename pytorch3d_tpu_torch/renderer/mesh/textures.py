"""Mesh textures (port of pytorch3d_tpu/renderer/mesh/textures.py;
`TexturesVertex` so far — `TexturesUV` and `TexturesAtlas` wait for
`ops/grid_sample.py`).

`sample_textures(fragments, faces_packed=...)` returns texels (N, H, W, K, C).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ...common import DEFAULT_DEVICE
from ...ops.interp_face_attrs import interpolate_face_attributes
from ...structures.utils import list_to_padded


@dataclasses.dataclass(frozen=True)
class TexturesVertex:
    """Per-vertex color textures, barycentric-interpolated."""

    _verts_features_padded: torch.Tensor  # (N, V, C)

    @classmethod
    def create(
        cls, verts_features, device: Union[str, torch.device] = DEFAULT_DEVICE
    ) -> "TexturesVertex":
        """From a list of (V_i, C) features or an (N, V, C) tensor."""
        if isinstance(verts_features, (list, tuple)):
            verts_features = list_to_padded(
                [torch.as_tensor(f, dtype=torch.float32, device=device) for f in verts_features]
            )
        else:
            verts_features = torch.as_tensor(verts_features, dtype=torch.float32, device=device)
        if verts_features.ndim != 3:
            raise ValueError("verts_features must be (N, V, C)")
        return cls(_verts_features_padded=verts_features)

    def __getitem__(self, index) -> "TexturesVertex":
        if isinstance(index, int):
            index = [index]
        return TexturesVertex(_verts_features_padded=self._verts_features_padded[index])

    def verts_features_padded(self) -> torch.Tensor:
        return self._verts_features_padded

    def verts_features_packed(self) -> torch.Tensor:
        N, V, C = self._verts_features_padded.shape
        return self._verts_features_padded.reshape(N * V, C)

    def sample_textures(self, fragments, faces_packed: torch.Tensor) -> torch.Tensor:
        faces_feats = self.verts_features_packed()[faces_packed]  # (F, 3, C)
        return interpolate_face_attributes(
            fragments.pix_to_face, fragments.bary_coords, faces_feats
        )

