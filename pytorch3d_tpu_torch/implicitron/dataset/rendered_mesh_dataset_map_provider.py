"""A synthetic dataset rendered in the process (port of
pytorch3d_tpu/implicitron/dataset/rendered_mesh_dataset_map_provider.py):
the mesh of `data_file` (an .obj loaded by `load_objs_as_meshes`, with its
textures) or else `ico_sphere(3)` coloured by its vertex positions, rendered
through `MeshRenderer(MeshRasterizer(K=1), HardPhongShader)` from a ring of
viewpoints.  On the card the render runs the fine rasterizer kernel."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from ...common import DEFAULT_DEVICE
from ...renderer import (
    FoVPerspectiveCameras,
    HardPhongShader,
    MeshRasterizer,
    MeshRenderer,
    PointLights,
    RasterizationSettings,
    look_at_view_transform,
)
from ...renderer.mesh.textures import TexturesVertex
from ...utils.ico_sphere import ico_sphere
from ..tools.config import Configurable
from .frame_data import FrameData


@dataclasses.dataclass
class RenderedMeshDatasetMapProvider(Configurable):
    num_views: int = 40
    data_file: Optional[str] = None  # path to an .obj; None: the ico sphere
    azimuth_range: float = 180.0
    distance: float = 2.7
    resolution: int = 128
    use_point_light: bool = True
    device: Union[str, torch.device] = DEFAULT_DEVICE

    def __post_init__(self):
        self._dataset = None

    def _build(self) -> List[FrameData]:
        device = torch.device(self.device)
        if self.data_file is not None:
            from ...io import load_objs_as_meshes

            mesh = load_objs_as_meshes([self.data_file], device=device)
        else:
            mesh = ico_sphere(3, device=device)
            mesh = mesh.replace(textures=TexturesVertex.create(mesh.verts_padded() * 0.5 + 0.5, device=device))
        azims = torch.tensor(np.linspace(-self.azimuth_range, self.azimuth_range, self.num_views).astype(np.float32),
                             device=device)
        R, T = look_at_view_transform(dist=self.distance, elev=20.0, azim=azims, device=device)
        cameras = FoVPerspectiveCameras.create(R=R, T=T, device=device)
        lights = PointLights.create(location=[[0.0, 0.0, -3.0]], device=device) if self.use_point_light else None
        renderer = MeshRenderer(
            MeshRasterizer(cameras, RasterizationSettings(image_size=self.resolution, faces_per_pixel=1)),
            HardPhongShader(cameras=cameras, lights=lights, device=device),
        )
        images = renderer(mesh.extend(self.num_views), cameras=cameras)  # (V, H, W, 4)
        return [
            FrameData(
                frame_number=i,
                sequence_name="sphere_seq",
                sequence_category="sphere",
                image_rgb=images[i : i + 1, ..., :3],
                fg_probability=(images[i : i + 1, ..., 3:4] > 0.5).float(),
                camera=FoVPerspectiveCameras.create(R=R[i : i + 1], T=T[i : i + 1], device=device),
                frame_type="known",
            )
            for i in range(self.num_views)
        ]

    def get_dataset_map(self):
        """{'train': [...], 'val': [...], 'test': [...]} FrameData lists: the
        last tenth of the views (at least one) is both val and test."""
        if self._dataset is None:
            self._dataset = self._build()
        n = len(self._dataset)
        n_test = max(n // 10, 1)
        return {
            "train": self._dataset[: n - n_test],
            "val": self._dataset[n - n_test :],
            "test": self._dataset[n - n_test :],
        }
