"""Batched dense voxel grids (port of pytorch3d_tpu/structures/volumes.py).

`Volumes` holds densities (N, C_d, D, H, W) and optional features
(N, C_f, D, H, W) with a `VolumeLocator` that maps local coordinates
([-1, 1]^3, xyz order with x along W, y along H, z along D, the corners at
the outer voxels' centres) to world coordinates:

    x_world = x_local * (grid_size_xyz - 1) * 0.5 * voxel_size - translation

Every volume of a batch has the same (D, H, W), as in the JAX package.
`create` puts its inputs on `device`, which is the card unless the caller
names another, in float32 unless it names another `dtype` (a float64 run
checks a float32 one); the locator's transforms take the voxel sizes' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from ..common import DEFAULT_DEVICE
from ..transforms import Scale, Transform3d, Translate

Device = Union[str, torch.device]


def _per_volume(value, batch_size: int, device: Device, dtype: torch.dtype) -> torch.Tensor:
    """(N, 3) from a scalar, an (N,) or (3,) tensor, or (N, 3)."""
    t = torch.as_tensor(value, dtype=dtype, device=device)
    if t.ndim == 0:
        return t.expand(batch_size, 3)
    if t.ndim == 1 and t.shape[0] == 3:
        return t.expand(batch_size, 3)
    if t.ndim == 1:
        return t[:, None].expand(batch_size, 3)
    return t


@dataclasses.dataclass(frozen=True)
class VolumeLocator:
    """Where the voxel centres of a batch of grids lie in local and world
    coordinates: per-volume voxel sizes and translations (N, 3), and the
    grids' shared (D, H, W)."""

    voxel_size: torch.Tensor  # (N, 3) xyz
    volume_translation: torch.Tensor  # (N, 3) xyz translation of the grid's centre
    grid_size: Tuple[int, int, int] = (1, 1, 1)  # (D, H, W)

    @classmethod
    def create(
        cls,
        batch_size: int,
        grid_size: Tuple[int, int, int],
        voxel_size: Union[float, torch.Tensor] = 1.0,
        volume_translation: Union[Tuple[float, float, float], torch.Tensor] = (0, 0, 0),
        device: Device = DEFAULT_DEVICE,
        dtype: torch.dtype = torch.float32,
    ) -> "VolumeLocator":
        vs = _per_volume(voxel_size, batch_size, device, dtype)
        vt = torch.as_tensor(volume_translation, dtype=dtype, device=device)
        if vt.ndim == 1:
            vt = vt.expand(batch_size, 3)
        return cls(voxel_size=vs, volume_translation=vt, grid_size=tuple(int(s) for s in grid_size))

    @property
    def device(self) -> torch.device:
        return self.voxel_size.device

    def _grid_size_xyz(self) -> torch.Tensor:
        D, H, W = self.grid_size
        return torch.tensor([W, H, D], dtype=self.voxel_size.dtype, device=self.device)

    def get_local_to_world_coords_transform(self) -> Transform3d:
        grid_xyz = self._grid_size_xyz()
        scale = (grid_xyz - 1.0) * 0.5 * self.voxel_size
        # a dimension of one voxel would scale by 0: take half a voxel
        scale = torch.where(grid_xyz[None, :] > 1, scale, self.voxel_size * 0.5)
        kw = dict(dtype=self.voxel_size.dtype, device=self.device)
        return Scale(scale, **kw).compose(Translate(-self.volume_translation, **kw))

    def get_world_to_local_coords_transform(self) -> Transform3d:
        return self.get_local_to_world_coords_transform().inverse()

    def world_to_local_coords(self, points_3d_world: torch.Tensor) -> torch.Tensor:
        return self.get_world_to_local_coords_transform().transform_points(points_3d_world)

    def local_to_world_coords(self, points_3d_local: torch.Tensor) -> torch.Tensor:
        return self.get_local_to_world_coords_transform().transform_points(points_3d_local)

    def get_coord_grid(self, world_coordinates: bool = True) -> torch.Tensor:
        """(N, D, H, W, 3) voxel-centre coordinates in xyz order."""
        N = self.voxel_size.shape[0]
        D, H, W = self.grid_size

        kw = dict(dtype=self.voxel_size.dtype, device=self.device)

        def axis(n):
            return torch.linspace(-1.0, 1.0, n, **kw) if n > 1 else torch.zeros(1, **kw)

        Z, Y, X = torch.meshgrid(axis(D), axis(H), axis(W), indexing="ij")
        grid = torch.stack([X, Y, Z], dim=-1).expand(N, D, H, W, 3)
        if not world_coordinates:
            return grid
        world = self.local_to_world_coords(grid.reshape(N, D * H * W, 3))
        return world.reshape(N, D, H, W, 3)

    def index(self, index) -> "VolumeLocator":
        return VolumeLocator(self.voxel_size[index], self.volume_translation[index], self.grid_size)

    def _map_tensors(self, fn) -> "VolumeLocator":
        return VolumeLocator(fn(self.voxel_size), fn(self.volume_translation), self.grid_size)


@dataclasses.dataclass(frozen=True)
class Volumes:
    """A batch of dense voxel grids: densities, optional features and their
    locator."""

    _densities: torch.Tensor  # (N, C_d, D, H, W)
    locator: VolumeLocator
    _features: Optional[torch.Tensor] = None  # (N, C_f, D, H, W)

    @classmethod
    def create(
        cls,
        densities: torch.Tensor,
        features: Optional[torch.Tensor] = None,
        voxel_size: Union[float, torch.Tensor] = 1.0,
        volume_translation=(0.0, 0.0, 0.0),
        device: Optional[Device] = None,
        dtype: torch.dtype = torch.float32,
    ) -> "Volumes":
        """`device` defaults to the densities' own when they are a tensor,
        else to the card."""
        if device is None:
            device = densities.device if isinstance(densities, torch.Tensor) else DEFAULT_DEVICE
        densities = torch.as_tensor(densities, dtype=dtype, device=device)
        if densities.ndim != 5:
            raise ValueError("densities must be (N, C, D, H, W)")
        if features is not None:
            features = torch.as_tensor(features, dtype=dtype, device=device)
            if features.shape[0] != densities.shape[0] or features.shape[2:] != densities.shape[2:]:
                raise ValueError("features spatial dims must match densities")
        locator = VolumeLocator.create(
            densities.shape[0], tuple(densities.shape[2:]), voxel_size=voxel_size,
            volume_translation=volume_translation, device=device, dtype=dtype,
        )
        return cls(_densities=densities, locator=locator, _features=features)

    def replace(self, **changes) -> "Volumes":
        return dataclasses.replace(self, **changes)

    def __len__(self) -> int:
        return self._densities.shape[0]

    @property
    def device(self) -> torch.device:
        return self._densities.device

    def densities(self) -> torch.Tensor:
        return self._densities

    def features(self) -> Optional[torch.Tensor]:
        return self._features

    def get_grid_sizes(self) -> torch.Tensor:
        """(N, 3) int32: every volume's (D, H, W)."""
        return torch.tensor(self.locator.grid_size, dtype=torch.int32, device=self.device).expand(len(self), 3)

    def get_align_corners(self) -> bool:
        return True

    def update_padded(self, new_densities: torch.Tensor, new_features: Optional[torch.Tensor] = None) -> "Volumes":
        """The same grids and locator with new densities (and features,
        where given)."""
        return self.replace(_densities=new_densities,
                            _features=new_features if new_features is not None else self._features)

    def __getitem__(self, index) -> "Volumes":
        """The volumes at `index` (an int, a list, a slice or an index
        tensor); an int keeps the batch dimension."""
        if isinstance(index, int):
            index = [index]
        if isinstance(index, (list, tuple)):
            index = torch.as_tensor(index, dtype=torch.int64, device=self.device)
        return Volumes(
            _densities=self._densities[index],
            locator=self.locator.index(index),
            _features=self._features[index] if self._features is not None else None,
        )

    def get_local_to_world_coords_transform(self) -> Transform3d:
        return self.locator.get_local_to_world_coords_transform()

    def get_world_to_local_coords_transform(self) -> Transform3d:
        return self.locator.get_world_to_local_coords_transform()

    def world_to_local_coords(self, points_3d_world: torch.Tensor) -> torch.Tensor:
        return self.locator.world_to_local_coords(points_3d_world)

    def local_to_world_coords(self, points_3d_local: torch.Tensor) -> torch.Tensor:
        return self.locator.local_to_world_coords(points_3d_local)

    def get_coord_grid(self, world_coordinates: bool = True) -> torch.Tensor:
        return self.locator.get_coord_grid(world_coordinates=world_coordinates)

    def _map_tensors(self, fn) -> "Volumes":
        return Volumes(
            _densities=fn(self._densities),
            locator=self.locator._map_tensors(fn),
            _features=None if self._features is None else fn(self._features),
        )

    def to(self, device: Optional[Device] = None, dtype: Optional[torch.dtype] = None) -> "Volumes":
        return self._map_tensors(lambda t: t.to(device=device, dtype=dtype))

    def clone(self) -> "Volumes":
        return self._map_tensors(torch.clone)

    def detach(self) -> "Volumes":
        return self._map_tensors(torch.Tensor.detach)

    def cpu(self) -> "Volumes":
        return self.to("cpu")

    def cuda(self) -> "Volumes":
        return self.to("cuda")

    def densities_list(self) -> List[torch.Tensor]:
        """Per-volume density tensors (views: the grids share one size)."""
        return list(self._densities.unbind(0))

    def features_list(self) -> Optional[List[torch.Tensor]]:
        """Per-volume feature tensors, or None."""
        return None if self._features is None else list(self._features.unbind(0))
