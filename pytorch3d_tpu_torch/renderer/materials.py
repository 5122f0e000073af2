"""Materials (port of pytorch3d_tpu/renderer/materials.py)."""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..common import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class Materials:
    """Batched Phong material properties."""

    ambient_color: torch.Tensor  # (N, 3)
    diffuse_color: torch.Tensor  # (N, 3)
    specular_color: torch.Tensor  # (N, 3)
    shininess: torch.Tensor  # (N,)

    @classmethod
    def create(
        cls,
        ambient_color=((1, 1, 1),),
        diffuse_color=((1, 1, 1),),
        specular_color=((1, 1, 1),),
        shininess=64,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> "Materials":
        def batch(c):
            c = torch.as_tensor(c, dtype=torch.float32, device=device)
            return c[None] if c.ndim == 1 else c

        shininess = torch.as_tensor(shininess, dtype=torch.float32, device=device)
        return cls(
            ambient_color=batch(ambient_color),
            diffuse_color=batch(diffuse_color),
            specular_color=batch(specular_color),
            shininess=shininess[None] if shininess.ndim == 0 else shininess,
        )

    def __len__(self) -> int:
        return self.ambient_color.shape[0]

    def replace(self, **changes) -> "Materials":
        return dataclasses.replace(self, **changes)
