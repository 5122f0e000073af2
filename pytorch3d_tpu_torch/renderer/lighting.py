"""Lights (port of pytorch3d_tpu/renderer/lighting.py): directional,
point and ambient lights.

Default colors: ambient 0.5, diffuse 0.3, specular 0.2 (ambient-only
lights: 1).  Lights are frozen dataclasses holding (N, 3) tensors; `create`
builds one on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..common import DEFAULT_DEVICE

Device = Union[str, torch.device]


def _normalize(v: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=eps * eps))


def _expand_to(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Insert singleton spatial dims: (N, C) -> (N, 1, ..., 1, C).
    1-D inputs (C,) first gain a leading batch dim."""
    if x.ndim == 1:
        x = x[None]
    while x.ndim < target_ndim:
        x = x[:, None]
    return x


def diffuse(normals: torch.Tensor, color: torch.Tensor, direction: torch.Tensor):
    """Lambertian diffuse term."""
    if direction.shape != normals.shape:
        direction = _expand_to(direction, normals.ndim)
    if color.shape != normals.shape:
        color = _expand_to(color, normals.ndim)
    angle = torch.clamp(torch.sum(_normalize(normals) * _normalize(direction), dim=-1), min=0.0)
    return color * angle[..., None]


def specular(points, normals, direction, color, camera_position, shininess) -> torch.Tensor:
    """Phong specular term."""
    if points.shape != normals.shape:
        raise ValueError("Expected points and normals to have the same shape.")
    if direction.shape != normals.shape:
        direction = _expand_to(direction, normals.ndim)
    if color.shape != normals.shape:
        color = _expand_to(color, normals.ndim)
    if camera_position.shape != normals.shape:
        camera_position = _expand_to(camera_position, normals.ndim)
    shininess = torch.as_tensor(shininess, dtype=points.dtype, device=points.device)
    if shininess.ndim > 0 and shininess.shape != normals.shape[:-1]:
        shininess = _expand_to(shininess[..., None], normals.ndim)[..., 0]

    normals = _normalize(normals)
    direction = _normalize(direction)
    cos_angle = torch.sum(normals * direction, dim=-1)
    mask = (cos_angle > 0).to(points.dtype)
    view_direction = _normalize(camera_position - points)
    reflect_direction = -direction + 2.0 * cos_angle[..., None] * normals
    alpha = torch.clamp(torch.sum(view_direction * reflect_direction, dim=-1), min=0.0) * mask
    return color * torch.pow(alpha, shininess)[..., None]


def _color_batch(c, device: Device) -> torch.Tensor:
    c = torch.as_tensor(c, dtype=torch.float32, device=device)
    return c[None] if c.ndim == 1 else c


class _Light:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def clone(self):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class DirectionalLights(_Light):
    """Light at infinity with a fixed direction."""

    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor
    direction: torch.Tensor

    @classmethod
    def create(
        cls,
        ambient_color=((0.5, 0.5, 0.5),),
        diffuse_color=((0.3, 0.3, 0.3),),
        specular_color=((0.2, 0.2, 0.2),),
        direction=((0, 1, 0),),
        device: Device = DEFAULT_DEVICE,
    ) -> "DirectionalLights":
        return cls(
            ambient_color=_color_batch(ambient_color, device),
            diffuse_color=_color_batch(diffuse_color, device),
            specular_color=_color_batch(specular_color, device),
            direction=_color_batch(direction, device),
        )

    def diffuse(self, normals, points=None) -> torch.Tensor:
        return diffuse(normals=normals, color=self.diffuse_color, direction=self.direction)

    def specular(self, normals, points, camera_position, shininess) -> torch.Tensor:
        return specular(
            points=points, normals=normals, color=self.specular_color,
            direction=self.direction, camera_position=camera_position, shininess=shininess,
        )


@dataclasses.dataclass(frozen=True)
class PointLights(_Light):
    """Point light with a 3D location."""

    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor
    location: torch.Tensor

    @classmethod
    def create(
        cls,
        ambient_color=((0.5, 0.5, 0.5),),
        diffuse_color=((0.3, 0.3, 0.3),),
        specular_color=((0.2, 0.2, 0.2),),
        location=((0, 1, 0),),
        device: Device = DEFAULT_DEVICE,
    ) -> "PointLights":
        return cls(
            ambient_color=_color_batch(ambient_color, device),
            diffuse_color=_color_batch(diffuse_color, device),
            specular_color=_color_batch(specular_color, device),
            location=_color_batch(location, device),
        )

    def reshape_location(self, points) -> torch.Tensor:
        if self.location.ndim == points.ndim:
            return self.location
        return _expand_to(self.location, points.ndim)

    def diffuse(self, normals, points) -> torch.Tensor:
        direction = self.reshape_location(points) - points
        return diffuse(normals=normals, color=self.diffuse_color, direction=direction)

    def specular(self, normals, points, camera_position, shininess) -> torch.Tensor:
        direction = self.reshape_location(points) - points
        return specular(
            points=points, normals=normals, color=self.specular_color,
            direction=direction, camera_position=camera_position, shininess=shininess,
        )


@dataclasses.dataclass(frozen=True)
class AmbientLights(_Light):
    """Uniform ambient-only lighting."""

    ambient_color: torch.Tensor

    @classmethod
    def create(cls, ambient_color=((1.0, 1.0, 1.0),), device: Device = DEFAULT_DEVICE) -> "AmbientLights":
        return cls(ambient_color=_color_batch(ambient_color, device))

    def diffuse(self, normals, points) -> torch.Tensor:
        return torch.zeros_like(points)

    def specular(self, normals, points, camera_position, shininess) -> torch.Tensor:
        return torch.zeros_like(points)
