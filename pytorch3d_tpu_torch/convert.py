"""Build the port's objects from numpy arrays taken from the JAX package's.

The JAX objects are flax dataclasses of arrays; a caller converts their
fields with `np.asarray` and hands them here, so both packages render the
same scene from the same state.  Nothing here imports JAX.  The mesh and
point rendering paths have no learned weights: their state is geometry,
vertex colors or point features, cameras, lights and materials.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .common import DEFAULT_DEVICE
from .renderer.cameras import FoVOrthographicCameras, FoVPerspectiveCameras
from .renderer.lighting import PointLights
from .renderer.materials import Materials
from .renderer.mesh.textures import TexturesVertex
from .structures import Meshes, Pointclouds

Device = Union[str, torch.device]
Arrays = Union[np.ndarray, Sequence[np.ndarray]]


def _own(a):
    """A writable copy: `np.asarray` of a JAX array is a read-only view,
    which torch refuses to share."""
    if isinstance(a, (list, tuple)):
        return [np.array(x) for x in a]
    return None if a is None else np.array(a)


def meshes_from_numpy(
    verts: Arrays,
    faces: Arrays,
    num_verts_per_mesh: Optional[np.ndarray] = None,
    num_faces_per_mesh: Optional[np.ndarray] = None,
    verts_features: Optional[Arrays] = None,
    device: Device = DEFAULT_DEVICE,
) -> Meshes:
    """Meshes from per-mesh lists, or padded arrays (-1 padded faces) plus
    counts, with optional per-vertex colors (TexturesVertex)."""
    textures = None
    if verts_features is not None:
        textures = textures_vertex_from_numpy(verts_features, device=device)
    return Meshes.create(
        verts=_own(verts), faces=_own(faces), textures=textures,
        num_verts_per_mesh=_own(num_verts_per_mesh), num_faces_per_mesh=_own(num_faces_per_mesh),
        device=device,
    )


def textures_vertex_from_numpy(verts_features: Arrays, device: Device = DEFAULT_DEVICE) -> TexturesVertex:
    """TexturesVertex from a list of (V_i, C) or a padded (N, V, C) array."""
    return TexturesVertex.create(_own(verts_features), device=device)


def fov_perspective_cameras_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    znear: np.ndarray,
    zfar: np.ndarray,
    aspect_ratio: np.ndarray,
    fov: np.ndarray,
    degrees: bool = True,
    device: Device = DEFAULT_DEVICE,
) -> FoVPerspectiveCameras:
    """FoVPerspectiveCameras from the JAX camera's R, T, znear, zfar,
    aspect_ratio and fov (degrees unless `degrees` is False)."""
    return FoVPerspectiveCameras.create(
        znear=_own(znear), zfar=_own(zfar), aspect_ratio=_own(aspect_ratio), fov=_own(fov),
        degrees=degrees, R=_own(R), T=_own(T), device=device,
    )


def pointclouds_from_numpy(
    points: Arrays,
    features: Optional[Arrays] = None,
    normals: Optional[Arrays] = None,
    num_points_per_cloud: Optional[np.ndarray] = None,
    device: Device = DEFAULT_DEVICE,
) -> Pointclouds:
    """Pointclouds from per-cloud lists, or padded arrays plus counts, with
    optional features and normals in the same form as the points."""
    return Pointclouds.create(
        _own(points), normals=_own(normals), features=_own(features),
        num_points_per_cloud=_own(num_points_per_cloud), device=device,
    )


def fov_orthographic_cameras_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    znear: np.ndarray,
    zfar: np.ndarray,
    max_y: np.ndarray,
    min_y: np.ndarray,
    max_x: np.ndarray,
    min_x: np.ndarray,
    scale_xyz: np.ndarray,
    device: Device = DEFAULT_DEVICE,
) -> FoVOrthographicCameras:
    """FoVOrthographicCameras from the JAX camera's R, T, znear, zfar, the
    view box bounds and scale_xyz."""
    return FoVOrthographicCameras.create(
        znear=_own(znear), zfar=_own(zfar), max_y=_own(max_y), min_y=_own(min_y),
        max_x=_own(max_x), min_x=_own(min_x), scale_xyz=_own(scale_xyz),
        R=_own(R), T=_own(T), device=device,
    )


def point_lights_from_numpy(
    ambient_color: np.ndarray,
    diffuse_color: np.ndarray,
    specular_color: np.ndarray,
    location: np.ndarray,
    device: Device = DEFAULT_DEVICE,
) -> PointLights:
    return PointLights.create(
        ambient_color=_own(ambient_color), diffuse_color=_own(diffuse_color),
        specular_color=_own(specular_color), location=_own(location), device=device,
    )


def materials_from_numpy(
    ambient_color: np.ndarray,
    diffuse_color: np.ndarray,
    specular_color: np.ndarray,
    shininess: np.ndarray,
    device: Device = DEFAULT_DEVICE,
) -> Materials:
    return Materials.create(
        ambient_color=_own(ambient_color), diffuse_color=_own(diffuse_color),
        specular_color=_own(specular_color), shininess=_own(shininess), device=device,
    )
