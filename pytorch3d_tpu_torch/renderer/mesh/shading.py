"""Shading math (port of pytorch3d_tpu/renderer/mesh/shading.py)."""

from __future__ import annotations

import dataclasses

import torch

from ...common.gather import gather_rows
from ...ops.interp_face_attrs import interpolate_face_attributes
from .textures import TexturesVertex


def _apply_lighting(points, normals, lights, cameras, materials):
    """Per-pixel (or per-vertex) ambient/diffuse/specular colors."""
    light_diffuse = lights.diffuse(normals=normals, points=points)
    light_specular = lights.specular(
        normals=normals,
        points=points,
        camera_position=cameras.get_camera_center(),
        shininess=materials.shininess,
    )
    ambient_color = materials.ambient_color * lights.ambient_color
    diffuse_color = materials.diffuse_color * light_diffuse
    specular_color = materials.specular_color * light_specular
    if normals.ndim == 2 and points.ndim == 2:
        return ambient_color, diffuse_color, specular_color  # per-vertex packed
    while ambient_color.ndim < points.ndim:
        ambient_color = ambient_color[:, None]  # (N, 3) -> (N, 1, 1, 1, 3)
    return ambient_color, diffuse_color, specular_color


def phong_shading(meshes, fragments, lights, cameras, materials, texels) -> torch.Tensor:
    """Per-pixel Phong: interpolate positions and normals, then light."""
    verts = meshes.verts_packed()
    faces = meshes.faces_packed()
    faces_verts = verts[faces]
    faces_normals = meshes.verts_normals_packed()[faces]
    pixel_coords = interpolate_face_attributes(fragments.pix_to_face, fragments.bary_coords, faces_verts)
    pixel_normals = interpolate_face_attributes(fragments.pix_to_face, fragments.bary_coords, faces_normals)
    ambient, diffuse, specular = _apply_lighting(pixel_coords, pixel_normals, lights, cameras, materials)
    return (ambient + diffuse) * texels + specular


def _gather_props(props, idx: torch.Tensor, n: int):
    """Per-mesh tensors of a light/camera/material dataclass, indexed per
    vertex (rows whose leading dim is the batch size n)."""
    if n == 1:
        return props
    changes = {
        f.name: getattr(props, f.name)[idx]
        for f in dataclasses.fields(props)
        if isinstance(getattr(props, f.name), torch.Tensor)
        and getattr(props, f.name).ndim > 0
        and getattr(props, f.name).shape[0] == n
    }
    return dataclasses.replace(props, **changes)


def gouraud_shading(meshes, fragments, lights, cameras, materials) -> torch.Tensor:
    """Per-vertex lighting, then barycentric color interpolation.
    Requires TexturesVertex on the meshes."""
    if not isinstance(meshes.textures, TexturesVertex):
        raise ValueError("Mesh textures must be an instance of TexturesVertex")
    faces = meshes.faces_packed()
    verts = meshes.verts_packed()
    verts_colors = meshes.textures.verts_features_packed()
    idx = meshes.verts_packed_to_mesh_idx()
    n = len(meshes)
    ambient, diffuse, specular = _apply_lighting(
        verts, meshes.verts_normals_packed(), _gather_props(lights, idx, n),
        _gather_props(cameras, idx, n), _gather_props(materials, idx, n),
    )
    verts_colors_shaded = verts_colors * (ambient + diffuse) + specular
    return interpolate_face_attributes(
        fragments.pix_to_face, fragments.bary_coords, verts_colors_shaded[faces]
    )


def flat_shading(meshes, fragments, lights, cameras, materials, texels) -> torch.Tensor:
    """One normal and one position (the centroid) per face, then light."""
    face_normals = meshes.faces_normals_packed()
    face_coords = meshes.verts_packed()[meshes.faces_packed()].mean(dim=-2)  # (F, 3)
    mask = (fragments.pix_to_face >= 0)[..., None]
    pixel_coords = torch.where(mask, gather_rows(face_coords, fragments.pix_to_face), 0.0)
    pixel_normals = torch.where(mask, gather_rows(face_normals, fragments.pix_to_face), 0.0)
    ambient, diffuse, specular = _apply_lighting(pixel_coords, pixel_normals, lights, cameras, materials)
    return (ambient + diffuse) * texels + specular
