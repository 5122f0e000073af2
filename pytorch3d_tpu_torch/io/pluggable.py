"""Pluggable IO (port of pytorch3d_tpu/io/pluggable.py): format
interpreters registered with `IO`, whose `load_mesh` / `save_mesh` /
`load_pointcloud` / `save_pointcloud` ask each interpreter in turn (the
latest registered first) until one takes the path's suffix.  Loaders make
their tensors on `device` (None: the card)."""

from __future__ import annotations

from typing import List, Optional

from ..structures.meshes import Meshes
from ..structures.pointclouds import Pointclouds
from .utils import _device


class MeshFormatInterpreter:
    """Interface for mesh formats: `read` gives Meshes or None (not this
    format), `save` True where it wrote the file."""

    def read(self, path, include_textures: bool, device=None, **kwargs) -> Optional[Meshes]:
        raise NotImplementedError

    def save(self, data: Meshes, path, **kwargs) -> bool:
        raise NotImplementedError


class PointcloudFormatInterpreter:
    """Interface for point cloud formats."""

    def read(self, path, device=None, **kwargs) -> Optional[Pointclouds]:
        raise NotImplementedError

    def save(self, data: Pointclouds, path, **kwargs) -> bool:
        raise NotImplementedError


def endswith(path, suffixes) -> bool:
    return str(path).lower().endswith(suffixes)


def _first_mesh(data: Meshes):
    """The first mesh's unpadded verts and faces."""
    nv = int(data.num_verts_per_mesh()[0])
    nf = int(data.num_faces_per_mesh()[0])
    return data.verts_padded()[0][:nv], data.faces_padded()[0][:nf]


class MeshObjFormat(MeshFormatInterpreter):
    known_suffixes = (".obj",)

    def read(self, path, include_textures=True, device=None, **kwargs):
        if not endswith(path, self.known_suffixes):
            return None
        from .obj_io import load_objs_as_meshes

        return load_objs_as_meshes([path], device=device, load_textures=include_textures)

    def save(self, data: Meshes, path, **kwargs) -> bool:
        if not endswith(path, self.known_suffixes):
            return False
        from .obj_io import save_obj

        save_obj(path, *_first_mesh(data))
        return True


class MeshPlyFormat(MeshFormatInterpreter):
    known_suffixes = (".ply",)

    def read(self, path, include_textures=True, device=None, **kwargs):
        if not endswith(path, self.known_suffixes):
            return None
        from .ply_io import load_ply

        verts, faces = load_ply(path, device=device)
        return Meshes.create([verts], [faces], device=_device(device))

    def save(self, data: Meshes, path, binary: bool = True, **kwargs) -> bool:
        if not endswith(path, self.known_suffixes):
            return False
        from .ply_io import save_ply

        verts, faces = _first_mesh(data)
        save_ply(path, verts, faces, ascii=not binary)
        return True


class MeshOffFormat(MeshFormatInterpreter):
    known_suffixes = (".off",)

    def read(self, path, include_textures=True, device=None, **kwargs):
        if not endswith(path, self.known_suffixes):
            return None
        from .off_io import load_off_full

        device = _device(device)
        data = load_off_full(path, device=device)
        textures = None
        if include_textures and "verts_colors" in data:
            from ..renderer.mesh.textures import TexturesVertex

            textures = TexturesVertex.create(data["verts_colors"][None, :, :3], device=device)
        elif include_textures and "faces_colors" in data:
            from ..renderer.mesh.textures import TexturesAtlas

            textures = TexturesAtlas.create(data["faces_colors"][None, :, None, None, :3], device=device)
        return Meshes.create([data["verts"]], [data["faces"]], textures=textures, device=device)

    def save(self, data: Meshes, path, **kwargs) -> bool:
        if not endswith(path, self.known_suffixes):
            return False
        from .off_io import save_off

        verts, faces = _first_mesh(data)
        vcol = None
        tex = getattr(data, "textures", None)
        if tex is not None and hasattr(tex, "verts_features_padded"):
            vcol = tex.verts_features_padded()[0][: verts.shape[0]]
        save_off(path, verts, faces, verts_colors=vcol)
        return True


class PointcloudPlyFormat(PointcloudFormatInterpreter):
    known_suffixes = (".ply",)

    def read(self, path, device=None, **kwargs):
        if not endswith(path, self.known_suffixes):
            return None
        from .ply_io import load_ply_pointcloud

        points, normals, colors = load_ply_pointcloud(path, device=device)
        return Pointclouds.create(
            points[None],
            normals=None if normals is None else normals[None],
            features=None if colors is None else colors[None],
            device=_device(device),
        )

    def save(self, data: Pointclouds, path, binary: bool = True, **kwargs) -> bool:
        if not endswith(path, self.known_suffixes):
            return False
        from .ply_io import save_ply

        n = int(data.num_points_per_cloud()[0])
        normals = data.normals_padded()
        feats = data.features_padded()
        save_ply(
            path,
            data.points_padded()[0][:n],
            verts_normals=None if normals is None else normals[0][:n],
            colors=None if feats is None else feats[0][:n],
            ascii=not binary,
        )
        return True


class IO:
    """The pluggable IO front door: OBJ, PLY, OFF and GLB meshes and PLY
    point clouds by default."""

    def __init__(self, include_default_formats: bool = True, path_manager=None):
        self.mesh_interpreters: List[MeshFormatInterpreter] = []
        self.pointcloud_interpreters: List[PointcloudFormatInterpreter] = []
        if include_default_formats:
            self.register_default_formats()

    def register_default_formats(self) -> None:
        from .experimental_gltf_io import MeshGlbFormat

        self.register_meshes_format(MeshObjFormat())
        self.register_meshes_format(MeshPlyFormat())
        self.register_meshes_format(MeshOffFormat())
        self.register_pointcloud_format(PointcloudPlyFormat())
        self.register_meshes_format(MeshGlbFormat())

    def register_meshes_format(self, interpreter: MeshFormatInterpreter) -> None:
        self.mesh_interpreters.insert(0, interpreter)

    def register_pointcloud_format(self, interpreter: PointcloudFormatInterpreter) -> None:
        self.pointcloud_interpreters.insert(0, interpreter)

    def load_mesh(self, path, include_textures: bool = True, device=None, **kwargs) -> Meshes:
        for interpreter in self.mesh_interpreters:
            mesh = interpreter.read(path, include_textures=include_textures, device=device, **kwargs)
            if mesh is not None:
                return mesh
        raise ValueError(f"No mesh interpreter found to read {path}.")

    def save_mesh(self, data: Meshes, path, binary: bool = True, **kwargs) -> None:
        for interpreter in self.mesh_interpreters:
            if interpreter.save(data, path, binary=binary, **kwargs):
                return
        raise ValueError(f"No mesh interpreter found to write to {path}.")

    def load_pointcloud(self, path, device=None, **kwargs) -> Pointclouds:
        for interpreter in self.pointcloud_interpreters:
            pcl = interpreter.read(path, device=device, **kwargs)
            if pcl is not None:
                return pcl
        raise ValueError(f"No pointcloud interpreter found to read {path}.")

    def save_pointcloud(self, data: Pointclouds, path, binary: bool = True, **kwargs) -> None:
        for interpreter in self.pointcloud_interpreters:
            if interpreter.save(data, path, binary=binary, **kwargs):
                return
        raise ValueError(f"No pointcloud interpreter found to write to {path}.")
