"""glTF 2.0 / GLB mesh IO, experimental (port of
pytorch3d_tpu/io/experimental_gltf_io.py): triangle primitives with
POSITION, indices and TEXCOORD_0, the node transforms of the default scene,
and a base-colour texture embedded in the binary chunk (read through PIL)
into `TexturesUV`.  The writer writes geometry only.
"""

from __future__ import annotations

import json
import struct
from collections import deque
from io import BytesIO
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..structures.meshes import Meshes, join_meshes_as_batch
from .pluggable import MeshFormatInterpreter, endswith
from .utils import _device, _to_numpy

_GLB_MAGIC = 0x46546C67  # "glTF"
_JSON_CHUNK = 0x4E4F534A
_BIN_CHUNK = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZES = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


class _GLTFLoader:
    """Parse a GLB container (or a plain .gltf JSON) into Meshes on
    `device` (None: the card)."""

    def __init__(self, stream, device=None) -> None:
        self._json, self._binary = self._read_chunks(stream)
        self.device = _device(device)

    @staticmethod
    def _read_chunks(stream) -> Tuple[Dict[str, Any], bytes]:
        header = stream.read(12)
        magic, version, length = struct.unpack("<III", header)
        if magic != _GLB_MAGIC:
            # maybe a plain .gltf JSON file
            stream.seek(0)
            return json.loads(stream.read().decode("utf-8")), b""
        json_data = None
        binary = b""
        while True:
            head = stream.read(8)
            if len(head) < 8:
                break
            chunk_len, chunk_type = struct.unpack("<II", head)
            data = stream.read(chunk_len)
            if chunk_type == _JSON_CHUNK:
                json_data = json.loads(data.decode("utf-8"))
            elif chunk_type == _BIN_CHUNK:
                binary = data
        if json_data is None:
            raise ValueError("GLB file has no JSON chunk")
        return json_data, binary

    def _access(self, accessor_idx: int) -> np.ndarray:
        acc = self._json["accessors"][accessor_idx]
        view = self._json["bufferViews"][acc["bufferView"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        n_comp = _TYPE_SIZES[acc["type"]]
        count = acc["count"]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride", 0)
        itemsize = np.dtype(dtype).itemsize * n_comp
        if stride and stride != itemsize:
            rows = []
            for i in range(count):
                start = offset + i * stride
                rows.append(
                    np.frombuffer(
                        self._binary[start : start + itemsize], dtype=dtype
                    )
                )
            arr = np.stack(rows)
        else:
            arr = np.frombuffer(
                self._binary[offset : offset + count * itemsize], dtype=dtype
            ).reshape(count, n_comp)
        return arr

    def load_named(self, include_textures: bool = True):
        """List of (name, Meshes) pairs, one per primitive."""
        named = []
        out = self.load(include_textures=include_textures, _named=named)
        del out
        return named

    def load(self, include_textures: bool = True, _named=None) -> Optional[Meshes]:
        meshes = []
        scene = self._json.get("scene", 0)
        scenes = self._json.get("scenes", [{"nodes": []}])
        nodes = self._json.get("nodes", [])
        stack = deque(
            (n, np.eye(4, dtype=np.float32))
            for n in scenes[scene].get("nodes", [])
        )
        while stack:
            node_idx, parent_tf = stack.pop()
            node = nodes[node_idx]
            tf = parent_tf @ self._node_transform(node)
            for child in node.get("children", []):
                stack.append((child, tf))
            if "mesh" not in node:
                continue
            mesh_def = self._json["meshes"][node["mesh"]]
            for prim in mesh_def.get("primitives", []):
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                verts = self._access(prim["attributes"]["POSITION"]).astype(
                    np.float32
                )
                verts_h = np.concatenate(
                    [verts, np.ones((verts.shape[0], 1), np.float32)], axis=1
                )
                verts = (verts_h @ tf.T)[:, :3]
                if "indices" in prim:
                    faces = self._access(prim["indices"]).reshape(-1, 3)
                else:
                    faces = np.arange(verts.shape[0]).reshape(-1, 3)
                tex = None
                if include_textures and "TEXCOORD_0" in prim.get("attributes", {}):
                    tex = self._load_texture(prim, faces)
                mesh = Meshes.create([verts], [faces.astype(np.int32)], textures=tex, device=self.device)
                meshes.append(mesh)
                if _named is not None:
                    _named.append(
                        (node.get("name", mesh_def.get("name")), mesh)
                    )
        if not meshes:
            return None
        return meshes[0] if len(meshes) == 1 else join_meshes_as_batch(meshes)

    def _load_texture(self, prim, faces):
        from PIL import Image

        from ..renderer.mesh.textures import TexturesUV

        uvs = self._access(prim["attributes"]["TEXCOORD_0"]).astype(np.float32)
        mat_idx = prim.get("material")
        if mat_idx is None:
            return None
        mat = self._json["materials"][mat_idx]
        tex_info = mat.get("pbrMetallicRoughness", {}).get("baseColorTexture")
        if tex_info is None:
            return None
        texture = self._json["textures"][tex_info["index"]]
        image_def = self._json["images"][texture["source"]]
        if "bufferView" not in image_def:
            return None
        view = self._json["bufferViews"][image_def["bufferView"]]
        start = view.get("byteOffset", 0)
        data = self._binary[start : start + view["byteLength"]]
        img = np.asarray(
            Image.open(BytesIO(data)).convert("RGB"), np.float32
        ) / 255.0
        # glTF uv origin is top-left; ours is bottom-left
        uvs = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], axis=1)
        return TexturesUV.create(
            maps=img[None], faces_uvs=faces.astype(np.int32)[None], verts_uvs=uvs[None], device=self.device
        )

    @staticmethod
    def _node_transform(node) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        tf = np.eye(4, dtype=np.float32)
        if "scale" in node:
            tf = tf @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            R = np.asarray(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ],
                np.float32,
            )
            T4 = np.eye(4, dtype=np.float32)
            T4[:3, :3] = R
            tf = tf @ T4
        if "translation" in node:
            T4 = np.eye(4, dtype=np.float32)
            T4[:3, 3] = node["translation"]
            tf = T4 @ tf
        return tf


class _GLTFWriter:
    """Write the first mesh of a batch to GLB: geometry only."""

    def __init__(self, data: Meshes, stream) -> None:
        self._data = data
        self._stream = stream

    def save(self) -> None:
        nv = int(self._data.num_verts_per_mesh()[0])
        nf = int(self._data.num_faces_per_mesh()[0])
        verts = _to_numpy(self._data.verts_padded()[0][:nv]).astype(np.float32)
        faces = _to_numpy(self._data.faces_padded()[0][:nf]).astype(np.uint32)
        vb = verts.tobytes()
        fb = faces.tobytes()
        binary = fb + vb
        pad = (4 - len(binary) % 4) % 4
        binary += b"\x00" * pad

        gltf = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "meshes": [
                {
                    "primitives": [
                        {
                            "attributes": {"POSITION": 1},
                            "indices": 0,
                            "mode": 4,
                        }
                    ]
                }
            ],
            "accessors": [
                {
                    "bufferView": 0,
                    "componentType": 5125,
                    "count": faces.size,
                    "type": "SCALAR",
                },
                {
                    "bufferView": 1,
                    "componentType": 5126,
                    "count": nv,
                    "type": "VEC3",
                    "min": verts.min(0).tolist(),
                    "max": verts.max(0).tolist(),
                },
            ],
            "bufferViews": [
                {"buffer": 0, "byteOffset": 0, "byteLength": len(fb)},
                {"buffer": 0, "byteOffset": len(fb), "byteLength": len(vb)},
            ],
            "buffers": [{"byteLength": len(binary)}],
        }
        jb = json.dumps(gltf).encode("utf-8")
        jb += b" " * ((4 - len(jb) % 4) % 4)

        total = 12 + 8 + len(jb) + 8 + len(binary)
        self._stream.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        self._stream.write(struct.pack("<II", len(jb), _JSON_CHUNK))
        self._stream.write(jb)
        self._stream.write(struct.pack("<II", len(binary), _BIN_CHUNK))
        self._stream.write(binary)


class MeshGlbFormat(MeshFormatInterpreter):
    """Pluggable-IO interpreter for .glb (and .gltf to read)."""

    known_suffixes = (".glb", ".gltf")

    def read(self, path, include_textures: bool = True, device=None, **kwargs):
        if not endswith(path, self.known_suffixes):
            return None
        with open(str(path), "rb") as f:
            return _GLTFLoader(f, device=device).load(include_textures=include_textures)

    def save(self, data: Meshes, path, **kwargs) -> bool:
        if not endswith(path, (".glb",)):
            return False
        with open(str(path), "wb") as f:
            _GLTFWriter(data, f).save()
        return True


def load_meshes(path, path_manager=None, include_textures: bool = True, device=None):
    """All meshes of the default scene of a .glb/.gltf file as (name,
    Meshes) pairs, on `device` (None: the card)."""
    with open(path, "rb") as f:
        loader = _GLTFLoader(f, device=device)
        return loader.load_named(include_textures=include_textures)
