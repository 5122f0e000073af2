"""Wavefront OBJ (+ MTL) loading and saving (port of
pytorch3d_tpu/io/obj_io.py).

Parsing stays on the host in numpy, as in the JAX package; the tensors are
made once at the end, on `device` (None: the card).  Files without an
`mtllib` line go through the native parser (`fast_io.py`) where it built;
the Python scanner below reads the others and is the oracle.  Outputs keep
the JAX package's dtypes: float32 values, int32 indices, -1 rows where a face
declares no UV or normal.
"""

from __future__ import annotations

import os
import warnings
from collections import namedtuple
from typing import List, Optional, Tuple

import numpy as np
import torch

from .utils import _device, _to_numpy

_Faces = namedtuple("Faces", "verts_idx normals_idx textures_idx materials_idx")
_Aux = namedtuple("Properties", "normals verts_uvs material_colors texture_images texture_atlas texture_atlas_idx")


def _check_faces_indices(arr: np.ndarray, max_index: int) -> None:
    """Warn on out-of-range face indices (-1 pads allowed)."""
    if arr.size and (((arr < 0) & (arr != -1)) | (arr >= max_index)).any():
        warnings.warn("Faces have invalid indices")


def _parse_face(tokens, materials_idx, faces_verts_idx, faces_normals_idx, faces_textures_idx,
                faces_materials_idx, line=""):
    face = tokens[1:]
    face_list = [f.split("/") for f in face]
    verts_idx, normals_idx, tex_idx = [], [], []
    for vnt in face_list:
        verts_idx.append(int(vnt[0]))
        if len(vnt) > 1 and vnt[1] != "":
            tex_idx.append(int(vnt[1]))
        if len(vnt) > 2 and vnt[2] != "":
            normals_idx.append(int(vnt[2]))
        if len(vnt) > 3:
            raise ValueError(f"Face vertices can only have 3 properties. Face vert {vnt}, Line: {line}")
    # UV and normal indices are all-or-none across a face
    if (tex_idx and len(tex_idx) != len(verts_idx)) or (normals_idx and len(normals_idx) != len(verts_idx)):
        raise ValueError(f"Face {face} is an illegal statement. Vertex properties are inconsistent. Line: {line}")
    # Fan triangulation; uv / normal rows are -1 padded per face, so the index
    # streams stay aligned with the faces where only some faces declare them.
    for i in range(len(verts_idx) - 2):
        faces_verts_idx.append((verts_idx[0], verts_idx[i + 1], verts_idx[i + 2]))
        if tex_idx:
            faces_textures_idx.append((tex_idx[0], tex_idx[i + 1], tex_idx[i + 2]))
        else:
            faces_textures_idx.append((-1, -1, -1))
        if normals_idx:
            faces_normals_idx.append((normals_idx[0], normals_idx[i + 1], normals_idx[i + 2]))
        else:
            faces_normals_idx.append((-1, -1, -1))
        faces_materials_idx.append(materials_idx)


def _load_mtl(mtl_path: str, material_names: List[str], data_dir: str, load_textures: bool = True, device=None):
    """Parse an MTL file: ({material: {diffuse_color, ambient_color,
    specular_color, shininess}}, {material: (H, W, 3) image in [0, 1]}),
    tensors on `device`; (None, None) if the file is missing."""
    device = _device(device)
    material_colors = {}
    texture_files = {}
    material_name = ""
    if not os.path.isfile(mtl_path):
        return None, None
    with open(mtl_path, "r") as f:
        for line in f:
            tokens = line.strip().split()
            if not tokens:
                continue
            if tokens[0] == "newmtl":
                material_name = tokens[1]
                material_colors[material_name] = {}
            elif tokens[0] == "map_Kd" and len(tokens) > 1:
                texture_files[material_name] = tokens[1]
            elif tokens[0] in ("Kd", "Ka", "Ks") and len(tokens) == 4:
                key = {"Kd": "diffuse_color", "Ka": "ambient_color", "Ks": "specular_color"}[tokens[0]]
                material_colors[material_name][key] = np.asarray([float(t) for t in tokens[1:4]], np.float32)
            elif tokens[0] == "Ns" and len(tokens) == 2:
                material_colors[material_name]["shininess"] = np.asarray(float(tokens[1]), np.float32)
    texture_images = {}
    if load_textures:
        for name, fname in texture_files.items():
            path = os.path.join(data_dir, fname)
            if os.path.isfile(path):
                from PIL import Image

                im = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
                texture_images[name] = torch.as_tensor(im, device=device)
    material_colors = {
        k: {kk: torch.as_tensor(vv, device=device) for kk, vv in v.items()} for k, v in material_colors.items()
    }
    return material_colors, texture_images


def _fix(idx_list, n):
    """OBJ's 1-based (or negative, from the end) indices to 0-based int32;
    rows of all -1 are per-face pads and pass through unchanged."""
    arr = np.asarray(idx_list, np.int64).reshape(-1, 3) if idx_list else np.zeros((0, 3), np.int64)
    pad_row = (arr == -1).all(axis=-1, keepdims=True)
    conv = np.where(arr > 0, arr - 1, arr + n)
    arr = np.where(pad_row, arr, conv)
    return arr.astype(np.int32)


def load_obj(
    f,
    load_textures: bool = True,
    create_texture_atlas: bool = False,
    texture_atlas_size: int = 4,
    texture_wrap: Optional[str] = "repeat",
    device=None,
    path_manager=None,
):
    """Load a .obj file: (verts (V, 3), Faces(verts_idx, normals_idx,
    textures_idx, materials_idx), Properties(normals, verts_uvs,
    material_colors, texture_images, texture_atlas, texture_atlas_idx)),
    tensors on `device` (None: the card)."""
    device = _device(device)

    def tensor(a):
        return None if a is None else torch.as_tensor(a, device=device)

    if hasattr(f, "read"):
        text = f.read()
        if isinstance(text, bytes):
            text = text.decode("utf-8")
        data_dir = "./"
    else:
        fname = str(f)
        data_dir = os.path.dirname(fname) or "./"
        with open(fname, "r") as fh:
            text = fh.read()

    # The native parser takes geometry-only files; materials go through the
    # Python scanner below.
    if "mtllib" not in text:
        from .fast_io import fast_parse_obj

        parsed = fast_parse_obj(text.encode("utf-8"))
        if parsed is not None:
            _check_faces_indices(parsed["faces"], len(parsed["verts"]))
            if parsed["faces_n"] is not None and parsed["normals"] is not None:
                _check_faces_indices(parsed["faces_n"], len(parsed["normals"]))
            if parsed["faces_uv"] is not None and parsed["uvs"] is not None:
                _check_faces_indices(parsed["faces_uv"], len(parsed["uvs"]))
            faces = _Faces(
                verts_idx=tensor(parsed["faces"]),
                normals_idx=tensor(parsed["faces_n"]),
                textures_idx=tensor(parsed["faces_uv"]),
                materials_idx=None,
            )
            aux = _Aux(
                normals=tensor(parsed["normals"]),
                verts_uvs=tensor(parsed["uvs"]),
                material_colors=None,
                texture_images=None,
                texture_atlas=None,
                texture_atlas_idx=None,
            )
            return tensor(parsed["verts"]), faces, aux

    verts, normals, verts_uvs = [], [], []
    faces_verts_idx: List[Tuple[int, int, int]] = []
    faces_normals_idx: List = []
    faces_textures_idx: List = []
    faces_materials_idx: List[int] = []
    material_names: List[str] = []
    mtl_path = None
    materials_idx = -1

    for line in text.splitlines():
        tokens = line.strip().split()
        if not tokens:
            continue
        if tokens[0] == "v":
            vert = [float(x) for x in tokens[1:4]]
            if len(vert) != 3:
                raise ValueError(f"Vertex {vert} does not have 3 values. Line: {line}")
            verts.append(vert)
        elif tokens[0] == "vt":
            tx = [float(x) for x in tokens[1:3]]
            if len(tx) != 2:
                raise ValueError(f"Texture {tx} does not have 2 values. Line: {line}")
            verts_uvs.append(tx)
        elif tokens[0] == "vn":
            norm = [float(x) for x in tokens[1:4]]
            if len(norm) != 3:
                raise ValueError(f"Normal {norm} does not have 3 values. Line: {line}")
            normals.append(norm)
        elif tokens[0] == "f":
            _parse_face(tokens, materials_idx, faces_verts_idx, faces_normals_idx, faces_textures_idx,
                        faces_materials_idx, line=line)
        elif tokens[0] == "mtllib":
            if len(tokens) < 2:
                raise ValueError("material file name is not specified")
            mtl_path = os.path.join(data_dir, tokens[1])
        elif tokens[0] == "usemtl":
            name = tokens[1]
            if name not in material_names:
                material_names.append(name)
            materials_idx = material_names.index(name)

    V = len(verts)
    verts_np = np.asarray(verts, np.float32).reshape(-1, 3)
    normals_np = np.asarray(normals, np.float32).reshape(-1, 3) if normals else None
    uvs_np = np.asarray(verts_uvs, np.float32).reshape(-1, 2) if verts_uvs else None
    fv_np = _fix(faces_verts_idx, V)
    _check_faces_indices(fv_np, V)
    # An index stream is kept only where some face declared it (all rows
    # being -1 pads means the file has no face uvs / normals).
    fn_np = None
    if any(row != (-1, -1, -1) for row in faces_normals_idx):
        fn_np = _fix(faces_normals_idx, len(normals))
        _check_faces_indices(fn_np, len(normals))
    ft_np = None
    if any(row != (-1, -1, -1) for row in faces_textures_idx):
        ft_np = _fix(faces_textures_idx, len(verts_uvs))
        _check_faces_indices(ft_np, len(verts_uvs))
    fm_np = np.asarray(faces_materials_idx, np.int32) if faces_materials_idx else None

    material_colors, texture_images = (None, None)
    texture_atlas = None
    if load_textures and mtl_path is not None:
        material_colors, texture_images = _load_mtl(mtl_path, material_names, data_dir, load_textures, device=device)
        if create_texture_atlas and texture_images and uvs_np is not None and ft_np is not None:
            texture_atlas = make_mesh_texture_atlas(
                material_colors or {}, texture_images, material_names, fm_np, uvs_np, ft_np,
                texture_atlas_size, texture_wrap, device=device,
            )

    faces = _Faces(verts_idx=tensor(fv_np), normals_idx=tensor(fn_np), textures_idx=tensor(ft_np),
                   materials_idx=tensor(fm_np))
    aux = _Aux(
        normals=tensor(normals_np),
        verts_uvs=tensor(uvs_np),
        material_colors=material_colors,
        texture_images=texture_images,
        texture_atlas=texture_atlas,
        texture_atlas_idx=None,
    )
    return tensor(verts_np), faces, aux


def _atlas_cell_barycentrics(texture_size: int) -> np.ndarray:
    """Centroid barycentrics (R, R, 3) of the per-face atlas grid.

    Each face's triangular texture space is split into R*R subtriangles
    mapped to grid cells: below the diagonal (x + y < R) the cell holds the
    lower subtriangle with centroid ((x, y) + 1/3)/R; above it, the upper
    subtriangle of the mirrored cell with centroid ((R-1-(x, y)) + 2/3)/R.
    w0 tracks x, w1 tracks y, w2 = 1 - w0 - w1: the fold that
    `TexturesAtlas.sample_textures` reads, so bake and lookup agree.
    """
    R = texture_size
    rng = np.arange(R)
    Y, X = np.meshgrid(rng, rng, indexing="ij")
    grid = np.stack([X, Y], axis=-1).astype(np.float64)  # (R, R, 2) xy
    below = grid.sum(-1) < R
    w01 = np.where(below[..., None], (grid + 1.0 / 3.0) / R, ((R - 1.0 - grid) + 2.0 / 3.0) / R)
    bary = np.concatenate([w01, 1.0 - w01.sum(-1, keepdims=True)], axis=-1)
    return bary.astype(np.float32)


def _bilinear_sample_image(image: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear lookup of `image` (H, W, C) at uv in [0, 1]^2 with the
    align_corners=True pixel mapping (u*(W-1), v*(H-1))."""
    H, W = image.shape[:2]
    x = np.clip(uv[..., 0], 0.0, 1.0) * (W - 1)
    y = np.clip(uv[..., 1], 0.0, 1.0) * (H - 1)
    x0 = np.floor(x).astype(np.int64).clip(0, W - 1)
    y0 = np.floor(y).astype(np.int64).clip(0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx1 = (x - x0).astype(image.dtype)[..., None]
    wy1 = (y - y0).astype(image.dtype)[..., None]
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    return (
        image[y0, x0] * (wx0 * wy0)
        + image[y1, x0] * (wx0 * wy1)
        + image[y0, x1] * (wx1 * wy0)
        + image[y1, x1] * (wx1 * wy1)
    )


def make_material_atlas(image: np.ndarray, faces_verts_uvs: np.ndarray, texture_size: int) -> np.ndarray:
    """Square per-face texture maps (F, R, R, C) from one image and per-face
    uv triples: each cell samples the image at its subtriangle's centroid,
    bilinearly with align_corners=True.  `image` is expected y-flipped
    already, as `make_mesh_texture_atlas` flips it.  Host numpy."""
    bary = _atlas_cell_barycentrics(texture_size)  # (R, R, 3)
    # (F, 1, 1, 3, 2) * (R, R, 3, 1) -> (F, R, R, 2)
    uv_pos = (_to_numpy(faces_verts_uvs)[:, None, None] * bary[..., None]).sum(-2)
    return _bilinear_sample_image(_to_numpy(image), uv_pos)


def make_mesh_texture_atlas(
    material_colors,
    texture_images,
    material_names,
    faces_materials_idx,
    verts_uvs,
    faces_textures_idx,
    texture_size: int = 4,
    texture_wrap: Optional[str] = "repeat",
    device=None,
) -> torch.Tensor:
    """Bake a per-face R x R texture atlas (F, R, R, 3) on `device`: white
    base colour, the diffuse colour of each face's material, then its
    y-flipped RGB image sampled at the subtriangle centroids.  "repeat" wraps
    uvs only when some fall outside [0, 1] (so a seam uv of exactly 1.0
    stays), "clamp" clips them."""
    device = _device(device)
    faces_materials_idx = _to_numpy(faces_materials_idx)
    F = faces_materials_idx.shape[0]
    R = texture_size
    atlas = np.ones((F, R, R, 3), np.float32)
    if not material_colors and not texture_images:
        return torch.as_tensor(atlas, device=device)

    for mi, name in enumerate(material_names):
        props = (material_colors or {}).get(name, {})
        if "diffuse_color" in props:
            fsel = faces_materials_idx == mi
            atlas[fsel] = _to_numpy(props["diffuse_color"]).astype(np.float32).reshape(1, 1, 1, 3)

    faces_verts_uvs = _to_numpy(verts_uvs)[_to_numpy(faces_textures_idx)]  # (F, 3, 2)
    if texture_wrap == "repeat":
        if (faces_verts_uvs > 1).any() or (faces_verts_uvs < 0).any():
            warnings.warn(
                "Texture UV coordinates outside the range [0, 1]. "
                "The integer part will be ignored to form a repeating pattern."
            )
            faces_verts_uvs = faces_verts_uvs % 1
    elif texture_wrap == "clamp":
        faces_verts_uvs = faces_verts_uvs.clip(0.0, 1.0)

    for mi, name in enumerate(material_names):
        if name not in (texture_images or {}):
            continue
        img = _to_numpy(texture_images[name]).astype(np.float32)[..., :3]
        img = img[::-1]  # the image's y runs down, uv's v up
        fsel = np.where(faces_materials_idx == mi)[0]
        if fsel.size == 0:
            continue
        atlas[fsel] = make_material_atlas(img, faces_verts_uvs[fsel], R)
    return torch.as_tensor(atlas, device=device)


def load_objs_as_meshes(
    files: list,
    device=None,
    load_textures: bool = True,
    create_texture_atlas: bool = False,
    texture_atlas_size: int = 4,
    texture_wrap: Optional[str] = "repeat",
    path_manager=None,
):
    """Load .obj files into one `Meshes` batch on `device` (None: the card):
    `TexturesUV` from the first material's map, or `TexturesAtlas` with
    `create_texture_atlas`; several files join as a padded batch."""
    from ..renderer.mesh.textures import TexturesAtlas, TexturesUV
    from ..structures.meshes import Meshes, join_meshes_as_batch

    device = _device(device)
    mesh_list = []
    for f_obj in files:
        verts, faces, aux = load_obj(
            f_obj,
            load_textures=load_textures,
            create_texture_atlas=create_texture_atlas,
            texture_atlas_size=texture_atlas_size,
            texture_wrap=texture_wrap,
            device=device,
        )
        tex = None
        if create_texture_atlas and aux.texture_atlas is not None:
            tex = TexturesAtlas.create(atlas=aux.texture_atlas[None], device=device)
        elif load_textures and aux.verts_uvs is not None and faces.textures_idx is not None and aux.texture_images:
            image = list(aux.texture_images.values())[0]
            tex = TexturesUV.create(
                maps=image[None], faces_uvs=faces.textures_idx[None], verts_uvs=aux.verts_uvs[None], device=device
            )
        mesh_list.append(Meshes.create([verts], [faces.verts_idx], textures=tex, device=device))
    if len(mesh_list) == 1:
        return mesh_list[0]
    return join_meshes_as_batch(mesh_list)


def save_obj(
    f,
    verts,
    faces,
    decimal_places: Optional[int] = None,
    *,
    normals=None,
    faces_normals_idx=None,
    verts_uvs=None,
    faces_uvs=None,
    texture_map=None,
) -> None:
    """Save verts and faces (and optional vn normals, uv texture) to .obj,
    with `decimal_places` (default 6) digits.  `f` may be a path or an open
    text stream (a texture map needs a path: it writes the .mtl and a .png
    beside the .obj)."""
    verts = _to_numpy(verts)
    faces = _to_numpy(faces)
    save_texture = all(x is not None for x in (verts_uvs, faces_uvs, texture_map))
    if (normals is None) != (faces_normals_idx is None):
        raise ValueError("normals and faces_normals_idx must be given together")
    save_normals = normals is not None
    prec = decimal_places if decimal_places is not None else 6
    is_stream = hasattr(f, "write")
    if is_stream and save_texture:
        raise ValueError("Saving a texture map requires a file path, not a stream.")
    name = None if is_stream else str(f)
    lines = []
    if save_texture:
        mtl_name = os.path.splitext(os.path.basename(name))[0]
        lines.append(f"mtllib {mtl_name}.mtl")
        lines.append(f"usemtl {mtl_name}")
    for v in verts:
        lines.append("v " + " ".join(f"{x:.{prec}f}" for x in v))
    if save_normals:
        for n in _to_numpy(normals):
            lines.append("vn " + " ".join(f"{x:.{prec}f}" for x in n))
    if save_texture:
        for uv in _to_numpy(verts_uvs):
            lines.append("vt " + " ".join(f"{x:.{prec}f}" for x in uv))

    fn = _to_numpy(faces_normals_idx) if save_normals else [None] * len(faces)
    ft = _to_numpy(faces_uvs) if save_texture else [None] * len(faces)
    for fv, t, n in zip(faces, ft, fn):
        toks = []
        for j in range(3):
            tok = str(int(fv[j]) + 1)
            if save_texture:
                tok += f"/{int(t[j]) + 1}"
                if save_normals:
                    tok += f"/{int(n[j]) + 1}"
            elif save_normals:
                tok += f"//{int(n[j]) + 1}"
            toks.append(tok)
        lines.append("f " + " ".join(toks))

    text = "\n".join(lines) + "\n"
    if is_stream:
        f.write(text)
        return
    with open(name, "w") as fh:
        fh.write(text)
    if save_texture:
        from PIL import Image

        base = os.path.splitext(name)[0]
        with open(base + ".mtl", "w") as fh:
            fh.write(f"newmtl {os.path.basename(base)}\n")
            fh.write(f"map_Kd {os.path.basename(base)}.png\n")
        img = (_to_numpy(texture_map) * 255).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(base + ".png")
