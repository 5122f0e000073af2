"""Mesh and point cloud IO: the port against the JAX package on the CPU, on
files each test writes from seeded numpy data.

Tolerances:
- loaders: vertices, UVs, normals, colours, face and material indices equal
  to the JAX loaders' (the same host numpy parsing, the same float32 casts);
  dtypes of `load_obj` / `load_ply` / `load_off` outputs equal too;
- texture images and atlases within 1e-6 (the same numpy bilinear bake);
- glTF vertices within 1e-6 (a float32 4x4 node transform), faces, UVs and
  the map equal;
- writers: the files `save_obj`, `save_ply`, `save_off` and the GLB writer
  write are byte-identical to the JAX package's on the same inputs;
- errors: the same exception type with the JAX test's message substring,
  or the same warning, through both OBJ parsers.
"""

import contextlib
import io
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.io as jio
from pytorch3d_tpu.io import experimental_gltf_io as jgltf
from pytorch3d_tpu.io import obj_io as jobj
from pytorch3d_tpu.io import off_io as joff
from pytorch3d_tpu.io import ply_io as jply
from pytorch3d_tpu.io.pluggable import MeshFormatInterpreter as JMeshFormatInterpreter
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu_torch import io as tio
from pytorch3d_tpu_torch.io import experimental_gltf_io as tgltf
from pytorch3d_tpu_torch.io import fast_io as tfast
from pytorch3d_tpu_torch.io import mtl_io as tmtl
from pytorch3d_tpu_torch.io import obj_io as tobj
from pytorch3d_tpu_torch.io import off_io as toff
from pytorch3d_tpu_torch.io import ply_io as tply
from pytorch3d_tpu_torch.io.pluggable import MeshFormatInterpreter
from pytorch3d_tpu_torch.renderer.mesh.textures import TexturesVertex
from pytorch3d_tpu_torch.structures import Meshes, Pointclouds

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools


@pytest.fixture(autouse=True)
def _two_threads():
    """Beside other test processes, torch's full thread pool makes small
    tensors' ops far slower; two threads keep them near their time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return None if x is None else (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))


def _equal(got, want, atol=0.0, dtype=True):
    """Port output `got` against JAX's `want`: both None, or equal shapes
    (and dtypes) and values within atol."""
    if want is None:
        assert got is None
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape
    if dtype:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if atol:
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(g, w)


def _mesh(seed=0, V=12, F=20):
    rng = np.random.default_rng(seed)
    verts = rng.standard_normal((V, 3)).astype(np.float32)
    faces = np.stack([rng.permutation(V)[:3] for _ in range(F)]).astype(np.int64)
    return verts, faces


# --------------------------------------------------------------------------- #
# OBJ
# --------------------------------------------------------------------------- #

OBJ_TEXTS = {
    "simple": "# comment\nv 0.1 0.2 0.3\nv 0.2 0.3 0.4\nv 0.3 0.4 0.5\nv 0.4 0.5 0.6\nf 1 2 3\nf 1 2 4\n",
    "normals_uvs": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.1 0.2\nvt 0.3 0.4\nvt 0.5 0.6\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1\n",
    "normals_only": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvn 0 1 0\nf 1//1 2//2 3//1\n",
    "quads": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 2 2\nf 1 2 3 4\nf 2 3 4 5 1\n",
    "negative": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 1\nf -3/-2 -2/-1 -1/-1\n",
    "mixed_uv": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\nf 2 4 3\n",
    "tabs_floats": "v\t1e-3 -2.5E+1 .5\nv 3 4 5\nv 6 7 8\nf 1 2 3\n",
}
# "" takes the native parser for a geometry-only file; an mtllib line the
# Python scanner (the .mtl is missing, so no textures load).
OBJ_PARSERS = {"native": "", "python": "mtllib missing.mtl\n"}


def _same_obj(t, j):
    (tv, tf, ta), (jv, jf, ja) = t, j
    _equal(tv, jv)
    for name in ("verts_idx", "normals_idx", "textures_idx", "materials_idx"):
        _equal(getattr(tf, name), getattr(jf, name))
    _equal(ta.normals, ja.normals)
    _equal(ta.verts_uvs, ja.verts_uvs)


@pytest.mark.parametrize("parser", OBJ_PARSERS)
@pytest.mark.parametrize("case", OBJ_TEXTS)
def test_load_obj_matches_jax(case, parser):
    text = OBJ_PARSERS[parser] + OBJ_TEXTS[case]
    t = tobj.load_obj(io.StringIO(text), load_textures=False, device="cpu")
    j = jobj.load_obj(io.StringIO(text), load_textures=False)
    _same_obj(t, j)
    assert t[0].device.type == "cpu"


@pytest.mark.parametrize("case", OBJ_TEXTS)
def test_native_parser_matches_python_scanner(case, monkeypatch):
    if not tfast.native_available():
        pytest.skip("g++ is not installed here, so the native OBJ parser cannot be built")
    native = tobj.load_obj(io.StringIO(OBJ_TEXTS[case]), load_textures=False, device="cpu")
    monkeypatch.setattr(tfast, "fast_parse_obj", lambda text: None)
    scanned = tobj.load_obj(io.StringIO(OBJ_TEXTS[case]), load_textures=False, device="cpu")
    # The scanner gives every face material -1 (no usemtl); the native parser
    # gives no material stream, as in the JAX package.
    assert native[1].materials_idx is None and bool((scanned[1].materials_idx == -1).all())
    _same_obj(native, (scanned[0], scanned[1]._replace(materials_idx=None), scanned[2]))


def test_native_library_builds_under_build_dir():
    if not tfast.native_available():
        pytest.skip("g++ is not installed here, so the native OBJ parser cannot be built")
    path = tfast.library_path()
    assert path.is_file() and path.parent.name == "host" and path.parent.parent.name == "build"
    assert not list(tfast.SOURCE.parent.glob("*.so"))


def _write_textured_obj(d, name, seed, n_faces, size, uv_range=(0.0, 1.0)):
    """An .obj with two materials (one with a Kd colour and a PNG map, one
    with a Kd colour only), per-corner UVs in `uv_range`, and its .mtl."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    verts, faces = _mesh(seed, V=10, F=n_faces)
    uvs = rng.uniform(*uv_range, (n_faces * 3, 2)).astype(np.float32)
    Image.fromarray((rng.random((size, size + 3, 3)) * 255).astype(np.uint8)).save(d / f"{name}.png")
    (d / f"{name}.mtl").write_text(
        f"newmtl mat0\nKd 0.5 0.6 0.7\nKa 0.1 0.2 0.3\nKs 0.9 0.8 0.7\nNs 12.5\nmap_Kd {name}.png\n"
        "newmtl mat1\nKd 0.2 0.3 0.4\n"
    )
    lines = [f"mtllib {name}.mtl"] + [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in uvs]
    for i, f in enumerate(faces):
        if i == 0:
            lines.append("usemtl mat0")
        if i == n_faces - 2:
            lines.append("usemtl mat1")
        lines.append("f " + " ".join(f"{f[k] + 1}/{3 * i + k + 1}" for k in range(3)))
    path = d / f"{name}.obj"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("wrap,uv_range", [("repeat", (0.0, 1.0)), ("repeat", (-0.5, 1.5)), ("clamp", (-0.5, 1.5))])
def test_load_obj_with_mtl_matches_jax(tmp_path, wrap, uv_range):
    path = _write_textured_obj(tmp_path, "mesh", 1, 6, 9, uv_range)
    kw = dict(create_texture_atlas=True, texture_atlas_size=3, texture_wrap=wrap)
    wraps = wrap == "repeat" and uv_range != (0.0, 1.0)

    def warned():
        return pytest.warns(UserWarning, match="outside the range") if wraps else contextlib.nullcontext()

    with warned():
        t = tobj.load_obj(str(path), device="cpu", **kw)
    with warned():
        j = jobj.load_obj(str(path), **kw)
    _same_obj(t, j)
    ta, ja = t[2], j[2]
    assert list(ta.material_colors) == list(ja.material_colors) == ["mat0", "mat1"]
    for name, props in ja.material_colors.items():
        assert list(ta.material_colors[name]) == list(props)
        for key, value in props.items():
            _equal(ta.material_colors[name][key], value)
    assert list(ta.texture_images) == list(ja.texture_images) == ["mat0"]
    _equal(ta.texture_images["mat0"], ja.texture_images["mat0"], atol=1e-6)
    _equal(ta.texture_atlas, ja.texture_atlas, atol=1e-6)
    assert ta.texture_atlas.shape == (6, 3, 3, 3)


def test_mtl_aliases_match_jax(tmp_path):
    path = _write_textured_obj(tmp_path, "mesh", 2, 4, 8)
    tcol, timg = tmtl.load_mtl(str(tmp_path / "mesh.mtl"), ["mat0", "mat1"], str(tmp_path), device="cpu")
    jcol, jimg = jobj._load_mtl(str(tmp_path / "mesh.mtl"), ["mat0", "mat1"], str(tmp_path))
    _equal(tcol["mat0"]["shininess"], jcol["mat0"]["shininess"])
    _equal(timg["mat0"], jimg["mat0"])
    uvs = np.random.default_rng(3).random((5, 3, 2)).astype(np.float32)
    image = np.asarray(jimg["mat0"])
    _equal(tmtl.make_material_atlas(image, uvs, 4), jobj.make_material_atlas(image, uvs, 4), atol=1e-6)
    assert path.is_file()


@pytest.mark.parametrize("atlas", [False, True])
def test_load_objs_as_meshes_batch_matches_jax(tmp_path, atlas):
    paths = [str(_write_textured_obj(tmp_path, f"m{i}", 4 + i, n, 8)) for i, n in enumerate((5, 8))]
    tm = tobj.load_objs_as_meshes(paths, device="cpu", create_texture_atlas=atlas, texture_atlas_size=2)
    jm = jobj.load_objs_as_meshes(paths, create_texture_atlas=atlas, texture_atlas_size=2)
    _equal(tm.verts_padded(), jm.verts_padded())
    _equal(tm.faces_padded(), jm.faces_padded(), dtype=False)
    _equal(tm.num_faces_per_mesh(), jm.num_faces_per_mesh(), dtype=False)
    if atlas:
        _equal(tm.textures.atlas_padded(), jm.textures.atlas_padded(), atol=1e-6)
    else:
        _equal(tm.textures.maps_padded(), jm.textures.maps_padded(), atol=1e-6)
        _equal(tm.textures.faces_uvs_padded(), jm.textures.faces_uvs_padded(), dtype=False)
        _equal(tm.textures.verts_uvs_padded(), jm.textures.verts_uvs_padded())


@pytest.mark.parametrize("decimal_places", [None, 3])
@pytest.mark.parametrize("extras", ["none", "normals", "texture", "both"])
def test_save_obj_writes_jax_bytes(tmp_path, decimal_places, extras):
    verts, faces = _mesh(5)
    rng = np.random.default_rng(6)
    kw = {}
    if extras in ("normals", "both"):
        kw.update(normals=rng.standard_normal((4, 3)).astype(np.float32), faces_normals_idx=rng.integers(0, 4, (20, 3)))
    if extras in ("texture", "both"):
        kw.update(verts_uvs=rng.random((7, 2)).astype(np.float32), faces_uvs=rng.integers(0, 7, (20, 3)),
                  texture_map=rng.random((6, 5, 3)).astype(np.float32))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tobj.save_obj(tmp_path / "t" / "m.obj", torch.tensor(verts), torch.tensor(faces), decimal_places,
                  **{k: torch.tensor(v) for k, v in kw.items()})
    jobj.save_obj(str(tmp_path / "j" / "m.obj"), jnp.asarray(verts), jnp.asarray(faces), decimal_places,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == (3 if "texture" in kw or "texture_map" in kw else 1)
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    buf_t, buf_j = io.StringIO(), io.StringIO()
    tobj.save_obj(buf_t, verts, faces, decimal_places)
    jobj.save_obj(buf_j, verts, faces, decimal_places)
    assert buf_t.getvalue() == buf_j.getvalue()


def test_obj_round_trip_matches_jax(tmp_path):
    verts, faces = _mesh(7, V=30, F=50)
    tobj.save_obj(tmp_path / "m.obj", torch.tensor(verts), torch.tensor(faces))
    _same_obj(tobj.load_obj(tmp_path / "m.obj", device="cpu"), jobj.load_obj(str(tmp_path / "m.obj")))
    v, f, _ = tobj.load_obj(tmp_path / "m.obj", device="cpu")
    np.testing.assert_allclose(_np(v), verts, rtol=0, atol=5e-7)
    _equal(f.verts_idx, faces.astype(np.int32))


# --------------------------------------------------------------------------- #
# Errors
# --------------------------------------------------------------------------- #

OBJ_ERRORS = {
    "texture_two_values": ("vt 0.1", ValueError, "does not have 2 values"),
    "normal_three_values": ("vn 0.1", ValueError, "does not have 3 values"),
    "vertex_three_values": ("v 1", ValueError, "does not have 3 values"),
    "inconsistent_triplets": ("f 2//1 3/1 4/1/2", ValueError, "Vertex properties are inconsistent"),
    "too_many_properties": ("f 2/1/1/3", ValueError, "can only have 3 properties"),
    "invalid_vertex_indices": ("v 0.1 0.2 0.3\nv 0.1 0.2 0.3\nv 0.1 0.2 0.3\nf -2 5 1", UserWarning,
                               "Faces have invalid indices"),
    "invalid_normal_indices": ("v 0.1 0.2 0.3\nv 0.1 0.2 0.3\nv 0.1 0.2 0.3\nvn 0.1 0.2 0.3\nvn 0.1 0.2 0.3\n"
                               "vn 0.1 0.2 0.3\nf -2//2 2//4 1//1", UserWarning, "Faces have invalid indices"),
}


def _raises_like_jax(call_t, call_j, kind, match):
    if issubclass(kind, Warning):
        with pytest.warns(kind, match=match):
            call_j()
        with pytest.warns(kind, match=match):
            call_t()
        return
    with pytest.raises(kind, match=match) as jerr:
        call_j()
    with pytest.raises(kind, match=match) as terr:
        call_t()
    assert type(terr.value) is type(jerr.value)


@pytest.mark.parametrize("parser", OBJ_PARSERS)
@pytest.mark.parametrize("case", OBJ_ERRORS)
def test_obj_errors_match_jax(case, parser):
    text, kind, match = OBJ_ERRORS[case]
    text = OBJ_PARSERS[parser] + text
    _raises_like_jax(lambda: tobj.load_obj(io.StringIO(text), load_textures=False, device="cpu"),
                     lambda: jobj.load_obj(io.StringIO(text), load_textures=False), kind, match)


def test_obj_mtllib_without_name_matches_jax():
    _raises_like_jax(lambda: tobj.load_obj(io.StringIO("mtllib\nv 0 0 0"), load_textures=False, device="cpu"),
                     lambda: jobj.load_obj(io.StringIO("mtllib\nv 0 0 0"), load_textures=False),
                     ValueError, "not specified")


GOOD_PLY = ["ply", "format ascii 1.0", "comment dashfadskfj;k", "element vertex 1", "property float x",
            "element listy 1", "property list uint int x", "end_header", "0", "0"]


def _ply_case(edit):
    lines = GOOD_PLY.copy()
    edit(lines)
    return lines


PLY_ERRORS = {
    "bad_magic": (lambda ls: ls.__setitem__(0, "PLY"), "Invalid file header."),
    "invalid_header_line": (lambda ls: ls.__setitem__(2, "#this is a comment"), "Invalid line"),
    "property_before_element": (lambda ls: ls.__setitem__(slice(3, 5), [ls[4], ls[3]]),
                                "Encountered property before any element."),
    "inconsistent_vertex_data": (lambda ls: ls.__setitem__(8, "1 2"), "Inconsistent data for vertex."),
    "not_enough_data": (lambda ls: ls.pop(), "Not enough data for listy."),
    "not_enough_data_count": (lambda ls: ls.__setitem__(5, "element listy 2"), "Not enough data for listy."),
    "duplicate_property": (lambda ls: ls.insert(4, "property short x"),
                           "Cannot have two properties called x in vertex."),
    "invalid_datatype": (lambda ls: ls.insert(4, "property zz short"), "Invalid datatype: zz"),
    "extra_data": (lambda ls: ls.append("3"), "Extra data at end of file."),
    "element_without_properties": (lambda ls: ls.insert(4, "element bad 1"), "Found an element with no properties."),
    "list_length_mismatch": (lambda ls: ls.__setitem__(-1, "3 1 2 3 4"),
                             "A line of listy data did not have the specified length."),
    "count_not_a_number": (lambda ls: ls.__setitem__(3, "element vertex one"),
                           "Number of items for vertex was not a number."),
    "heterogeneous_short_row": (lambda ls: ls.insert(5, "property double y"), "Inconsistent data for vertex."),
}


@pytest.mark.parametrize("case", PLY_ERRORS)
def test_ply_errors_match_jax(case):
    edit, match = PLY_ERRORS[case]
    data = "\n".join(_ply_case(edit)).encode("ascii")
    _raises_like_jax(lambda: tply._load_ply_raw(io.BytesIO(data)), lambda: jply._load_ply_raw(io.BytesIO(data)),
                     ValueError, match)


@pytest.mark.parametrize("lines,match", [
    (["ply", "format ascii 1.0", "element listy 1", "property list uint int x", "end_header", "0"],
     "no vertex element"),
    (["ply", "format ascii 1.0", "element vertex 1", "property float x", "end_header", "0"],
     "Invalid vertices in file."),
])
def test_load_ply_errors_match_jax(lines, match):
    data = "\n".join(lines).encode("ascii")
    _raises_like_jax(lambda: tply.load_ply(io.BytesIO(data), device="cpu"), lambda: jply.load_ply(io.BytesIO(data)),
                     ValueError, match)


def test_good_ply_lists_match_jax():
    for last in ("0", "3 2 3 3"):
        data = "\n".join(GOOD_PLY[:-1] + [last]).encode("ascii")
        t, j = tply._load_ply_raw(io.BytesIO(data)), jply._load_ply_raw(io.BytesIO(data))
        assert list(t) == list(j)
        for name in t:
            np.testing.assert_array_equal(t[name][1], j[name][1])
            assert t[name][2] == j[name][2]


GOOD_OFF = ["4 2 12", " 1.0  0.0 1.4142", " 0.0  1.0 1.4142", " 1.0  0.0 0.4142", " 0.0  1.0 0.4142",
            "3  0 1 2 ", "3  1 3 0 "]

OFF_ERRORS = {
    "not_enough_face_data": (GOOD_OFF[:-1], "Not enough face data."),
    "extra_data": (["4 1 12"] + GOOD_OFF[1:], "Extra data at end of file:"),
    "face_too_few_vertices": (GOOD_OFF[:-1] + ["2 1 3"], "Faces must have at least 3 vertices."),
    "face_line_wrong_length": (GOOD_OFF[:-1] + ["4 1 3 0"], "A line of face data did not have the specified length."),
    "bad_vertex_count": (["6 2 0"] + GOOD_OFF[1:], "number of columns"),
    "empty_file": ([""], "Not enough data"),
}


@pytest.mark.parametrize("case", OFF_ERRORS)
def test_off_errors_match_jax(case):
    lines, match = OFF_ERRORS[case]
    text = "\n".join(lines)
    _raises_like_jax(lambda: toff.load_off_full(io.StringIO(text), device="cpu"),
                     lambda: joff.load_off_full(io.StringIO(text)), ValueError, match)


# --------------------------------------------------------------------------- #
# PLY and OFF
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ascii", [False, True])
@pytest.mark.parametrize("extras", ["none", "faces", "normals_colors", "all"])
def test_save_ply_writes_jax_bytes(tmp_path, ascii, extras):
    verts, faces = _mesh(8)
    rng = np.random.default_rng(9)
    normals = rng.standard_normal((12, 3)).astype(np.float32)
    colors = rng.random((12, 3)).astype(np.float32) * 1.2 - 0.1  # beyond [0, 1]: the clip and the truncation
    kw = dict(ascii=ascii, decimal_places=None if ascii else 4)
    if extras in ("faces", "all"):
        kw["faces"] = faces
    if extras in ("normals_colors", "all"):
        kw.update(verts_normals=normals, colors=colors)
    tply.save_ply(tmp_path / "t.ply", torch.tensor(verts), **{k: torch.tensor(v) if isinstance(v, np.ndarray) else v
                                                             for k, v in kw.items()})
    jply.save_ply(str(tmp_path / "j.ply"), jnp.asarray(verts), **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                                                 else v for k, v in kw.items()})
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    if extras == "all":
        t, j = tply.load_ply_pointcloud(tmp_path / "t.ply", device="cpu"), jply.load_ply_pointcloud(str(tmp_path / "j.ply"))
        for a, b in zip(t, j):
            _equal(a, b)
        tv, tf = tply.load_ply(tmp_path / "t.ply", device="cpu")
        jv, jf = jply.load_ply(str(tmp_path / "j.ply"))
        _equal(tv, jv)
        _equal(tf, jf)


def _binary_ply(endian, verts, polys):
    """A binary PLY with double x, float y, z, a uchar colour and faces as
    uchar-counted int lists (triangles and quads)."""
    head = (f"ply\nformat binary_{endian}_endian 1.0\ncomment written by the test\nelement vertex {len(verts)}\n"
            "property double x\nproperty float y\nproperty float z\nproperty uchar red\n"
            f"element face {len(polys)}\nproperty list uchar int vertex_index\nend_header\n").encode("ascii")
    e = "<" if endian == "little" else ">"
    body = b"".join(struct.pack(e + "dffB", *v[:3], int(v[3])) for v in verts)
    body += b"".join(struct.pack(e + "B" + "i" * len(p), len(p), *p) for p in polys)
    return head + body


@pytest.mark.parametrize("endian", ["little", "big"])
def test_load_binary_ply_both_endians_matches_jax(tmp_path, endian):
    rng = np.random.default_rng(10)
    verts = [tuple(rng.standard_normal(3)) + (rng.integers(0, 256),) for _ in range(6)]
    data = _binary_ply(endian, verts, [(0, 1, 2), (2, 3, 4, 5), (1, 4, 5)])
    (tmp_path / "m.ply").write_bytes(data)
    tv, tf = tply.load_ply(tmp_path / "m.ply", device="cpu")
    jv, jf = jply.load_ply(str(tmp_path / "m.ply"))
    _equal(tv, jv)
    _equal(tf, jf)
    assert tf.shape == (4, 3)
    sv, sf = tply.load_ply(io.BytesIO(data), device="cpu")  # a stream
    _equal(sv, jv)
    _equal(sf, jf)


def test_pointcloud_ply_through_io_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    pts, nrm, col = (rng.random((40, 3)).astype(np.float32) for _ in range(3))
    tio.IO().save_pointcloud(Pointclouds.create(pts[None], normals=nrm[None], features=col[None], device="cpu"),
                             tmp_path / "t.ply")
    jio.IO().save_pointcloud(JPointclouds.create(jnp.asarray(pts[None]), normals=jnp.asarray(nrm[None]),
                                                 features=jnp.asarray(col[None])), str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    t = tio.IO().load_pointcloud(tmp_path / "t.ply", device="cpu")
    j = jio.IO().load_pointcloud(str(tmp_path / "j.ply"))
    _equal(t.points_padded(), j.points_padded())
    _equal(t.normals_padded(), j.normals_padded())
    _equal(t.features_padded(), j.features_padded())
    _equal(t.points_padded()[0], pts)  # float32 survives binary PLY exactly


OFF_TEXTS = {
    "vertex_colors_float": "COFF\n3 1 0\n0 0 0 1.0 0.0 0.0\n1 0 0 0.0 1.0 0.0\n0 1 0 0.0 0.0 1.0\n3 0 1 2\n",
    "vertex_colors_int": "COFF\n3 1 0\n0 0 0 255 0 0\n1 0 0 0 255 0\n0 1 0 0 0 255 \n3 0 1 2\n",
    "vertex_colors_rgba": "COFF\n3 1 0\n0 0 0 1.0 0.0 0.0 0.5\n1 0 0 0.0 1.0 0.0 0.5\n0 1 0 0.0 0.0 1.0 0.5\n3 0 1 2\n",
    "face_colors_float": "OFF\n4 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3 0.9 0.1 0.2\n3 0 1 3 0.5 0.5 0.5\n",
    "face_colors_int": "OFF\n4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3 200 100 50 255\n",
    "quads_comments": "OFF # header\n5 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n2 2 2\n4 0 1 2 3\n5 4 3 2 1 0 # pentagon\n",
    "header_one_line": "OFF 3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n",
}


@pytest.mark.parametrize("case", OFF_TEXTS)
def test_load_off_matches_jax(case):
    t = toff.load_off_full(io.StringIO(OFF_TEXTS[case]), device="cpu")
    j = joff.load_off_full(io.StringIO(OFF_TEXTS[case]))
    assert sorted(t) == sorted(j)
    for key in j:
        _equal(t[key], j[key])


@pytest.mark.parametrize("colors", [False, True])
def test_save_off_writes_jax_bytes(tmp_path, colors):
    verts, faces = _mesh(12)
    rng = np.random.default_rng(13)
    kw = dict(verts_colors=rng.random((12, 3)).astype(np.float32), faces_colors=rng.random((20, 3)).astype(np.float32)
              ) if colors else {}
    toff.save_off(tmp_path / "t.off", torch.tensor(verts), torch.tensor(faces), **{k: torch.tensor(v) for k, v in kw.items()})
    joff.save_off(str(tmp_path / "j.off"), verts, faces, **kw)
    assert (tmp_path / "t.off").read_bytes() == (tmp_path / "j.off").read_bytes()


# --------------------------------------------------------------------------- #
# glTF
# --------------------------------------------------------------------------- #


def _write_glb(path, meshes, nodes, png):
    """A GLB with one mesh per (verts, faces, uvs) and the given nodes, the
    first mesh textured by `png` (embedded in the binary chunk)."""
    binary = b""
    views, accessors, gltf_meshes = [], [], []

    def add(data, component, kind, count):
        nonlocal binary
        views.append({"buffer": 0, "byteOffset": len(binary), "byteLength": len(data)})
        binary += data + b"\x00" * ((4 - len(data) % 4) % 4)
        accessors.append({"bufferView": len(views) - 1, "componentType": component, "count": count, "type": kind})
        return len(accessors) - 1

    for i, (verts, faces, uvs) in enumerate(meshes):
        prim = {"attributes": {"POSITION": add(verts.tobytes(), 5126, "VEC3", len(verts)),
                               "TEXCOORD_0": add(uvs.tobytes(), 5126, "VEC2", len(uvs))},
                "indices": add(faces.astype(np.uint16).tobytes(), 5123, "SCALAR", faces.size), "mode": 4}
        if i == 0:
            prim["material"] = 0
        gltf_meshes.append({"name": f"mesh{i}", "primitives": [prim]})
    views.append({"buffer": 0, "byteOffset": len(binary), "byteLength": len(png)})
    binary += png + b"\x00" * ((4 - len(png) % 4) % 4)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": nodes, "meshes": gltf_meshes,
        "accessors": accessors, "bufferViews": views, "buffers": [{"byteLength": len(binary)}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}], "images": [{"bufferView": len(views) - 1, "mimeType": "image/png"}],
    }
    jb = json.dumps(gltf).encode("utf-8")
    jb += b" " * ((4 - len(jb) % 4) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(jb) + 8 + len(binary)))
        f.write(struct.pack("<II", len(jb), 0x4E4F534A) + jb)
        f.write(struct.pack("<II", len(binary), 0x004E4942) + binary)


def test_glb_with_node_transforms_and_texture_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(14)
    meshes = []
    for V, F in ((8, 10), (6, 4)):
        verts, faces = _mesh(int(rng.integers(100)), V=V, F=F)
        meshes.append((verts, faces, rng.random((V, 2)).astype(np.float32)))
    buf = io.BytesIO()
    Image.fromarray((rng.random((5, 7, 3)) * 255).astype(np.uint8)).save(buf, format="PNG")
    q = np.asarray([0.1, 0.2, 0.3, 0.9])
    q = (q / np.linalg.norm(q)).tolist()
    nodes = [
        {"name": "root", "children": [1, 2], "translation": [0.5, -1.0, 2.0], "rotation": q, "scale": [1.5, 0.5, 2.0]},
        {"name": "first", "mesh": 0, "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0.25, 0.5, 0.75, 1]},
        {"name": "second", "mesh": 1, "translation": [1.0, 2.0, 3.0]},
    ]
    _write_glb(tmp_path / "scene.glb", meshes, nodes, buf.getvalue())
    t = tgltf.load_meshes(tmp_path / "scene.glb", device="cpu")
    j = jgltf.load_meshes(str(tmp_path / "scene.glb"))
    assert [name for name, _ in t] == [name for name, _ in j] == ["second", "first"]
    for (_, tm), (_, jm) in zip(t, j):
        _equal(tm.verts_padded(), jm.verts_padded(), atol=1e-6)
        _equal(tm.faces_padded(), jm.faces_padded(), dtype=False)
    tex_t, tex_j = t[1][1].textures, j[1][1].textures
    assert t[0][1].textures is None and j[0][1].textures is None
    _equal(tex_t.maps_padded(), tex_j.maps_padded())
    _equal(tex_t.verts_uvs_padded(), tex_j.verts_uvs_padded())
    _equal(tex_t.faces_uvs_padded(), tex_j.faces_uvs_padded(), dtype=False)
    tb = tio.IO().load_mesh(tmp_path / "scene.glb", device="cpu")  # both primitives as a batch
    jb = jio.IO().load_mesh(str(tmp_path / "scene.glb"))
    _equal(tb.verts_padded(), jb.verts_padded(), atol=1e-6)
    _equal(tb.faces_padded(), jb.faces_padded(), dtype=False)


# --------------------------------------------------------------------------- #
# The pluggable IO
# --------------------------------------------------------------------------- #


def _both_meshes(seed=15, colors=False):
    verts, faces = _mesh(seed)
    col = np.random.default_rng(seed).random((1, 12, 3)).astype(np.float32)
    t = Meshes.create([verts], [faces], textures=TexturesVertex.create(col, device="cpu") if colors else None,
                      device="cpu")
    if colors:
        from pytorch3d_tpu.renderer.mesh.textures import TexturesVertex as JTexturesVertex

        j = JMeshes.create([jnp.asarray(verts)], [jnp.asarray(faces)], textures=JTexturesVertex.create(jnp.asarray(col)))
    else:
        j = JMeshes.create([jnp.asarray(verts)], [jnp.asarray(faces)])
    return t, j


@pytest.mark.parametrize("suffix,binary", [(".obj", True), (".ply", True), (".ply", False), (".off", True),
                                           (".glb", True)])
def test_io_mesh_round_trip_matches_jax(tmp_path, suffix, binary):
    tm, jm = _both_meshes(colors=suffix == ".off")
    tio.IO().save_mesh(tm, tmp_path / f"t{suffix}", binary=binary)
    jio.IO().save_mesh(jm, str(tmp_path / f"j{suffix}"), binary=binary)
    assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    t = tio.IO().load_mesh(tmp_path / f"t{suffix}", device="cpu")
    j = jio.IO().load_mesh(str(tmp_path / f"j{suffix}"))
    _equal(t.verts_padded(), j.verts_padded())
    _equal(t.faces_padded(), j.faces_padded(), dtype=False)
    if suffix == ".off":
        _equal(t.textures.verts_features_padded(), j.textures.verts_features_padded())
    else:
        assert t.textures is None and j.textures is None


@pytest.mark.parametrize("case", ["face_colors_float", "face_colors_int"])
def test_io_off_face_colors_atlas_matches_jax(tmp_path, case):
    (tmp_path / "m.off").write_text(OFF_TEXTS[case])
    t = tio.IO().load_mesh(tmp_path / "m.off", device="cpu")
    j = jio.IO().load_mesh(str(tmp_path / "m.off"))
    _equal(t.textures.atlas_padded(), j.textures.atlas_padded())
    _equal(t.faces_padded(), j.faces_padded(), dtype=False)


def test_io_textured_obj_matches_jax(tmp_path):
    path = _write_textured_obj(tmp_path, "mesh", 16, 6, 8)
    t = tio.IO().load_mesh(path, device="cpu")
    j = jio.IO().load_mesh(str(path))
    _equal(t.verts_padded(), j.verts_padded())
    _equal(t.textures.maps_padded(), j.textures.maps_padded(), atol=1e-6)
    _equal(t.textures.faces_uvs_padded(), j.textures.faces_uvs_padded(), dtype=False)
    plain = tio.IO().load_mesh(path, include_textures=False, device="cpu")
    assert plain.textures is None and jio.IO().load_mesh(str(path), include_textures=False).textures is None


def test_io_unknown_suffix_matches_jax(tmp_path):
    for call_t, call_j, match in (
        (lambda: tio.IO().load_mesh("foo.xyz", device="cpu"), lambda: jio.IO().load_mesh("foo.xyz"),
         "No mesh interpreter found to read foo.xyz."),
        (lambda: tio.IO().load_pointcloud("foo.obj", device="cpu"), lambda: jio.IO().load_pointcloud("foo.obj"),
         "No pointcloud interpreter found to read foo.obj."),
        (lambda: tio.IO().save_mesh(_both_meshes()[0], "foo.gltf"), lambda: jio.IO().save_mesh(_both_meshes()[1],
                                                                                                "foo.gltf"),
         "No mesh interpreter found to write to foo.gltf."),
    ):
        _raises_like_jax(call_t, call_j, ValueError, match)


def test_io_registered_interpreter_takes_precedence(tmp_path):
    class Stl(MeshFormatInterpreter):
        def read(self, path, include_textures=True, device=None, **kwargs):
            if not str(path).endswith(".stl"):
                return None
            return Meshes.create([torch.zeros(3, 3)], [torch.tensor([[0, 1, 2]])], device=device)

        def save(self, data, path, **kwargs):
            return False

    class JStl(JMeshFormatInterpreter):
        def read(self, path, include_textures=True, **kwargs):
            if not str(path).endswith(".stl"):
                return None
            return JMeshes.create([jnp.zeros((3, 3))], [jnp.asarray([[0, 1, 2]])])

        def save(self, data, path, **kwargs):
            return False

    t, j = tio.IO(), jio.IO()
    t.register_meshes_format(Stl())
    j.register_meshes_format(JStl())
    assert len(t.mesh_interpreters) == len(j.mesh_interpreters) == 5
    _equal(t.load_mesh("x.stl", device="cpu").faces_padded(), j.load_mesh("x.stl").faces_padded(), dtype=False)
    tm, jm = _both_meshes()
    t.save_mesh(tm, tmp_path / "t.obj")
    j.save_mesh(jm, str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    assert len(tio.IO(include_default_formats=False).mesh_interpreters) == 0
