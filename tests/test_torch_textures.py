"""The port's textures (`renderer/mesh/textures.py`) and rectangle packing
(`renderer/mesh/utils.py`) against the JAX package, on the CPU.

Both packages get the same seeded numpy arrays (the port's through
`pytorch3d_tpu_torch.convert`):
- `sample_textures` of `TexturesUV` (sampling and padding modes, UVs
  reaching past [0, 1]), `TexturesAtlas` (R = 1 and 4) and
  `TexturesVertex` on the same fragments, with empty slots, and the
  gradients with respect to the maps / atlas / features and the
  barycentrics;
- `faces_verts_textures_packed`, `extend` / `__getitem__` round trips,
  `join_batch`, `join_scene` (with a face order), `submeshes`, the list
  accessors and `centers_for_image`;
- the `Textures(...)` factory and the `create` errors of
  tests/test_texturing_edges.py:163-200; `pack_rectangles` and
  `pack_unique_rectangles`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.renderer.mesh import textures as jtex
from pytorch3d_tpu.renderer.mesh import utils as jutils
from pytorch3d_tpu.renderer.mesh.rasterizer import Fragments as JFragments
from pytorch3d_tpu_torch import convert
from pytorch3d_tpu_torch.renderer import Textures, TexturesAtlas, TexturesUV, TexturesVertex
from pytorch3d_tpu_torch.renderer.mesh import utils as tutils
from pytorch3d_tpu_torch.renderer.mesh.rasterizer import Fragments

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
N, F, V, VUV, HM, WM, C, R = 2, 12, 9, 20, 8, 10, 3, 4


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        maps=rng.uniform(0.0, 1.0, (N, HM, WM, C)).astype(np.float32),
        faces_uvs=rng.integers(0, VUV, (N, F, 3)).astype(np.int32),
        verts_uvs=rng.uniform(-0.1, 1.1, (N, VUV, 2)).astype(np.float32),
        atlas=rng.uniform(0.0, 1.0, (N, F, R, R, C)).astype(np.float32),
        feats=rng.uniform(0.0, 1.0, (N, V, C)).astype(np.float32),
        faces=rng.integers(0, V, (N * F, 3)).astype(np.int64) + np.repeat(np.arange(N) * V, F)[:, None],
    )


def _fragments(seed=1, H=5, W=6, K=3):
    """Per-image packed ids (a quarter empty) and barycentrics, some
    negative, as numpy."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, F, (N, H, W, K)) + (np.arange(N) * F)[:, None, None, None]
    pix = np.where(rng.uniform(size=pix.shape) < 0.25, -1, pix).astype(np.int64)
    bary = rng.uniform(-0.1, 1.0, (N, H, W, K, 3)).astype(np.float32)
    bary = bary / bary.sum(-1, keepdims=True)
    bary = np.where((pix >= 0)[..., None], bary, -1.0).astype(np.float32)
    return pix, bary


def _both(kind, a, **uv):
    """The same texture in both packages."""
    if kind == "uv":
        j = jtex.TexturesUV.create(jnp.asarray(a["maps"]), jnp.asarray(a["faces_uvs"]), jnp.asarray(a["verts_uvs"]), **uv)
        t = convert.textures_uv_from_numpy(a["maps"], a["faces_uvs"], a["verts_uvs"], device=CPU, **uv)
    elif kind == "atlas":
        j = jtex.TexturesAtlas.create(jnp.asarray(a["atlas"]))
        t = convert.textures_atlas_from_numpy(a["atlas"], device=CPU)
    else:
        j = jtex.TexturesVertex.create(jnp.asarray(a["feats"]))
        t = convert.textures_vertex_from_numpy(a["feats"], device=CPU)
    return j, t


def _fields(tex):
    """The padded arrays of a texture of either package, as numpy."""
    names = {"TexturesUV": ("_maps_padded", "_faces_uvs_padded", "_verts_uvs_padded"),
             "TexturesAtlas": ("_atlas_padded",), "TexturesVertex": ("_verts_features_padded",)}
    return [np.asarray(getattr(tex, n).detach() if isinstance(getattr(tex, n), torch.Tensor) else getattr(tex, n))
            for n in names[type(tex).__name__]]


def _assert_same(t, j, atol=0.0):
    assert type(t).__name__ == type(j).__name__
    for a, b in zip(_fields(t), _fields(j)):
        np.testing.assert_allclose(a, b, atol=atol)


UV_MODES = [
    dict(),  # bilinear, border, align_corners (the defaults)
    dict(padding_mode="zeros", align_corners=False),
    dict(sampling_mode="nearest"),
    dict(padding_mode="reflection"),  # zeros in JAX
]


@pytest.mark.parametrize("kind,uv", [("uv", m) for m in UV_MODES] + [("atlas", {}), ("vertex", {})])
def test_sample_textures_matches_jax(kind, uv):
    """Texels within 1e-6; gradients with respect to the texture's values
    and to the barycentrics within 1e-5."""
    a = _arrays()
    pix, bary = _fragments()
    j, t = _both(kind, a, **uv)
    values = {"uv": "_maps_padded", "atlas": "_atlas_padded", "vertex": "_verts_features_padded"}[kind]
    faces = a["faces"]
    rng = np.random.default_rng(2)

    def jfn(x, b):
        frags = JFragments(pix_to_face=jnp.asarray(pix), zbuf=b[..., 0], bary_coords=b, dists=b[..., 0])
        return j.replace(**{values: x}).sample_textures(frags, faces_packed=jnp.asarray(faces))

    want, vjp = jax.vjp(jfn, getattr(j, values), jnp.asarray(bary))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    want_gx, want_gb = vjp(jnp.asarray(ct))

    x = getattr(t, values).clone().requires_grad_(True)
    b = torch.from_numpy(bary).requires_grad_(True)
    frags = Fragments(pix_to_face=torch.from_numpy(pix), zbuf=b[..., 0], bary_coords=b, dists=b[..., 0])
    got = t.replace(**{values: x}).sample_textures(frags, faces_packed=torch.from_numpy(faces))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_gx), atol=1e-5)
    gb = np.zeros_like(bary) if b.grad is None else b.grad.numpy()  # the atlas indexes by bary only
    np.testing.assert_allclose(gb, np.asarray(want_gb), atol=1e-5)


@pytest.mark.parametrize("kind", ["uv", "atlas", "vertex"])
def test_faces_verts_textures_packed_matches_jax(kind):
    a = _arrays(3)
    j, t = _both(kind, a)
    if kind == "vertex":
        want, got = j.faces_verts_textures_packed(jnp.asarray(a["faces"])), t.faces_verts_textures_packed(torch.from_numpy(a["faces"]))
    else:
        want, got = j.faces_verts_textures_packed(), t.faces_verts_textures_packed()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kind", ["uv", "atlas", "vertex"])
def test_extend_and_getitem_match_jax(kind):
    """extend(3) then a tensor index, an int and a slice: the same arrays;
    extend then taking every third entry gives back the texture."""
    a = _arrays(4)
    j, t = _both(kind, a)
    je, te = j.extend(3), t.extend(3)
    _assert_same(te, je)
    _assert_same(te[torch.tensor([1, 4])], je[jnp.asarray([1, 4])])
    _assert_same(te[5], je[5])
    _assert_same(te[1:4], je[1:4])
    _assert_same(te[torch.arange(0, 2 * 3, 3)], t)
    with pytest.raises(ValueError):
        t.extend(0)


def _lists(seed, kind):
    """Two meshes of different sizes, as lists."""
    rng = np.random.default_rng(seed)
    fs, vs = (7, 12), (5, 9)
    if kind == "uv":
        return dict(
            maps=[rng.uniform(size=(6, 6, C)).astype(np.float32) for _ in fs],
            faces_uvs=[rng.integers(0, v, (f, 3)).astype(np.int32) for f, v in zip(fs, vs)],
            verts_uvs=[rng.uniform(size=(v, 2)).astype(np.float32) for v in vs],
        )
    if kind == "atlas":
        return dict(atlas=[rng.uniform(size=(f, R, R, C)).astype(np.float32) for f in fs])
    return dict(feats=[rng.uniform(size=(v, C)).astype(np.float32) for v in vs])


def _both_lists(kind, lists):
    if kind == "uv":
        return (jtex.TexturesUV.create(**{k: [jnp.asarray(x) for x in v] for k, v in lists.items()}),
                convert.textures_uv_from_numpy(lists["maps"], lists["faces_uvs"], lists["verts_uvs"], device=CPU))
    if kind == "atlas":
        return jtex.TexturesAtlas.create([jnp.asarray(x) for x in lists["atlas"]]), convert.textures_atlas_from_numpy(lists["atlas"], device=CPU)
    return jtex.TexturesVertex.create([jnp.asarray(x) for x in lists["feats"]]), convert.textures_vertex_from_numpy(lists["feats"], device=CPU)


@pytest.mark.parametrize("kind", ["uv", "atlas", "vertex"])
def test_list_accessors_and_submeshes_match_jax(kind):
    """The per-mesh lists unpad to the created sizes; submeshes keep the
    chosen faces (UV rows reindexed to the used verts_uvs)."""
    j, t = _both_lists(kind, _lists(5, kind))
    names = {"uv": ("faces_uvs_list", "verts_uvs_list", "maps_list"), "atlas": ("atlas_list",),
             "vertex": ("verts_features_list",)}[kind]
    for name in names:
        for x, y in zip(getattr(t, name)(), getattr(j, name)()):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    vids = [[np.array([0, 2, 3])], [np.array([1, 4]), np.array([0, 5, 6, 8])]]
    fids = [[np.array([0, 2, 3])], [np.array([1, 4]), np.array([0, 5, 6, 8])]]
    js, ts = j.submeshes(vids, fids), t.submeshes(vids, fids)
    _assert_same(ts, js)


@pytest.mark.parametrize("kind", ["uv", "atlas", "vertex"])
def test_join_batch_and_join_scene_match_jax(kind):
    a, b = _both_lists(kind, _lists(6, kind)), _both(kind, _arrays(7))
    jb = type(a[0]).join_batch([a[0], b[0]])
    tb = type(a[1]).join_batch([a[1], b[1]])
    _assert_same(tb, jb)
    order = np.random.default_rng(8).permutation(3 * 12 if kind != "vertex" else 1)
    kw = {} if kind == "vertex" else dict(face_order=order)
    _assert_same(tb.join_scene(**{k: torch.from_numpy(v) for k, v in kw.items()}),
                 jb.join_scene(**{k: jnp.asarray(v) for k, v in kw.items()}), atol=1e-7)


def test_centers_for_image_matches_jax():
    lists = _lists(9, "uv")
    lists = {k: v[:1] for k, v in lists.items()}
    j, t = _both_lists("uv", lists)
    np.testing.assert_allclose(t.centers_for_image(0).numpy(), np.asarray(j.centers_for_image(0)), atol=1e-6)
    with pytest.raises(ValueError):
        _both_lists("uv", _lists(9, "uv"))[1].centers_for_image(0)


def test_textures_factory():
    a = _arrays(10)
    with pytest.warns(PendingDeprecationWarning):
        uv = Textures(maps=a["maps"], faces_uvs=a["faces_uvs"], verts_uvs=a["verts_uvs"], device=CPU)
    with pytest.warns(PendingDeprecationWarning):
        vert = Textures(verts_rgb=a["feats"], device=CPU)
    assert isinstance(uv, TexturesUV) and isinstance(vert, TexturesVertex)
    assert uv.padding_mode == "border" and uv.align_corners is True
    with pytest.warns(PendingDeprecationWarning), pytest.raises(ValueError):
        Textures(maps=a["maps"], device=CPU)


@pytest.mark.parametrize("make", [
    lambda: TexturesVertex.create(np.ones((4, 3), np.float32), device=CPU),
    lambda: TexturesAtlas.create(np.ones((1, 4, 4), np.float32), device=CPU),
    lambda: TexturesUV.create(np.ones((8, 8, 3), np.float32), np.zeros((1, 2, 3), np.int64),
                              np.ones((1, 4, 2), np.float32), device=CPU),
    lambda: TexturesUV.create(np.ones((2, 8, 8, 3), np.float32), np.zeros((1, 2, 3), np.int64),
                              np.ones((1, 4, 2), np.float32), device=CPU),
], ids=["vertex_rank", "atlas_rank", "uv_rank", "uv_batch"])
def test_create_errors(make):
    """tests/test_texturing_edges.py:163-200's TestErrors, in the port."""
    with pytest.raises(ValueError):
        make()


def test_pack_rectangles_match_jax():
    rng = np.random.default_rng(11)
    sizes = [tuple(int(x) for x in rng.integers(1, 30, 2)) for _ in range(9)]
    assert tutils.pack_rectangles(sizes) == jutils.pack_rectangles(sizes)
    rects = [tutils.Rectangle(w, h, i % 4) for i, (w, h) in enumerate(sizes)]
    jrects = [jutils.Rectangle(w, h, i % 4) for i, (w, h) in enumerate(sizes)]
    assert tutils.pack_unique_rectangles(rects) == jutils.pack_unique_rectangles(jrects)
    with pytest.raises(ValueError):
        tutils.pack_rectangles(sizes[:1])
