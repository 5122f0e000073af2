"""The rest of the port's `Meshes`, the join functions, the structures'
list / padded / packed conversions and `checkerboard` against the JAX
package; and the slice as a whole: PyTorch3D's joined spheres rendered
through both packages, and one step of a pose fit through `se3_exp_map`.

Inputs are seeded numpy arrays handed to both packages (the port on the
CPU); values agree to 1e-5 relative unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer as jr
import pytorch3d_tpu.structures as js
import pytorch3d_tpu.transforms as jt
from pytorch3d_tpu.renderer.mesh.textures import TexturesAtlas as JAtlas
from pytorch3d_tpu.renderer.mesh.textures import TexturesUV as JUV
from pytorch3d_tpu.renderer.mesh.textures import TexturesVertex as JVertex
from pytorch3d_tpu.utils import checkerboard as j_checkerboard
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import convert
from pytorch3d_tpu_torch import renderer as tr
from pytorch3d_tpu_torch import structures as ts
from pytorch3d_tpu_torch import transforms as tt
from pytorch3d_tpu_torch.utils import checkerboard, ico_sphere

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-5
a = np.asarray


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hetero(seed=0, sizes=((7, 9), (4, 3), (10, 12))):
    rng = np.random.default_rng(seed)
    verts = [rng.normal(size=(v, 3)).astype(np.float32) for v, _ in sizes]
    faces = [rng.integers(0, v, size=(f, 3)).astype(np.int32) for v, f in sizes]
    return verts, faces


def _both(verts, faces, tex=None):
    jm = js.Meshes.create([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces])
    tm = ts.Meshes.create(verts, faces, device=CPU)
    if tex is not None:
        jt_, tt_ = tex
        jm, tm = jm.replace(textures=jt_), tm.replace(textures=tt_)
    return jm, tm


def _same_mesh(tm, jm):
    for name in ("verts_padded", "faces_padded", "num_verts_per_mesh", "num_faces_per_mesh"):
        np.testing.assert_array_equal(_np(getattr(tm, name)()), a(getattr(jm, name)()), err_msg=name)


@pytest.mark.parametrize("fn", ["list_to_packed", "packed_to_list", "padded_to_list", "padded_to_packed"])
def test_structures_utils_match_jax(fn):
    rng = np.random.default_rng(1)
    items = [rng.normal(size=(n, 2)).astype(np.float32) for n in (3, 1, 5)]
    padded = rng.normal(size=(3, 5, 2)).astype(np.float32)
    padded[1, 2:] = -7.0
    if fn == "list_to_packed":
        got = ts.list_to_packed([torch.from_numpy(x) for x in items])
        want = js.list_to_packed([jnp.asarray(x) for x in items])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), a(w))
    elif fn == "packed_to_list":
        packed = np.concatenate(items)
        for split in ([3, 1, 5], 3):
            got = ts.packed_to_list(torch.from_numpy(packed), split)
            want = js.packed_to_list(jnp.asarray(packed), split)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), a(w))
    elif fn == "padded_to_list":
        for split in (None, [2, 5, 1], [(2, 1), (5, 2), (1, 1)]):
            got = ts.padded_to_list(torch.from_numpy(padded), split)
            want = js.padded_to_list(jnp.asarray(padded), split)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), a(w))
        with pytest.raises(ValueError):
            ts.padded_to_list(torch.from_numpy(padded), [1, 2])
    else:
        for kw in (dict(), dict(split_size=[2, 5, 1]), dict(pad_value=-7.0)):
            got = ts.padded_to_packed(torch.from_numpy(padded), **kw)
            np.testing.assert_array_equal(_np(got), a(js.padded_to_packed(jnp.asarray(padded), **kw)))
        moved = np.ascontiguousarray(padded.transpose(0, 2, 1))
        np.testing.assert_array_equal(
            _np(ts.padded_to_packed(torch.from_numpy(moved), split_size=[1, 2, 2], max_size_dim=2)),
            a(js.padded_to_packed(jnp.asarray(moved), split_size=[1, 2, 2], max_size_dim=2)))
        with pytest.raises(ValueError):
            ts.padded_to_packed(torch.from_numpy(padded), split_size=[1, 1, 1], pad_value=0.0)


def _textures(kind, verts, faces, seed=2):
    """The same per-mesh textures in both packages."""
    rng = np.random.default_rng(seed)
    if kind == "vertex":
        feats = [rng.uniform(size=(len(v), 3)).astype(np.float32) for v in verts]
        return JVertex.create([jnp.asarray(f) for f in feats]), convert.textures_vertex_from_numpy(feats, device=CPU)
    if kind == "atlas":
        atlas = [rng.uniform(size=(len(f), 2, 2, 3)).astype(np.float32) for f in faces]
        return JAtlas.create([jnp.asarray(x) for x in atlas]), convert.textures_atlas_from_numpy(atlas, device=CPU)
    maps = rng.uniform(size=(len(verts), 6, 8, 3)).astype(np.float32)
    vuv = [rng.uniform(size=(len(v) + 2, 2)).astype(np.float32) for v in verts]
    fuv = [rng.integers(0, len(x), size=(len(f), 3)).astype(np.int32) for x, f in zip(vuv, faces)]
    j = JUV.create(jnp.asarray(maps), [jnp.asarray(f) for f in fuv], [jnp.asarray(x) for x in vuv])
    return j, convert.textures_uv_from_numpy(maps, fuv, vuv, device=CPU)


def _texture_tensors(tex):
    fields = [f for f in vars(tex) if not f.startswith("_num")]
    return {f: getattr(tex, f) for f in fields if hasattr(getattr(tex, f), "shape")}


@pytest.mark.parametrize("kind", ["vertex", "atlas", "uv"])
def test_join_meshes_as_scene_matches_jax(kind):
    """The scene of a list: all N*V padded verts, the real faces first in
    packed order (a stable sort of the inverted mask), and per-face texture
    data in the same order, as the JAX package's."""
    verts, faces = _hetero()
    jtex, ttex = _textures(kind, verts, faces)
    parts = [(_both([v], [f], (jtex[i], ttex[i]))) for i, (v, f) in enumerate(zip(verts, faces))]
    jscene = js.join_meshes_as_scene([p[0] for p in parts])
    tscene = ts.join_meshes_as_scene([p[1] for p in parts])
    _same_mesh(tscene, jscene)
    for name, value in _texture_tensors(jscene.textures).items():
        np.testing.assert_allclose(_np(getattr(tscene.textures, name)), a(value), rtol=RTOL, atol=ATOL, err_msg=name)
    # a batch joins the same way; without textures when asked
    jb, tb = _both(verts, faces, (jtex, ttex))
    _same_mesh(ts.join_meshes_as_scene(tb, include_textures=False), js.join_meshes_as_scene(jb))
    assert ts.join_meshes_as_scene(tb, include_textures=False).textures is None


def test_join_meshes_as_batch_matches_jax():
    verts, faces = _hetero()
    _, ttex = _textures("vertex", verts, faces)
    jtex = JVertex.create(jnp.asarray(_np(ttex.verts_features_padded())))  # padded: JAX's batch indexing
    jm, tm = _both(verts, faces, (jtex, ttex))
    jb = js.join_meshes_as_batch([jm[0], jm[1:], jm[2]])
    tb = ts.join_meshes_as_batch([tm[0], tm[1:], tm[2]])
    _same_mesh(tb, jb)
    np.testing.assert_array_equal(_np(tb.textures.verts_features_padded()), a(jb.textures.verts_features_padded()))
    with pytest.raises(ValueError):
        ts.join_meshes_as_batch(tm)


def test_meshes_rest_matches_jax():
    verts, faces = _hetero(3)
    jm, tm = _both(verts, faces)
    N, V = len(tm), tm.max_verts
    offs = np.random.default_rng(4).normal(size=(N * V, 3)).astype(np.float32)
    pairs = [
        (tm.offset_verts(torch.from_numpy(offs)), jm.offset_verts(jnp.asarray(offs))),
        (tm.offset_verts(torch.tensor([0.5, -1.0, 2.0])), jm.offset_verts(jnp.asarray([0.5, -1.0, 2.0]))),
        (tm.scale_verts(2.5), jm.scale_verts(2.5)),
        (tm.scale_verts(torch.tensor([1.0, 2.0, 3.0])), jm.scale_verts(jnp.asarray([1.0, 2.0, 3.0]))),
    ]
    for t, j in pairs:
        _same_mesh(t, j)
    np.testing.assert_array_equal(_np(tm.get_bounding_boxes()), a(jm.get_bounding_boxes()))
    for name in ("verts_normals_list", "faces_normals_list"):
        for g, w in zip(getattr(tm, name)(), getattr(jm, name)()):
            np.testing.assert_allclose(_np(g), a(w), rtol=RTOL, atol=ATOL, err_msg=name)
    for i in range(N):
        for g, w in zip(tm.get_mesh_verts_faces(i), jm.get_mesh_verts_faces(i)):
            np.testing.assert_array_equal(_np(g), a(w))
    with pytest.raises(ValueError):
        tm.get_mesh_verts_faces(N)
    for t, j in zip(tm.split([1, 2]), jm.split([1, 2])):
        _same_mesh(t, j)
    with pytest.raises(ValueError):
        tm.split([1, 1])
    np.testing.assert_array_equal(_np(tm.verts_padded_to_packed_idx()), a(jm.verts_padded_to_packed_idx()))
    np.testing.assert_array_equal(_np(tm.mesh_to_edges_packed_first_idx()), a(jm.mesh_to_edges_packed_first_idx()))
    assert tm.has_verts_normals() and tm.check_shapes()
    bad = tm.replace(_num_verts_per_mesh=tm.num_verts_per_mesh() + 100)
    with pytest.raises(ValueError):
        bad.check_shapes()


def test_meshes_in_place_clone_detach_to():
    """`offset_verts_` / `scale_verts_` change the vertex tensor in place and
    return the same object; clone, detach and to copy the textures too."""
    verts, faces = _hetero(5)
    jtex, ttex = _textures("vertex", verts, faces)
    jm, tm = _both(verts, faces, (jtex, ttex))
    out = tm.offset_verts_(torch.tensor([1.0, 2.0, 3.0])).scale_verts_(0.5)
    assert out is tm
    _same_mesh(tm, jm.offset_verts_(jnp.asarray([1.0, 2.0, 3.0])).scale_verts_(0.5))
    c = tm.clone()
    assert c.verts_padded().data_ptr() != tm.verts_padded().data_ptr()
    assert c.textures.verts_features_padded().data_ptr() != tm.textures.verts_features_padded().data_ptr()
    _same_mesh(c, jm.offset_verts(jnp.asarray([1.0, 2.0, 3.0])).scale_verts(0.5))
    v = tm.verts_padded().clone().requires_grad_(True)
    assert not tm.update_padded(v).detach().verts_padded().requires_grad
    moved = tm.to("cpu")
    assert moved.device.type == "cpu" and tm.cpu().textures is not None


def test_submeshes_matches_jax():
    verts, faces = _hetero(6, sizes=((9, 10), (8, 7)))
    jm, tm = _both(verts, faces)
    sel = [[np.array([0, 3, 4]), np.array([9, 1])], [np.array([2, 5, 6, 0])]]
    _same_mesh(tm.submeshes(sel), jm.submeshes(sel))
    with pytest.raises(ValueError):
        tm.submeshes(sel[:1])


def test_laplacian_packed_matches_jax():
    jm = j_ico_sphere(1).extend(2)
    tm = ico_sphere(1, device=CPU).extend(2)
    got = tm.laplacian_packed().to_dense()
    np.testing.assert_allclose(_np(got), a(jm.laplacian_packed().todense()), rtol=RTOL, atol=ATOL)


def test_checkerboard_matches_jax():
    jm, tm = j_checkerboard(2, (0.1, 0.2, 0.3), (0.9, 0.8, 0.7)), checkerboard(2, (0.1, 0.2, 0.3), (0.9, 0.8, 0.7),
                                                                               device=CPU)
    _same_mesh(tm, jm)
    np.testing.assert_array_equal(_np(tm.textures.atlas_padded()), a(jm.textures.atlas_padded()))


# --------------------------------------------------------------------------- #
# The slice as a whole
# --------------------------------------------------------------------------- #

SIZE = 64


def _joined_spheres(pkg_ico, pkg_meshes, pkg_join, pkg_vertex, asarray, **kw):
    """PyTorch3D's tests/test_render_meshes.py:1171 scene: ico_sphere(3) x0.25
    shifted +1.2 in x and ico_sphere(4) shifted -0.3, joined as a scene,
    white vertex colours."""
    parts = []
    for level, scale, off in ((3, 0.25, 1.2), (4, 1.0, -0.3)):
        sph = pkg_ico(level, **kw)
        v = np.asarray(_np(sph.verts_padded()))[0] * np.float32(scale)
        v[:, 0] += np.float32(off)
        parts.append(pkg_meshes.create([asarray(v)], [sph.faces_padded()[0]], **kw))
    scene = pkg_join(parts)
    return scene.replace(textures=pkg_vertex.create(np.ones(tuple(scene.verts_padded().shape), np.float32), **kw))


@pytest.fixture(scope="module")
def joined():
    jscene = _joined_spheres(j_ico_sphere, js.Meshes, js.join_meshes_as_scene, JVertex, jnp.asarray)
    tscene = _joined_spheres(ico_sphere, ts.Meshes, ts.join_meshes_as_scene, tr.TexturesVertex, torch.from_numpy,
                             device=CPU)
    return jscene, tscene


def _render(pkg, scene, R, T, K=1, blur=0.0, **kw):
    cams = pkg.FoVPerspectiveCameras.create(R=R, T=T, **kw)
    lights = pkg.PointLights.create(location=((0.0, 0.0, 2.0),), **kw)
    settings = pkg.RasterizationSettings(image_size=SIZE, blur_radius=blur, faces_per_pixel=K)
    shader = (pkg.HardPhongShader if K == 1 else pkg.SoftPhongShader)(
        cameras=cams, lights=lights, blend_params=pkg.BlendParams(0.5, 1e-4, (0.0, 0.0, 0.0)), **kw)
    return pkg.MeshRenderer(pkg.MeshRasterizer(cams, settings), shader)(scene.extend(len(R)))


def test_slice_joined_spheres_and_pose_fit_step_match_jax(joined):
    """The slice end to end at 64^2: the joined scene (verts, faces and
    colours equal to JAX's) rendered through both packages (JAX jitted) with
    SoftPhongShader (K=4, blur 1e-4) from azimuth 0 (a pose exact in
    float32); the images agree within 1e-5.  Then one step of the pose
    fit: a (1, 6) se3 log at zero, composed with the initial world-to-view
    pose through se3_exp_map, against targets rendered 0.05 off: the loss
    within 1e-5 and its gradient with respect to the log within 1e-4 of its
    largest entry."""
    jscene, tscene = joined
    _same_mesh(tscene, jscene)
    R0, T0 = jr.look_at_view_transform(2.7, 0.0, 0.0)
    M0 = jt.Rotate(R0).compose(jt.Translate(T0)).get_matrix()
    delta = np.random.RandomState(0).uniform(-0.05, 0.05, (1, 6)).astype(np.float32)

    def pose(exp_map, M, log):
        M = M @ exp_map(log)
        return M[:, :3, :3], M[:, 3, :3]

    def jloss(log, target):
        image = _render(jr, jscene, *pose(jt.se3_exp_map, M0, log), K=4, blur=1e-4)
        return jnp.mean((image[..., :3] - target) ** 2), image

    step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    target = np.array(step(jnp.asarray(delta), jnp.zeros((1, SIZE, SIZE, 3)))[0][1])[..., :3]
    (jl, jimage), jg = step(jnp.zeros((1, 6), jnp.float32), jnp.asarray(target))
    log = torch.zeros((1, 6), requires_grad=True)
    image = _render(tr, tscene, *pose(tt.se3_exp_map, torch.from_numpy(np.array(M0)), log), K=4, blur=1e-4,
                    device=CPU)
    loss = torch.mean((image[..., :3] - torch.from_numpy(target)) ** 2)
    loss.backward()
    assert float((a(jimage)[..., 3] > 0).mean()) > 0.1
    np.testing.assert_allclose(_np(image), a(jimage), rtol=0, atol=1e-5)
    assert float(jl) > 0 and np.isfinite(_np(log.grad)).all()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(log.grad), a(jg), rtol=0, atol=1e-4 * float(np.abs(a(jg)).max()))
