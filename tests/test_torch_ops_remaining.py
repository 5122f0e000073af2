"""Cubify, marching cubes, box IoU, subdivision, vert align, graph
convolution and Taubin smoothing: the port against the JAX package on the
CPU, on the same seeded numpy inputs (or the same flax weights).

Tolerances:
- cubify, subdivision: faces equal; vertices and features within 1e-6
  (the same float32 operations);
- marching cubes: faces equal, vertices within 1e-5 in grid and local
  coordinates (the same interpolation; division may round otherwise);
- box IoU: volume and IoU within 1e-5 (the same clipping, sums taken in
  another order);
- vert align, GraphConv, gather_scatter, Taubin smoothing: within 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.ops as jops
import pytorch3d_tpu.ops.iou_box3d as jiou3d
from pytorch3d_tpu.renderer.points import rasterize_points_python as j_rasterize_points_python
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import ops as tops
from pytorch3d_tpu_torch.ops import graph_conv as tgraph
from pytorch3d_tpu_torch.convert import graph_conv_state_dict_from_flax, meshes_from_numpy, pointclouds_from_numpy
from pytorch3d_tpu_torch.renderer.points import rasterize_points, rasterize_points_python

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

jmc = importlib.import_module("pytorch3d_tpu.ops.marching_cubes")  # the package binds the function to this name


@pytest.fixture(autouse=True)
def _two_threads():
    """Beside other test processes on the machine's cores, torch's full
    thread pool makes these small tensors' ops tens of times slower (the
    train_nerf test took 382 s in a 6-worker run against 6 s alone); two
    threads keep them near their time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _mesh_batch(levels):
    """Padded numpy verts / faces / counts of ico spheres at `levels`."""
    meshes = [j_ico_sphere(level) for level in levels]
    verts = [np.asarray(m.verts_padded()[0]) for m in meshes]
    faces = [np.asarray(m.faces_padded()[0]) for m in meshes]
    return verts, faces


def _both_meshes(verts, faces):
    return JMeshes.create([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces]), meshes_from_numpy(
        verts, faces, device="cpu"
    )


def _same_meshes(jm, tm, atol):
    np.testing.assert_array_equal(_np(tm.num_verts_per_mesh()), np.asarray(jm.num_verts_per_mesh()))
    np.testing.assert_array_equal(_np(tm.num_faces_per_mesh()), np.asarray(jm.num_faces_per_mesh()))
    np.testing.assert_array_equal(_np(tm.faces_padded()), np.asarray(jm.faces_padded()))
    np.testing.assert_allclose(_np(tm.verts_padded()), np.asarray(jm.verts_padded()), rtol=0, atol=atol)


@pytest.mark.parametrize("align", ["topleft", "corner", "center"])
def test_cubify_matches_jax(align):
    rng = np.random.default_rng(0)
    vox = rng.random((2, 6, 6, 6)).astype(np.float32)
    feats = rng.random((2, 3, 6, 6, 6)).astype(np.float32)
    jm = jax.jit(lambda v, f: jops.cubify(v, 0.5, feats=f, align=align))(jnp.asarray(vox), jnp.asarray(feats))
    tm = tops.cubify(torch.tensor(vox), 0.5, feats=torch.tensor(feats), align=align)
    _same_meshes(jm, tm, 1e-6)
    if align == "center":
        np.testing.assert_allclose(_np(tm.textures.atlas_padded()), np.asarray(jm.textures.atlas_padded()), atol=0)


def _sphere_sdf(n):
    g = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) - 0.6).astype(np.float32)


@pytest.mark.parametrize("volume", ["sphere", "on isolevel"])
def test_marching_cubes_matches_jax(volume, monkeypatch):
    if volume == "sphere":
        vols, iso = _sphere_sdf(12)[None], 0.0
    else:
        # Values on a 1/4 grid around the isolevel 0.5: many corners sit on
        # it exactly, which takes the eps snap and merges snapped vertices.
        vols = (np.random.default_rng(1).integers(0, 5, (1, 8, 8, 8)) / 4.0).astype(np.float32)
        iso = 0.5
    # JAX's own function, with its per-volume body jitted (eager, each call
    # takes seconds).
    monkeypatch.setattr(jmc, "_mc_one", jax.jit(jmc._mc_one, static_argnums=(1,)))
    for local in (True, False):
        jv, jf = jops.marching_cubes(jnp.asarray(vols), iso, return_local_coords=local)
        tv, tf = tops.marching_cubes(torch.tensor(vols), iso, return_local_coords=local)
        nv, nf = tops.marching_cubes_naive(torch.tensor(vols), iso, return_local_coords=local)
        assert len(tv) == len(jv) == 1 and tf[0].shape[0] > 0
        np.testing.assert_array_equal(_np(tf[0]), np.asarray(jf[0]))
        np.testing.assert_allclose(_np(tv[0]), np.asarray(jv[0]), rtol=0, atol=1e-5)
        assert torch.equal(nv[0], tv[0]) and torch.equal(nf[0], tf[0])


_UNIT = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                 np.float32)


def _boxes(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q = q * np.sign(np.linalg.det(q))[:, None, None]
    size = rng.uniform(0.5, 1.5, (n, 1, 3))
    centre = rng.uniform(-0.5, 0.5, (n, 1, 3))
    return (((_UNIT - 0.5) * size) @ q + centre).astype(np.float32)


def test_box3d_overlap_matches_jax(monkeypatch):
    rng = np.random.default_rng(2)
    b1, b2 = _boxes(rng, 8), _boxes(rng, 8)  # 64 random pairs
    # Identical, touching (sharing the face x = 1) and disjoint boxes.
    b1 = np.concatenate([b1, _UNIT[None], _UNIT[None], _UNIT[None]])
    b2 = np.concatenate([b2, _UNIT[None], (_UNIT + [1.0, 0.0, 0.0])[None], (_UNIT + [3.0, 0.0, 0.0])[None]])
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    monkeypatch.setattr(jiou3d, "_pair_intersection_volume", jax.jit(jiou3d._pair_intersection_volume))
    jvol, jiou = jops.box3d_overlap(jnp.asarray(b1), jnp.asarray(b2))
    tvol, tiou = tops.box3d_overlap(torch.tensor(b1), torch.tensor(b2))
    np.testing.assert_allclose(_np(tvol), np.asarray(jvol), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tiou), np.asarray(jiou), rtol=0, atol=1e-5)
    assert float(tiou[8, 8]) == pytest.approx(1.0, abs=1e-5)
    # Two unit cubes sharing their x = 1 face: JAX's clipping counts 1/3
    # (the shared face from one side only; a box on the -x side gives 0),
    # and the port holds to it (ROADMAP "Known faults of the reference").
    assert float(tvol[9, 9]) == pytest.approx(1.0 / 3.0, abs=1e-5) and float(tvol[10, 10]) == 0.0
    assert float((tiou[:8, :8] > 0).float().mean()) > 0.3  # the random pairs overlap often
    # The same fault far from the origin: the kept face adds c * area / 3,
    # c its coordinate along its normal, in either order and on either
    # side, so touching cubes whose shared face lies at x = +-100 get a
    # volume of 100/3 and, with the union clamped to 1e-12, an IoU of ~3e13.
    far1 = np.stack([_UNIT + [99.0, 0.0, 0.0], _UNIT + [100.0, 0.0, 0.0], _UNIT - [100.0, 0.0, 0.0]])
    far2 = np.stack([_UNIT + [100.0, 0.0, 0.0], _UNIT + [99.0, 0.0, 0.0], _UNIT - [101.0, 0.0, 0.0]])
    far1, far2 = far1.astype(np.float32), far2.astype(np.float32)
    jvol, jiou = jops.box3d_overlap(jnp.asarray(far1), jnp.asarray(far2))
    tvol, tiou = tops.box3d_overlap(torch.tensor(far1), torch.tensor(far2))
    tvol, tiou, jvol, jiou = (np.diagonal(_np(a)) for a in (tvol, tiou, jvol, jiou))
    np.testing.assert_allclose(tvol, jvol, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tiou, jiou, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tvol, 100.0 / 3.0, rtol=0, atol=1e-5)
    assert (tiou > 1e13).all()


def test_subdivide_meshes_matches_jax():
    verts, faces = _mesh_batch([1, 1, 0])  # the third mesh is padded
    rng = np.random.default_rng(3)
    V = max(v.shape[0] for v in verts)
    feats = rng.random((3 * V, 4)).astype(np.float32)
    jm, tm = _both_meshes(verts, faces)
    jnew, jfeats = jax.jit(lambda m, f: jops.SubdivideMeshes()(m, f))(jm, jnp.asarray(feats))
    tnew, tfeats = tops.SubdivideMeshes()(tm, torch.tensor(feats))
    _same_meshes(jnew, tnew, 1e-6)
    np.testing.assert_allclose(_np(tfeats), np.asarray(jfeats), rtol=0, atol=1e-6)
    _same_meshes(jax.jit(jops.SubdivideMeshes())(jm), tops.SubdivideMeshes()(tm), 1e-6)


def test_vert_align_matches_jax():
    rng = np.random.default_rng(4)
    verts = rng.uniform(-1.2, 1.2, (2, 50, 3)).astype(np.float32)
    feats = [rng.random((2, c, s, s)).astype(np.float32) for c, s in ((3, 16), (5, 8))]
    for maps, packed in ((feats, True), (feats[0], False)):
        j = jax.jit(lambda m, v: jops.vert_align(m, v, return_packed=packed))(
            [jnp.asarray(f) for f in maps] if isinstance(maps, list) else jnp.asarray(maps), jnp.asarray(verts))
        t = tops.vert_align([torch.tensor(f) for f in maps] if isinstance(maps, list) else torch.tensor(maps),
                            torch.tensor(verts), return_packed=packed)
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=1e-5)


def _edges_with_padding():
    verts, faces = _mesh_batch([1])
    jm, _ = _both_meshes(verts, faces)
    edges = np.asarray(jm.edges_packed())
    edges = edges[(edges >= 0).all(-1)]
    return verts[0], np.concatenate([edges, -np.ones((5, 2), edges.dtype)])


@pytest.mark.parametrize("directed", [False, True])
def test_gather_scatter_and_graph_conv_match_jax(directed):
    verts, edges = _edges_with_padding()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((verts.shape[0], 6)).astype(np.float32)
    j = jax.jit(lambda a, e: jops.gather_scatter(a, e, directed))(jnp.asarray(x), jnp.asarray(edges))
    for fn in (tops.gather_scatter, tops.gather_scatter_python):
        np.testing.assert_allclose(_np(fn(torch.tensor(x), torch.tensor(edges), directed)), np.asarray(j), atol=1e-5)
    np.testing.assert_allclose(_np(tgraph.GatherScatter(directed)(torch.tensor(x), torch.tensor(edges))),
                               np.asarray(j), atol=1e-5)

    jconv = jops.GraphConv(6, 4, directed=directed)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(edges))
    # Non-zero biases, so that the conversion of every leaf shows.
    params = jax.tree_util.tree_map(lambda a: a + 0.1 if a.ndim == 1 else a * 10.0, params)
    tconv = tops.GraphConv(6, 4, directed=directed, device="cpu")
    tconv.load_state_dict(graph_conv_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    want = jax.jit(jconv.apply)(params, jnp.asarray(x), jnp.asarray(edges))
    np.testing.assert_allclose(_np(tconv(torch.tensor(x), torch.tensor(edges))), np.asarray(want), atol=1e-5)


def test_taubin_smoothing_matches_jax():
    verts, faces = _mesh_batch([2, 1])
    rng = np.random.default_rng(6)
    verts = [(v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32) for v in verts]
    jm, tm = _both_meshes(verts, faces)
    jout = jax.jit(lambda m: jops.taubin_smoothing(m, num_iter=3))(jm)
    tout = tops.taubin_smoothing(tm, num_iter=3)
    np.testing.assert_allclose(_np(tout.verts_padded()), np.asarray(jout.verts_padded()), rtol=0, atol=1e-5)
    assert float((tout.verts_padded() - tm.verts_padded()).abs().max()) > 1e-3  # it moved the vertices


def test_aliases_are_the_functions_they_name():
    rng = np.random.default_rng(7)
    pix = torch.tensor(rng.integers(-1, 10, (1, 4, 4, 2)))
    bary = torch.tensor(rng.random((1, 4, 4, 2, 3)).astype(np.float32))
    attrs = torch.tensor(rng.random((10, 3, 5)).astype(np.float32))
    assert torch.equal(tops.interpolate_face_attributes_python(pix, bary, attrs),
                       tops.interpolate_face_attributes(pix, bary, attrs))

    points = rng.uniform(-1, 1, (2, 60, 3)).astype(np.float32)
    points[..., 2] = np.abs(points[..., 2]) + 0.5
    cloud = pointclouds_from_numpy(points, device="cpu")
    got = rasterize_points_python(cloud, image_size=16, radius=0.2, points_per_pixel=3)
    for a, b in zip(got, rasterize_points(cloud, image_size=16, radius=0.2, points_per_pixel=3)):
        assert torch.equal(a, b)
    # ... and JAX's alias gives the same ids.
    jidx = jax.jit(lambda p: j_rasterize_points_python(JPointclouds.create(p), 16, 0.2, 3)[0])(jnp.asarray(points))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(jidx))
