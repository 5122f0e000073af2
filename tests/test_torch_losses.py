"""The port's mesh edges, losses, KNN, chamfer and point sampling against
the JAX package.

Inputs (an icosphere and a torus as one heterogeneous batch, with seeded
noise on the verts; point clouds) are made with numpy and handed to both
packages.  The port runs on the CPU, where its wrappers take the plain
versions; JAX's Pallas KNN kernel runs in interpret mode.  Tolerances:
integer layouts exactly; values rtol 1e-5 (float32 sums in another order);
gradients rtol 1e-4 with atol 1e-6 of the largest entry (per-vertex sums
of many terms that may cancel); KNN as stated at each test.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.ops.knn_pallas as jknn_pallas
from pytorch3d_tpu.loss import (
    chamfer_distance as j_chamfer,
    mesh_edge_loss as j_edge,
    mesh_laplacian_smoothing as j_laplacian,
    mesh_normal_consistency as j_normal,
)
from pytorch3d_tpu.ops.knn import knn_points as j_knn
from pytorch3d_tpu.ops.sample_points_from_meshes import sample_points_from_meshes as j_sample
from pytorch3d_tpu.renderer.mesh.textures import TexturesVertex as JTexturesVertex
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch.loss import (
    chamfer_distance,
    mesh_edge_loss,
    mesh_laplacian_smoothing,
    mesh_normal_consistency,
)
from pytorch3d_tpu_torch.ops import knn as tknn
from pytorch3d_tpu_torch.ops.sample_points_from_meshes import sample_points_with_draws
from pytorch3d_tpu_torch.renderer import TexturesVertex
from pytorch3d_tpu_torch.structures import Meshes

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")


def _hetero(seed=0, noise=0.05):
    """Verts and faces (lists of numpy) of ico_sphere(2) and a torus, verts
    moved by seeded noise so the losses have non-trivial gradients."""
    rng = np.random.default_rng(seed)
    meshes = [j_ico_sphere(2), j_torus(0.4, 0.9, 8, 12)]
    verts = [np.asarray(m.verts_padded()[0]) for m in meshes]
    verts = [(v + noise * rng.standard_normal(v.shape)).astype(np.float32) for v in verts]
    faces = [np.array(m.faces_padded()[0]) for m in meshes]
    return verts, faces


def _both(verts, faces):
    return JMeshes.create([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces]), Meshes.create(
        [np.array(v) for v in verts], [np.array(f) for f in faces], device=CPU
    )


def _close_grad(got, want):
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(want).max()))


# --------------------------------------------------------------------------- #
# Meshes: edges and extend
# --------------------------------------------------------------------------- #


def test_edges_match_jax_exactly():
    jm, tm = _both(*_hetero())
    for name in ("edges_packed", "edges_packed_mask", "faces_packed_to_edges_packed",
                 "edges_packed_to_mesh_idx", "num_edges_per_mesh", "num_edges"):
        want = np.asarray(getattr(jm, name)())
        got = getattr(tm, name)().numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tm.isempty() is False and Meshes.create([], [], device=CPU).isempty()


def test_extend_matches_jax():
    verts, faces = _hetero()
    colors = [np.full(v.shape, 0.25 * (i + 1), np.float32) for i, v in enumerate(verts)]
    jm = JMeshes.create([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces],
                        textures=JTexturesVertex.create([jnp.asarray(c) for c in colors]))
    tm = Meshes.create(verts, faces, textures=TexturesVertex.create(colors, device=CPU), device=CPU)
    je, te = jm.extend(3), tm.extend(3)
    assert len(te) == 6
    for name in ("verts_padded", "faces_padded", "num_verts_per_mesh", "num_faces_per_mesh"):
        np.testing.assert_array_equal(getattr(te, name)().numpy(), np.asarray(getattr(je, name)()), err_msg=name)
    np.testing.assert_array_equal(
        te.textures.verts_features_padded().numpy(), np.asarray(je.textures.verts_features_padded())
    )
    with pytest.raises(ValueError):
        tm.extend(0)


# --------------------------------------------------------------------------- #
# Mesh regularizers: values and vertex gradients
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["edge", "uniform", "cot", "cotcurv", "normal"])
def test_mesh_losses_and_gradients_match_jax(name):
    verts, faces = _hetero(seed=1)
    jm, tm = _both(verts, faces)
    j_fn, t_fn = {
        "edge": (j_edge, mesh_edge_loss),
        "uniform": (lambda m: j_laplacian(m, "uniform"), lambda m: mesh_laplacian_smoothing(m, "uniform")),
        "cot": (lambda m: j_laplacian(m, "cot"), lambda m: mesh_laplacian_smoothing(m, "cot")),
        "cotcurv": (lambda m: j_laplacian(m, "cotcurv"), lambda m: mesh_laplacian_smoothing(m, "cotcurv")),
        "normal": (j_normal, mesh_normal_consistency),
    }[name]
    want, gwant = jax.value_and_grad(lambda v: j_fn(jm.update_padded(v)))(jm.verts_padded())
    v = tm.verts_padded().clone().requires_grad_(True)
    got = t_fn(tm.update_padded(v))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_grad(v.grad.numpy(), gwant)


# --------------------------------------------------------------------------- #
# KNN
# --------------------------------------------------------------------------- #


def _clouds(seed, N=2, P1=60, P2=50, D=3):
    rng = np.random.default_rng(seed)
    return rng.random((N, P1, D), dtype=np.float32), rng.random((N, P2, D), dtype=np.float32)


_KNN_CASES = [
    # K, norm, lengths1, lengths2
    (1, 2, None, None),
    (4, 2, [60, 33], [50, 20]),
    (8, 1, None, [50, 5]),  # K > length2 for the second cloud
    (3, 1, [10, 60], None),
]


@pytest.mark.parametrize("K,norm,lengths1,lengths2", _KNN_CASES)
def test_knn_matches_jax_xla(K, norm, lengths1, lengths2):
    p1, p2 = _clouds(K + norm)
    l1 = None if lengths1 is None else np.asarray(lengths1)
    l2 = None if lengths2 is None else np.asarray(lengths2)
    want = j_knn(jnp.asarray(p1), jnp.asarray(p2), None if l1 is None else jnp.asarray(l1),
                 None if l2 is None else jnp.asarray(l2), norm=norm, K=K)
    got = tknn.knn_points(torch.from_numpy(p1), torch.from_numpy(p2),
                          None if l1 is None else torch.from_numpy(l1),
                          None if l2 is None else torch.from_numpy(l2), norm=norm, K=K)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    # JAX's XLA path expands |x|^2 + |y|^2 - 2xy, which cancels: 1e-5
    # relative (norm 2); the L1 sums agree to rounding.
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=1e-5, atol=1e-6)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode; nothing in
    the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jknn_pallas.pl, "pallas_call", patched)


@pytest.mark.parametrize("K,norm,length2", [(1, 2, None), (16, 2, 40), (4, 1, 3)])
def test_knn_matches_jax_pallas_kernel(interpret_pallas, K, norm, length2):
    p1, p2 = _clouds(5 * K + norm, N=1, P1=70, P2=50)
    l2 = None if length2 is None else jnp.int32(length2)
    want_d, want_i = jknn_pallas.knn_points_pallas_single(jnp.asarray(p1[0]), jnp.asarray(p2[0]), l2, K=K, norm=norm)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    if length2 is not None:  # slots past length2 are zero-filled, as knn.py:134-139 does
        pad = np.arange(K)[None, :] >= length2
        want_d, want_i = np.where(pad, 0.0, want_d), np.where(pad, 0, want_i)
    got = tknn.knn_points(torch.from_numpy(p1), torch.from_numpy(p2),
                          lengths2=None if length2 is None else torch.tensor([length2]), norm=norm, K=K)
    # The same direct sums in the same order and the same tie rule.
    np.testing.assert_array_equal(got.idx[0].numpy(), want_i)
    np.testing.assert_allclose(got.dists[0].numpy(), want_d, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("norm", [1, 2])
def test_knn_gradients_match_jax_xla(norm):
    p1, p2 = _clouds(norm)
    l1, l2 = np.asarray([60, 40]), np.asarray([50, 30])
    g = np.random.default_rng(9).standard_normal((2, 60, 3)).astype(np.float32)

    def j_loss(a, b):
        d = j_knn(a, b, jnp.asarray(l1), jnp.asarray(l2), norm=norm, K=3).dists
        return jnp.sum(d * jnp.asarray(g))

    gj1, gj2 = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(p1), jnp.asarray(p2))
    a, b = torch.from_numpy(p1).requires_grad_(True), torch.from_numpy(p2).requires_grad_(True)
    d = tknn.knn_points(a, b, torch.from_numpy(l1), torch.from_numpy(l2), norm=norm, K=3).dists
    torch.sum(d * torch.from_numpy(g)).backward()
    _close_grad(a.grad.numpy(), gj1)
    _close_grad(b.grad.numpy(), gj2)


# --------------------------------------------------------------------------- #
# Chamfer
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("point_reduction,batch_reduction,normals,weights,norm", [
    ("mean", "mean", False, False, 2),
    ("sum", "sum", True, False, 2),
    ("mean", "mean", True, True, 2),
    ("max", "mean", False, False, 2),
    ("mean", None, True, False, 1),
    (None, None, False, True, 2),
])
def test_chamfer_and_gradients_match_jax(point_reduction, batch_reduction, normals, weights, norm):
    rng = np.random.default_rng(4)
    P2 = 55 if point_reduction is not None else 40  # unreduced x and y terms are added
    x, y = _clouds(11, P1=40, P2=P2)
    xn, yn = rng.standard_normal(x.shape).astype(np.float32), rng.standard_normal(y.shape).astype(np.float32)
    xl, yl = np.asarray([40, 25]), np.asarray([P2, 31])
    w = np.asarray([0.3, 1.7], np.float32)
    kw = dict(point_reduction=point_reduction, batch_reduction=batch_reduction, norm=norm)

    def j_loss(a, b):
        loss, loss_n = j_chamfer(
            a, b, jnp.asarray(xl), jnp.asarray(yl),
            jnp.asarray(xn) if normals else None, jnp.asarray(yn) if normals else None,
            jnp.asarray(w) if weights else None, **kw,
        )
        return jnp.sum(loss) + (jnp.sum(loss_n) if loss_n is not None else 0.0)

    want, (gx, gy) = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    a, b = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    loss, loss_n = chamfer_distance(
        a, b, torch.from_numpy(xl), torch.from_numpy(yl),
        torch.from_numpy(xn) if normals else None, torch.from_numpy(yn) if normals else None,
        torch.from_numpy(w) if weights else None, **kw,
    )
    total = torch.sum(loss) + (torch.sum(loss_n) if loss_n is not None else 0.0)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    _close_grad(a.grad.numpy(), gx)
    _close_grad(b.grad.numpy(), gy)


def test_chamfer_refuses_pointclouds():
    # A list of clouds is neither a Pointclouds nor a padded tensor
    # (Pointclouds inputs are held against JAX in test_torch_points.py).
    with pytest.raises(TypeError):
        chamfer_distance([torch.zeros(4, 3)], torch.zeros(1, 4, 3))


# --------------------------------------------------------------------------- #
# Point sampling
# --------------------------------------------------------------------------- #


def jax_draws(jmesh, num_samples, key):
    """The face ids and (u, v) that JAX `sample_points_from_meshes` draws
    from `key` (sample_points_from_meshes.py:46-65 and :105)."""
    key_face, key_w = jax.random.split(key)
    verts, faces = jmesh.verts_padded(), jnp.maximum(jmesh.faces_padded(), 0)
    fmask = jmesh.faces_padded_mask()
    v0, v1, v2 = (jnp.take_along_axis(verts, faces[..., c : c + 1].repeat(3, -1), axis=1) for c in range(3))
    n = jnp.cross(v1 - v0, v2 - v0)
    areas = jnp.where(fmask, 0.5 * jnp.sqrt(jnp.sum(n * n, axis=-1)), 0.0)
    logits = jnp.where(fmask, jnp.log(jnp.clip(areas, 1e-30)), -jnp.inf)
    idx = jax.random.categorical(key_face, logits[:, None, :], axis=-1, shape=(len(jmesh), num_samples))
    u, v = jax.random.uniform(key_w, (2, len(jmesh), num_samples), dtype=verts.dtype)
    return np.array(idx), np.array(u), np.array(v)


def test_sampling_with_jax_draws_matches_jax():
    jm, tm = _both(*_hetero(seed=2))
    key = jax.random.PRNGKey(3)
    want, want_n = j_sample(jm, num_samples=300, return_normals=True, key=key)
    idx, u, v = jax_draws(jm, 300, key)
    got, got_n = sample_points_with_draws(
        tm, torch.from_numpy(idx), torch.from_numpy(u), torch.from_numpy(v), return_normals=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=1e-6)
