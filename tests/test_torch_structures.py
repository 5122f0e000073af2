"""The port's structures, transforms and cameras against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
the port runs on the CPU (device="cpu").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer as jr
import pytorch3d_tpu.transforms as jt
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch import renderer as tr
from pytorch3d_tpu_torch import transforms as tt
from pytorch3d_tpu_torch.structures import Meshes
from pytorch3d_tpu_torch.utils import ico_sphere, torus

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_ico_sphere_matches_jax(level):
    mj, mt = j_ico_sphere(level), ico_sphere(level, device=CPU)
    # Same numpy construction on both sides: exact equality.
    np.testing.assert_array_equal(_np(mt.verts_padded()), np.asarray(mj.verts_padded()))
    np.testing.assert_array_equal(_np(mt.faces_padded()), np.asarray(mj.faces_padded()))


@pytest.mark.parametrize("args", [(0.4, 1.2, 12, 24), (0.4, 1.2, 48, 96)])
def test_torus_matches_jax(args):
    mj, mt = j_torus(*args), torus(*args, device=CPU)
    np.testing.assert_array_equal(_np(mt.verts_padded()), np.asarray(mj.verts_padded()))
    np.testing.assert_array_equal(_np(mt.faces_padded()), np.asarray(mj.faces_padded()))


def _hetero_batch():
    rng = np.random.default_rng(0)
    verts = [rng.normal(size=(n, 3)).astype(np.float32) for n in (7, 4, 10)]
    faces = [rng.integers(0, len(v), size=(f, 3)).astype(np.int32) for v, f in zip(verts, (9, 3, 12))]
    return verts, faces


def test_meshes_views_match_jax():
    verts, faces = _hetero_batch()
    mj = JMeshes.create([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces])
    mt = Meshes.create(verts, faces, device=CPU)
    for name in (
        "verts_padded", "faces_padded", "verts_packed", "faces_packed",
        "verts_padded_mask", "faces_padded_mask", "verts_packed_mask",
        "faces_packed_mask", "num_verts_per_mesh", "num_faces_per_mesh",
        "verts_packed_to_mesh_idx", "faces_packed_to_mesh_idx",
        "mesh_to_verts_packed_first_idx", "mesh_to_faces_packed_first_idx",
    ):
        np.testing.assert_array_equal(_np(getattr(mt, name)()), np.asarray(getattr(mj, name)()), err_msg=name)
    # -1 rows pad faces_packed in both frameworks.
    assert (_np(mt.faces_packed())[~_np(mt.faces_packed_mask())] == -1).all()
    # Normals and areas: float32 sums in another order, atol 1e-6.
    for name in ("verts_normals_packed", "faces_normals_packed", "faces_areas_packed"):
        np.testing.assert_allclose(
            _np(getattr(mt, name)()), np.asarray(getattr(mj, name)()), atol=1e-6, err_msg=name
        )


def test_meshes_update_and_index_match_jax():
    verts, faces = _hetero_batch()
    mj = JMeshes.create([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces])
    mt = Meshes.create(verts, faces, device=CPU)
    new = np.random.default_rng(1).normal(size=np.asarray(mj.verts_padded()).shape).astype(np.float32)
    np.testing.assert_array_equal(
        _np(mt.update_padded(torch.from_numpy(new)).verts_packed()),
        np.asarray(mj.update_padded(jnp.asarray(new)).verts_packed()),
    )


def _points(n=2, p=50, seed=0):
    return np.random.default_rng(seed).normal(size=(n, p, 3)).astype(np.float32)


def test_transform3d_matches_jax():
    pts = _points()
    angle = np.asarray([30.0, -75.0], np.float32)
    tj = (
        jt.Transform3d.create()
        .rotate_axis_angle(jnp.asarray(angle), axis="Y")
        .translate(jnp.asarray([[0.1, -0.2, 0.3], [1.0, 2.0, -1.0]]))
        .scale(jnp.asarray([1.5, 0.5]))
    )
    tq = (
        tt.Transform3d.create(device=CPU)
        .rotate_axis_angle(torch.from_numpy(angle), axis="Y")
        .translate(torch.tensor([[0.1, -0.2, 0.3], [1.0, 2.0, -1.0]]))
        .scale(torch.tensor([1.5, 0.5]))
    )
    # float32 matmuls in another order: atol 1e-5.
    np.testing.assert_allclose(_np(tq.get_matrix()), np.asarray(tj.get_matrix()), atol=1e-5)
    np.testing.assert_allclose(
        _np(tq.transform_points(torch.from_numpy(pts))), np.asarray(tj.transform_points(jnp.asarray(pts))), atol=1e-5
    )
    np.testing.assert_allclose(
        _np(tq.transform_normals(torch.from_numpy(pts))), np.asarray(tj.transform_normals(jnp.asarray(pts))), atol=1e-5
    )
    np.testing.assert_allclose(
        _np(tq.inverse().transform_points(torch.from_numpy(pts))),
        np.asarray(tj.inverse().transform_points(jnp.asarray(pts))), atol=1e-5,
    )


@pytest.mark.parametrize("dist,elev,azim", [(2.7, 20.0, 30.0), (1.5, -40.0, 200.0), (3.0, 89.9, 0.0)])
def test_look_at_and_fov_projection_match_jax(dist, elev, azim):
    Rj, Tj = jr.look_at_view_transform(dist, elev, azim)
    Rt, Tt = tr.look_at_view_transform(dist, elev, azim, device=CPU)
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(_np(Tt), np.asarray(Tj), atol=1e-5)
    cj = jr.FoVPerspectiveCameras.create(R=Rj, T=Tj, znear=0.5, zfar=50.0, fov=45.0, aspect_ratio=1.3)
    ct = tr.FoVPerspectiveCameras.create(R=Rt, T=Tt, znear=0.5, zfar=50.0, fov=45.0, aspect_ratio=1.3, device=CPU)
    pts = _points(1, 64, seed=3)[0] * 0.5
    np.testing.assert_allclose(
        _np(ct.transform_points(torch.from_numpy(pts))), np.asarray(cj.transform_points(jnp.asarray(pts))), atol=1e-5
    )
    np.testing.assert_allclose(_np(ct.get_camera_center()), np.asarray(cj.get_camera_center()), atol=1e-5)


def test_safe_norm_matches_jax_with_zero_gradient_at_zero():
    import jax

    from pytorch3d_tpu.common.math_utils import safe_norm as j_safe_norm
    from pytorch3d_tpu_torch.common.math_utils import safe_norm

    x = np.random.default_rng(4).normal(size=(6, 3)).astype(np.float32)
    x[2] = 0.0  # a padded (zero) row: its gradient must be 0, not NaN
    xt = torch.tensor(x, requires_grad=True)
    safe_norm(xt).sum().backward()
    gj = jax.grad(lambda v: j_safe_norm(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(_np(safe_norm(torch.tensor(x))), np.asarray(j_safe_norm(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gj), atol=1e-6)
    assert np.isfinite(_np(xt.grad)).all() and (_np(xt.grad)[2] == 0).all()
