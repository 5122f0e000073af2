"""The port's `mesh_face_areas_normals`, the point-triangle and
point-segment distances and `point_mesh_face_distance` /
`point_mesh_edge_distance` against the JAX package's, values and gradients
to the vertices and the points.

The meshes are the JAX package's ico_sphere(1) and a small torus (two face
counts, so the batch is padded); the clouds are drawn with numpy from a
seed (two point counts).  The port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.loss import point_mesh_edge_distance as j_edge_dist
from pytorch3d_tpu.loss import point_mesh_face_distance as j_face_dist
from pytorch3d_tpu.loss.point_mesh_distance import point_triangle_distance as j_point_tri
from pytorch3d_tpu.ops import mesh_face_areas_normals as j_areas_normals
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch.convert import meshes_from_numpy, pointclouds_from_numpy
from pytorch3d_tpu_torch.loss import point_mesh_edge_distance, point_mesh_face_distance
from pytorch3d_tpu_torch.loss.point_mesh_distance import point_triangle_distance
from pytorch3d_tpu_torch.ops import mesh_face_areas_normals

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

# The same float32 formulas: 1e-5 of the largest value or gradient (the
# gradients sum over the points that pick a face in another order).
TOL = 1e-5


def _err(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def scene():
    sphere, ring = j_ico_sphere(1), j_torus(0.3, 0.9, 6, 8)
    verts = [np.asarray(m.verts_list()[0]) for m in (sphere, ring)]
    faces = [np.asarray(m.faces_list()[0]) for m in (sphere, ring)]
    rng = np.random.RandomState(0)
    clouds = [rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32) for n in (70, 45)]
    return verts, faces, clouds


def test_mesh_face_areas_normals():
    """A padding face (-1) and a degenerate face get area 0 and normal 0;
    gradients to the vertices of a weighted sum of areas and normals."""
    sphere = j_ico_sphere(1)
    verts = np.asarray(sphere.verts_list()[0])
    faces = np.concatenate([np.asarray(sphere.faces_list()[0]), [[-1, -1, -1], [3, 3, 7]]]).astype(np.int64)
    rng = np.random.RandomState(1)
    wa, wn = rng.randn(len(faces)).astype(np.float32), rng.randn(len(faces), 3).astype(np.float32)

    def jloss(v):
        a, n = j_areas_normals(v, jnp.asarray(faces))
        return jnp.sum(a * wa) + jnp.sum(n * wn), (a, n)

    (_, (ja, jn)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(verts))
    tv = torch.tensor(verts, requires_grad=True)
    ta, tn = mesh_face_areas_normals(tv, torch.tensor(faces))
    ((ta * torch.tensor(wa)).sum() + (tn * torch.tensor(wn)).sum()).backward()
    assert _err(ta, ja) <= TOL and _err(tn, jn) <= TOL and _err(tv.grad, jg) <= TOL
    assert not ta[-2:].detach().abs().max() and not tn[-2:].detach().abs().max()
    assert bool(torch.isfinite(tv.grad).all())


def test_point_triangle_distance_cases():
    """Points projecting inside and outside triangles, and triangles below
    min_triangle_area (edges only), against the JAX formulas."""
    rng = np.random.RandomState(2)
    p = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    tri = rng.uniform(-1, 1, (200, 3, 3)).astype(np.float32)
    tri[:20, 2] = tri[:20, 0] + 1e-3 * tri[:20, 1]  # slivers below the area floor
    want = jax.jit(j_point_tri)(*(jnp.asarray(a) for a in (p, tri[:, 0], tri[:, 1], tri[:, 2])))
    got = point_triangle_distance(*(torch.tensor(a) for a in (p, tri[:, 0], tri[:, 1], tri[:, 2])))
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("kind", ["face", "edge"])
def test_point_mesh_distance_and_gradients(scene, kind):
    verts, faces, clouds = scene
    jm = JMeshes.create([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces])
    jp = JPointclouds.create([jnp.asarray(c) for c in clouds])
    tm = meshes_from_numpy(verts, faces, device="cpu")
    tp = pointclouds_from_numpy(clouds, device="cpu")
    jfn, tfn = (j_face_dist, point_mesh_face_distance) if kind == "face" else (j_edge_dist, point_mesh_edge_distance)

    def jloss(v, p):
        return jfn(jm.update_padded(v), jp.update_padded(p))

    want, (jgv, jgp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jm.verts_padded(), jp.points_padded())
    tv = tm.verts_padded().clone().requires_grad_(True)
    tq = tp.points_padded().clone().requires_grad_(True)
    got = tfn(tm.update_padded(tv), tp.update_padded(tq))
    got.backward()
    assert _err(got, want) <= TOL
    assert _err(tq.grad, jgp) <= TOL
    # The padding faces of the smaller mesh are vertex 0 three times: JAX's
    # plane normal divides by sqrt(0) there and makes that vertex's gradient
    # NaN; the port's stays finite and equals JAX's everywhere else.
    jgv = np.asarray(jgv)
    bad = ~np.isfinite(jgv).all(axis=-1)
    padded = tm.num_faces_per_mesh().numpy() < tm.max_faces
    assert bad.sum() == padded.sum() * (kind == "face") and (not bad.any() or bad[padded, 0].all())
    assert bool(torch.isfinite(tv.grad).all())
    assert _err(tv.grad[torch.tensor(~bad)], jgv[~bad]) <= TOL
    with pytest.raises(ValueError):
        tfn(tm, pointclouds_from_numpy(clouds[:1], device="cpu"))
