"""The port's `symeig3x3`, point covariances, normals and local frames,
`Pointclouds.subsample` / `estimate_normals`, the Laplacian matrices and
the rest of `ops/utils.py` against the JAX package.

Inputs are seeded numpy arrays handed to both packages (the port on the
CPU); values agree to 1e-5 relative unless a test says otherwise.
Eigenvectors are defined only up to their span where eigenvalues repeat, so
those are compared by span.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.ops as jo
from pytorch3d_tpu.common.symeig3x3 import symeig3x3 as j_symeig3x3
from pytorch3d_tpu.common.workaround import _safe_det_3x3 as j_safe_det
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import ops as to
from pytorch3d_tpu_torch.common import symeig3x3
from pytorch3d_tpu_torch.common.workaround import _safe_det_3x3
from pytorch3d_tpu_torch.structures import Pointclouds
from pytorch3d_tpu_torch.utils import ico_sphere

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-5
a = np.asarray


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sym(kind, n=200, seed=0):
    """Symmetric 3x3 matrices: random, with a repeated eigenvalue, or
    multiples of the identity."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    if kind == "random":
        ev = rng.uniform(-2, 2, (n, 3))
    elif kind == "repeated":
        ev = np.repeat(rng.uniform(0.5, 2, (n, 1)), 3, 1)
        ev[:, 0] = rng.uniform(-1, 0, n)
    else:
        ev = np.repeat(rng.uniform(0.5, 2, (n, 1)), 3, 1)
    return np.einsum("nij,nj,nkj->nik", q, ev, q).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "repeated", "spherical"])
def test_symeig3x3_matches_jax(kind):
    """Eigenvalues within 1e-5 of JAX's (of the largest); at a repeated
    eigenvalue acos of the cubic's r = +-1 takes the last bits of det(B) to
    ~3e-4 in both packages, so there both are held to float64 eigh, the port
    no further than JAX + 1e-5.  Eigenvectors where the eigenvalues are
    apart by > 1e-2 (of the largest) agree up to sign within 1e-4, and the
    spans of repeated ones agree (projectors within 1e-4); beside a repeated
    eigenvalue those ~3e-4 errors move the other eigenvector by ~1e-4 (of a
    gap ~1) in both packages, so there the vectors are held to 1e-3."""
    A = _sym(kind)
    jw, jv = (a(x) for x in jax.jit(j_symeig3x3)(jnp.asarray(A)))
    tw, tv = (_np(x) for x in symeig3x3(torch.from_numpy(A)))
    scale = np.abs(jw).max(-1, keepdims=True)
    if kind == "random":
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5 * scale.max())
    else:
        exact = np.linalg.eigvalsh(A.astype(np.float64))
        assert np.abs(tw - exact).max() <= np.abs(jw - exact).max() + 1e-5
    np.testing.assert_allclose(_np(symeig3x3(torch.from_numpy(A), eigenvectors=False)[0]), tw, rtol=0, atol=1e-6)
    gaps = np.diff(jw, axis=-1) / scale  # (n, 2): l1 - l0, l2 - l1
    apart = np.stack([gaps[:, 0], np.minimum(gaps[:, 0], gaps[:, 1]), gaps[:, 1]], -1) > 1e-2
    tol = 1e-4 if kind == "random" else 1e-3
    signs = np.sign(np.sum(tv * jv, axis=-2, keepdims=True))  # align each column's sign with JAX's
    np.testing.assert_allclose((tv * signs).transpose(0, 2, 1)[apart], jv.transpose(0, 2, 1)[apart], atol=tol)
    for i in range(3):  # the span of each cluster of close eigenvalues
        close = np.abs(jw - jw[:, i:i + 1]) / scale <= 1e-2
        P_t = np.einsum("nik,njk,nk->nij", tv, tv, close.astype(np.float32))
        P_j = np.einsum("nik,njk,nk->nij", jv, jv, close.astype(np.float32))
        np.testing.assert_allclose(P_t, P_j, atol=tol)
    # orthonormal columns, A v = l v
    np.testing.assert_allclose(np.einsum("nki,nkj->nij", tv, tv), np.broadcast_to(np.eye(3), A.shape), atol=1e-5)
    np.testing.assert_allclose(A @ tv, tv * tw[:, None, :], atol=tol)


def test_safe_det_and_ops_utils_match_jax():
    """_safe_det_3x3, eyes, wmean (values and gradient), masked_gather,
    convert_pointclouds_to_tensor / is_pointclouds and the ops'
    packed_to_padded / padded_to_packed."""
    rng = np.random.RandomState(1)
    M = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(_safe_det_3x3(torch.from_numpy(M))), a(j_safe_det(jnp.asarray(M))), rtol=RTOL)
    np.testing.assert_array_equal(_np(to.eyes(3, 2, device=CPU)), a(jo.eyes(3, 2)))
    x = rng.normal(size=(2, 6, 3)).astype(np.float32)
    w = rng.uniform(size=(2, 6)).astype(np.float32)
    ct = rng.normal(size=(2, 1, 3)).astype(np.float32)
    jy, pull = jax.vjp(lambda x, w: jo.wmean(x, w), jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    ty = to.wmean(xt, wt)
    ty.backward(torch.from_numpy(ct))
    for got, want in zip((ty, xt.grad, wt.grad), (jy, *pull(jnp.asarray(ct)))):
        np.testing.assert_allclose(_np(got), a(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(to.wmean(torch.from_numpy(x), dim=(0, 1), keepdim=False)),
                               a(jo.wmean(jnp.asarray(x), axis=(0, 1), keepdims=False)), rtol=RTOL)
    for shape in ((2, 4), (2, 4, 3)):
        idx = rng.randint(-1, 6, size=shape)
        np.testing.assert_array_equal(_np(to.masked_gather(torch.from_numpy(x), torch.from_numpy(idx))),
                                      a(jo.masked_gather(jnp.asarray(x), jnp.asarray(idx))))
    clouds = Pointclouds.create([x[0], x[1, :4]], device=CPU)
    assert to.is_pointclouds(clouds) and not to.is_pointclouds(x)
    for arg, jarg in ((clouds, JPointclouds.create([jnp.asarray(x[0]), jnp.asarray(x[1, :4])])),
                      (torch.from_numpy(x), jnp.asarray(x))):
        for g, want in zip(to.convert_pointclouds_to_tensor(arg), jo.utils.convert_pointclouds_to_tensor(jarg)):
            np.testing.assert_array_equal(_np(g), a(want))
    packed = rng.normal(size=(9, 2)).astype(np.float32)
    first = np.array([0, 4, 5])
    pad = to.packed_to_padded(torch.from_numpy(packed), torch.from_numpy(first), 5)
    np.testing.assert_array_equal(_np(pad), a(jo.packed_to_padded(jnp.asarray(packed), jnp.asarray(first), 5)))
    np.testing.assert_array_equal(_np(to.packed_to_padded(torch.from_numpy(packed[:, 0]), torch.from_numpy(first), 5)),
                                  a(jo.packed_to_padded(jnp.asarray(packed[:, 0]), jnp.asarray(first), 5)))
    np.testing.assert_array_equal(_np(to.padded_to_packed(pad, torch.from_numpy(first), 9)), packed)


def _clouds(N=2, P=200, seed=2):
    """Noisy samples of spheres and planes, with a shorter second cloud."""
    rng = np.random.RandomState(seed)
    pts = rng.normal(size=(N, P, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts[1, :, 2] *= 0.05  # a flattened cloud
    pts += rng.normal(scale=0.01, size=pts.shape)
    lengths = np.array([P, P - 40])
    return pts.astype(np.float32), lengths


@pytest.mark.parametrize("k", [8, 16])
def test_point_covariances_and_local_frames_match_jax(k):
    """get_point_covariances (values and the gradient of a seeded cotangent
    with respect to the points) and estimate_pointcloud_local_coord_frames:
    curvatures within 1e-5, frames up to 1e-4 where the eigenvalues are
    apart by > 1e-2 of the largest, the normals (disambiguated) within
    1e-4."""
    pts, lengths = _clouds()
    ct = np.random.RandomState(3).normal(size=(2, pts.shape[1], 3, 3)).astype(np.float32)

    def jcov(p):
        return jo.get_point_covariances(p, jnp.asarray(lengths), k)[0]

    jy, pull = jax.vjp(jax.jit(jcov), jnp.asarray(pts))
    pt = torch.tensor(pts, requires_grad=True)
    ty = to.get_point_covariances(pt, torch.from_numpy(lengths), k)[0]
    ty.backward(torch.from_numpy(ct))
    valid = np.arange(pts.shape[1])[None] < lengths[:, None]
    np.testing.assert_allclose(_np(ty)[valid], a(jy)[valid], rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(pt.grad)[valid], a(pull(jnp.asarray(ct))[0])[valid], rtol=1e-4, atol=1e-5)

    jcl = JPointclouds.create([jnp.asarray(p[:n]) for p, n in zip(pts, lengths)])
    tcl = Pointclouds.create([p[:n] for p, n in zip(pts, lengths)], device=CPU)
    jc, jf = (a(x) for x in jo.estimate_pointcloud_local_coord_frames(jcl, k))
    tc, tf = (_np(x) for x in to.estimate_pointcloud_local_coord_frames(tcl, k))
    scale = np.abs(jc).max(-1, keepdims=True)
    np.testing.assert_allclose(tc[valid], jc[valid], rtol=0, atol=1e-5 * scale.max())
    gaps = (np.diff(jc, axis=-1) / scale)[valid]
    ok = (gaps > 1e-2).all(-1)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(tf[valid][ok], jf[valid][ok], atol=1e-4)
    normals = _np(tcl.estimate_normals(k))
    np.testing.assert_allclose(normals[valid][ok], a(jo.estimate_pointcloud_normals(jcl, k))[valid][ok], atol=1e-4)
    assert tcl.estimate_normals(k, assign_to_self=True).normals_padded() is not None
    with pytest.raises(ValueError):
        to.estimate_pointcloud_normals(tcl, neighborhood_size=lengths.min())


def test_pointclouds_subsample_and_devices():
    """subsample with JAX's uniform scores handed in keeps the same points,
    normals and features; with a generator it keeps real points only."""
    pts, lengths = _clouds(P=50)
    feats = np.random.RandomState(4).uniform(size=pts.shape).astype(np.float32)
    jcl = JPointclouds.create([jnp.asarray(p[:n]) for p, n in zip(pts, lengths)],
                              normals=[jnp.asarray(p[:n]) for p, n in zip(pts, lengths)],
                              features=[jnp.asarray(f[:n]) for f, n in zip(feats, lengths)])
    tcl = Pointclouds.create([p[:n] for p, n in zip(pts, lengths)], normals=[p[:n] for p, n in zip(pts, lengths)],
                             features=[f[:n] for f, n in zip(feats, lengths)], device=CPU)
    key = jax.random.PRNGKey(5)
    scores = np.array(jax.random.uniform(key, (2, 50)))
    js_, ts_ = jcl.subsample(20, key=key), tcl.subsample(20, scores=torch.from_numpy(scores))
    for name in ("points_padded", "normals_padded", "features_padded", "num_points_per_cloud"):
        np.testing.assert_array_equal(_np(getattr(ts_, name)()), a(getattr(js_, name)()), err_msg=name)
    drawn = tcl.subsample(45, generator=torch.Generator().manual_seed(0))
    assert drawn.num_points_per_cloud().tolist() == [45, 10]
    kept = _np(drawn.points_padded())[1, :10]
    assert all(np.isclose(pts[1, :10], p).all(-1).any() for p in kept)
    assert tcl.subsample(60) is tcl and tcl.cpu().device.type == "cpu"


@pytest.mark.parametrize("name", ["laplacian", "norm_laplacian", "cot_laplacian"])
def test_laplacians_match_jax(name):
    """The sparse matrices, compared dense (duplicates summed), and the
    gradient of a seeded weighting of them with respect to the verts (the
    uniform Laplacian has none), on ico_sphere(1) with a -1 padded edge /
    face row."""
    jm = j_ico_sphere(1)
    tm = ico_sphere(1, device=CPU)
    rng = np.random.RandomState(6)
    verts = (a(jm.verts_packed()) * rng.uniform(0.8, 1.2, (a(jm.verts_packed()).shape[0], 1))).astype(np.float32)
    V = verts.shape[0]
    W = rng.normal(size=(V, V)).astype(np.float32)
    if name == "cot_laplacian":
        topo = np.concatenate([_np(tm.faces_packed()), -np.ones((1, 3), np.int64)])
    else:
        edges = _np(tm.edges_packed())
        topo = np.concatenate([edges[edges[:, 0] >= 0], -np.ones((1, 2), np.int64)])
    jfn, tfn = getattr(jo, name), getattr(to, name)

    def jparts(v):
        out = jfn(v, jnp.asarray(topo, jnp.int32))
        L, extra = out if name == "cot_laplacian" else (out, jnp.zeros(()))
        return L.todense(), extra

    jparts = jax.jit(jparts)
    jL, jextra = jparts(jnp.asarray(verts))
    vt = torch.tensor(verts, requires_grad=name != "laplacian")
    out = tfn(vt, torch.from_numpy(topo))
    L, extra = out if name == "cot_laplacian" else (out, torch.zeros(()))
    dense = L.to_dense()
    np.testing.assert_allclose(_np(dense), a(jL), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(extra), a(jextra), rtol=RTOL, atol=ATOL)
    if name != "laplacian":
        jg = jax.jit(jax.grad(lambda v: jnp.sum(jparts(v)[0] * W) + jnp.sum(jparts(v)[1])))(jnp.asarray(verts))
        (torch.sum(dense * torch.from_numpy(W)) + extra.sum()).backward()
        np.testing.assert_allclose(_np(vt.grad), a(jg), rtol=1e-4, atol=1e-4 * float(np.abs(a(jg)).max()))
