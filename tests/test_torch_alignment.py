"""Ball query, farthest point sampling, point and camera alignment (ICP)
and EPnP: the port against the JAX package on the CPU.

Inputs are seeded numpy arrays handed to both packages.  Tolerances:
- ball query: coordinates on a 1/8 grid, so every squared distance is
  exact in float32 in both packages' forms (JAX expands |x|^2 + |y|^2 -
  2 x.y, the port sums squared differences): ids and distances equal;
- farthest point sampling: the same argmax over the same float32 sums:
  indices equal (with JAX's random start indices handed in);
- Umeyama, ICP, camera alignment: float32 SVDs from two libraries (Eigen
  under XLA, LAPACK under torch): R, T, s within 1e-4; ICP as its test
  says (JAX's K=1 distances have a float32 floor the port's lack);
- EPnP: against JAX in float64 (1e-7), and weighted also in float32
  (2e-6 of the largest entry, 1e-6 for the errors), from the same control
  points (see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.ops as jops
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JCameras
from pytorch3d_tpu_torch import ops as tops
from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras as TCameras

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TOL = dict(rtol=1e-4, atol=1e-4)


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_ball_query_matches_jax():
    rng = np.random.default_rng(0)
    p1 = (rng.integers(-8, 9, (2, 40, 3)) / 8.0).astype(np.float32)
    p2 = (rng.integers(-8, 9, (2, 90, 3)) / 8.0).astype(np.float32)
    lengths1, lengths2 = np.array([40, 25]), np.array([90, 60])
    jitted = jax.jit(jops.ball_query, static_argnames=("K", "radius"))  # eager costs twice the time here
    for kw in (dict(), dict(lengths1=lengths1, lengths2=lengths2)):
        want = jitted(jnp.asarray(p1), jnp.asarray(p2), K=12, radius=0.4,
                      **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tops.ball_query(torch.tensor(p1), torch.tensor(p2), K=12, radius=0.4,
                              **{k: torch.tensor(v) for k, v in kw.items()})
        assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
        assert np.array_equal(got.dists.numpy(), np.asarray(want.dists))
        assert np.array_equal(got.knn.numpy(), np.asarray(want.knn))
        assert (got.idx >= 0).any() and (got.idx < 0).any()


@pytest.mark.parametrize("fn", ["sample_farthest_points", "sample_farthest_points_naive"])
def test_sample_farthest_points_matches_jax(fn):
    rng = np.random.default_rng(1)
    points = rng.standard_normal((3, 100, 3)).astype(np.float32)
    # Every case takes at most 20 points, so JAX's eager scan compiles once;
    # the third cloud's 15 points clamp its K of 20.
    lengths = np.array([100, 70, 15])
    jfn, tfn = getattr(jops, fn), getattr(tops, fn)
    cases = [
        (dict(K=20), dict(K=20)),
        (dict(lengths=jnp.asarray(lengths), K=jnp.asarray([20, 10, 20])),
         dict(lengths=torch.tensor(lengths), K=torch.tensor([20, 10, 20]))),
    ]
    for jkw, tkw in cases:
        want_pts, want_idx = jfn(jnp.asarray(points), **jkw)
        got_pts, got_idx = tfn(torch.tensor(points), **tkw)
        assert np.array_equal(got_idx.numpy(), np.asarray(want_idx))
        assert np.array_equal(got_pts.numpy(), np.asarray(want_pts))
    # Random starts: JAX's start indices (sample_farthest_points.py:54-57) handed in.
    key = jax.random.PRNGKey(3)
    start = (jax.random.uniform(key, (3,)) * jnp.maximum(jnp.asarray(lengths), 1)).astype(jnp.int32)
    want_pts, want_idx = jfn(jnp.asarray(points), jnp.asarray(lengths), 20, True, key)
    got_pts, got_idx = tfn(torch.tensor(points), torch.tensor(lengths), 20, True, start=torch.tensor(np.asarray(start)))
    assert np.array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert (got_idx[2, 15:] == -1).all()
    assert (got_idx[:, 0] != 0).any()


def _similarity_clouds(seed, n=3, p=200, noise=0.01):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p, 3)).astype(np.float32)
    R = _rotations(rng, n)
    T = rng.standard_normal((n, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, n).astype(np.float32)
    Y = s[:, None, None] * X @ R + T[:, None] + noise * rng.standard_normal(X.shape).astype(np.float32)
    return X, Y.astype(np.float32), rng.uniform(0.1, 1.0, (n, p)).astype(np.float32)


@pytest.mark.parametrize("estimate_scale", [False, True])
@pytest.mark.parametrize("allow_reflection", [False, True])
def test_corresponding_points_alignment_matches_jax(estimate_scale, allow_reflection):
    X, Y, w = _similarity_clouds(2)
    for weights in (None, w):
        kw = dict(estimate_scale=estimate_scale, allow_reflection=allow_reflection)
        want = jops.corresponding_points_alignment(
            jnp.asarray(X), jnp.asarray(Y), weights=None if weights is None else jnp.asarray(weights), **kw)
        got = tops.corresponding_points_alignment(
            torch.tensor(X), torch.tensor(Y), weights=None if weights is None else torch.tensor(weights), **kw)
        for g, v in zip(got, want):
            _close(g, v)


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_iterative_closest_point_matches_jax(estimate_scale):
    """Two clouds of 300 points aligned to a rotated (0.3 rad), shifted and,
    with `estimate_scale`, scaled copy.  JAX's K=1 distances expand
    |x|^2 + |y|^2 - 2 x.y, whose float32 rounding leaves an RMSE floor of
    ~3e-4 once aligned, where the port's summed squared differences reach
    ~1e-6; so the two stop at other iterations near the end.  Held: the
    same convergence, the first three iterations' transforms and RMSEs, the
    final transform (1e-4), and an RMSE as small as JAX's wherever JAX's is
    at its floor.  (The scaled case leaves cloud 0 in a local minimum in
    both.)"""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((2, 300, 3)).astype(np.float32)
    axis = rng.standard_normal((2, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    K = np.cross(np.eye(3)[None], axis[:, None, :])  # cross-product matrices, row by row
    R = (np.eye(3)[None] + np.sin(0.3) * K + (1 - np.cos(0.3)) * K @ K).astype(np.float32)
    s = np.float32([1.2, 0.9]) if estimate_scale else np.ones(2, np.float32)
    Y = (s[:, None, None] * X @ R + np.float32([[0.1, -0.2, 0.05]])[:, None]).astype(np.float32)
    want = jops.iterative_closest_point(jnp.asarray(X), jnp.asarray(Y), estimate_scale=estimate_scale,
                                        max_iterations=50)
    got = tops.iterative_closest_point(torch.tensor(X), torch.tensor(Y), estimate_scale=estimate_scale,
                                       max_iterations=50)
    assert got.converged and bool(want.converged)
    for g_t, w_t in zip(got.t_history[:3], want.t_history[:3]):
        for g, v in zip(g_t, w_t):
            _close(g, v)
    for g, v in zip(got.RTs, want.RTs):
        _close(g, v)
    _close(got.Xt, want.Xt)
    floor = np.asarray(want.rmse) < 1e-3
    assert floor.any()
    np.testing.assert_allclose(got.rmse.numpy()[~floor], np.asarray(want.rmse)[~floor], rtol=1e-4)
    assert (got.rmse.numpy()[floor] <= np.asarray(want.rmse)[floor]).all()


def _pnp_inputs(seed, b=2, n=60):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (b, n, 3)).astype(np.float32)
    R = _rotations(rng, b)
    T = np.concatenate([rng.uniform(-0.3, 0.3, (b, 2)), rng.uniform(4.0, 6.0, (b, 1))], 1).astype(np.float32)
    x_cam = x @ R + T[:, None]
    y = (x_cam[..., :2] / x_cam[..., 2:]).astype(np.float32)
    y += 1e-3 * rng.standard_normal(y.shape).astype(np.float32)
    return x, y, rng.uniform(0.5, 1.0, (b, n)).astype(np.float32), R, T


def _jax_efficient_pnp(x, y, weights, skip_quadratic_eq, dtype):
    """JAX's `efficient_pnp`, jitted (eager, its first call costs ~13 s
    here).  Its `_kernel_vec_distances` loops in Python over
    `jnp.triu_indices`, which a trace makes abstract: numpy's, the same
    indices, stands in while it traces."""
    with jax.enable_x64(dtype == np.float64), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "triu_indices", np.triu_indices)
        f = jax.jit(jops.efficient_pnp, static_argnums=3)
        out = f(*(None if a is None else jnp.asarray(a, dtype) for a in (x, y, weights)), skip_quadratic_eq)
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("skip_quadratic_eq", [False, True])
def test_efficient_pnp_matches_jax(skip_quadratic_eq, weighted, monkeypatch):
    """Every output against JAX's in float64 (1e-7 of its largest entry),
    and, weighted, the float32 outputs against JAX's float32 ones.

    The control points are the centroid plus the covariance's eigenvectors,
    whose signs each library's eigh picks for itself: unweighted, torch's
    and JAX's differ here in one direction, and EPnP's answer depends on
    the control points at the noise's level (R 1.2e-3 apart).  So the
    control points are held equal up to each direction's sign, and the
    unweighted float64 run starts from JAX's.  The port's float32 run is
    held to its own float64 one as well (float32 rounding)."""
    from pytorch3d_tpu.ops import perspective_n_points as jpnp
    from pytorch3d_tpu_torch.ops import perspective_n_points as tpnp

    x, y, w, R, T = _pnp_inputs(5)
    weights = w if weighted else None
    want = _jax_efficient_pnp(x, y, weights, skip_quadratic_eq, np.float64)
    t64 = [None if a is None else torch.tensor(a).double() for a in (x, y, weights)]
    with jax.enable_x64(True):
        jax_ctrl = np.asarray(jpnp._define_control_points(*(None if a is None else jnp.asarray(a, np.float64)
                                                             for a in (x, weights))))
    own = tpnp._define_control_points(t64[0], t64[2]).numpy()
    mean = own[:, 3:]
    assert np.allclose(own[:, 3], jax_ctrl[:, 3], rtol=0, atol=1e-12)
    assert np.allclose(np.abs(own - mean), np.abs(jax_ctrl - mean), rtol=0, atol=1e-12)
    exact = tops.efficient_pnp(*t64, skip_quadratic_eq)
    if not weighted:
        assert not np.allclose(own, jax_ctrl)  # the signs differ: start from JAX's control points
        with monkeypatch.context() as mp:
            mp.setattr(tpnp, "_define_control_points", lambda x, weight: torch.tensor(jax_ctrl))
            got64 = tops.efficient_pnp(*t64, skip_quadratic_eq)
    else:
        got64 = exact
    got32 = tops.efficient_pnp(*(None if a is None else torch.tensor(a) for a in (x, y, weights)), skip_quadratic_eq)
    want32 = _jax_efficient_pnp(x, y, weights, skip_quadratic_eq, np.float32) if weighted else None
    for name in ("x_cam", "R", "T", "err_2d", "err_3d"):
        ref = getattr(want, name)
        np.testing.assert_allclose(getattr(got64, name).numpy(), ref, rtol=0, atol=1e-7 * np.abs(ref).max(),
                                   err_msg=name)
        own_ref = getattr(exact, name).numpy()
        np.testing.assert_allclose(getattr(got32, name).numpy(), own_ref, rtol=0,
                                   atol=2e-6 * np.abs(own_ref).max() if name in ("x_cam", "R", "T") else 1e-6,
                                   err_msg=name)
        if want32 is not None:
            np.testing.assert_allclose(getattr(got32, name).numpy(), getattr(want32, name), rtol=0,
                                       atol=2e-6 * np.abs(ref).max() if name in ("x_cam", "R", "T") else 1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(got32.R.numpy(), R, atol=1e-2)  # the pose the points were projected with
    np.testing.assert_allclose(got32.T.numpy(), T, atol=5e-2)


@pytest.mark.parametrize("mode", ["extrinsics", "centers"])
@pytest.mark.parametrize("estimate_scale", [True, False])
def test_corresponding_cameras_alignment_matches_jax(mode, estimate_scale):
    """Cameras aligned to a similarity-transformed copy of themselves."""
    rng = np.random.default_rng(6)
    R = _rotations(rng, 6)
    T = rng.standard_normal((6, 3)).astype(np.float32)
    Ra = _rotations(rng, 1)[0]
    Ta = rng.standard_normal(3).astype(np.float32)
    sa = np.float32(1.7 if estimate_scale else 1.0)
    # x_world' = sa x_world Ra + Ta: a camera (R, T) sees it as (Ra^T R, sa T - Ta Ra^T R).
    R_tgt = (Ra.T[None] @ R).astype(np.float32)
    T_tgt = (sa * T - np.einsum("i,nij->nj", Ta @ Ra.T, R)).astype(np.float32)
    want = jops.corresponding_cameras_alignment(
        JCameras.create(R=jnp.asarray(R), T=jnp.asarray(T)), JCameras.create(R=jnp.asarray(R_tgt), T=jnp.asarray(T_tgt)),
        estimate_scale=estimate_scale, mode=mode)
    got = tops.corresponding_cameras_alignment(
        TCameras.create(R=torch.tensor(R), T=torch.tensor(T), device="cpu"),
        TCameras.create(R=torch.tensor(R_tgt), T=torch.tensor(T_tgt), device="cpu"),
        estimate_scale=estimate_scale, mode=mode)
    _close(got.R, want.R)
    _close(got.T, want.T)
    _close(got.R, R_tgt, atol=1e-4)  # the aligned copy lands on the target
    _close(got.T, T_tgt, atol=1e-3)
    with pytest.raises(ValueError):
        tops.corresponding_cameras_alignment(got, got, mode="both")
