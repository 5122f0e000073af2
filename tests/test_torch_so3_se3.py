"""The port's SO(3) / SE(3) maps, `acos_linear_extrapolation` and the rest
of `Transform3d` against the JAX package.

Inputs are seeded numpy arrays handed to both packages; forward values and
gradients (a seeded cotangent pulled back through both) agree to 1e-5
relative unless a test says otherwise.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.transforms as jt
import pytorch3d_tpu_torch.transforms as tt
from pytorch3d_tpu.transforms.se3 import _get_se3_V_input as j_v_input
from pytorch3d_tpu.transforms.se3 import _se3_V_matrix as j_v_matrix
from pytorch3d_tpu_torch.transforms.se3 import _get_se3_V_input as t_v_input
from pytorch3d_tpu_torch.transforms.se3 import _se3_V_matrix as t_v_matrix

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

RTOL, ATOL = 1e-5, 1e-5


def _vjp_both(jfn, tfn, x, seed=0):
    """Values and the VJP of a seeded cotangent through jfn and tfn at x."""
    jy, pull = jax.vjp(jax.jit(jfn), jnp.asarray(x))
    ct = np.random.RandomState(seed).normal(size=jy.shape).astype(np.float32)
    (jg,) = pull(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    ty = tfn(xt)
    ty.backward(torch.tensor(ct))
    return (np.asarray(jy), np.asarray(jg)), (ty.detach().numpy(), xt.grad.numpy())


def _close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _log_rots(kind, n=6, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "zero":
        return np.zeros((n, 3), np.float32)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {"small": rng.uniform(1e-4, 1e-2, n), "random": rng.uniform(0.1, 3.0, n)}[kind]
    return (axis * angle[:, None]).astype(np.float32)


# At angles of 1e-4-1e-2 the gradient of (1 - cos t)/t^2 cancels in float32:
# both packages sit ~4e-5 (of gradients up to ~5) off a float64 evaluation,
# each in its own last bits of sin/cos, so they are held to 1e-4 there.
GRAD_ATOL = {"zero": ATOL, "small": 1e-4, "random": ATOL}


@pytest.mark.parametrize("kind", ["zero", "small", "random"])
def test_so3_exp_map_and_grad(kind):
    x = _log_rots(kind)
    jv, tv = _vjp_both(jt.so3_exp_map, tt.so3_exp_map, x)
    assert np.isfinite(tv[1]).all()
    _close(tv[:1], jv[:1])
    _close(tv[1:], jv[1:], atol=GRAD_ATOL[kind])
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tt.so3_exp_map(x64).backward(torch.tensor(np.random.RandomState(0).normal(size=(len(x), 3, 3))))
    np.testing.assert_allclose(tv[1], x64.grad.numpy(), rtol=0, atol=GRAD_ATOL[kind])


@pytest.mark.parametrize("kind", ["zero", "small", "random"])
def test_so3_log_map_and_grad(kind):
    """The log through the quaternion: finite gradient at the identity (the
    pose fit starts there), equal to JAX's."""
    R = np.asarray(jt.so3_exp_map(jnp.asarray(_log_rots(kind, seed=1))))
    jv, tv = _vjp_both(jt.so3_log_map, tt.so3_log_map, R)
    assert np.isfinite(tv[1]).all()
    _close(tv, jv)


@pytest.mark.parametrize("cos_bound", [1e-4, 0.0])
def test_so3_angles_and_grad(cos_bound):
    """Angles of random rotations and of rotations by ~0 and ~pi, where
    cos_bound > 0 extrapolates acos linearly."""
    logs = np.concatenate([_log_rots("random", seed=2), _log_rots("small", 2, seed=3),
                           _log_rots("random", 2, seed=4) / np.float32(3.0) * np.float32(3.1)])
    R = np.asarray(jt.so3_exp_map(jnp.asarray(logs)))
    if cos_bound > 0:
        jv, tv = _vjp_both(lambda r: jt.so3_rotation_angle(r, cos_bound=cos_bound),
                           lambda r: tt.so3_rotation_angle(r, cos_bound=cos_bound), R)
        _close(tv, jv, rtol=1e-4, atol=1e-4)  # d acos near +-1 is ~1e2: float32 bits of the trace
    else:
        np.testing.assert_allclose(tt.so3_rotation_angle(torch.tensor(R), cos_bound=0.0).numpy(),
                                   np.asarray(jt.so3_rotation_angle(jnp.asarray(R), cos_bound=0.0)), atol=1e-3)
    R2 = R[::-1].copy()
    np.testing.assert_allclose(tt.so3_relative_angle(torch.tensor(R), torch.tensor(R2)).numpy(),
                               np.asarray(jt.so3_relative_angle(jnp.asarray(R), jnp.asarray(R2))), atol=1e-4)
    np.testing.assert_allclose(tt.so3_rotation_angle(torch.tensor(R), cos_angle=True).numpy(),
                               np.asarray(jt.so3_rotation_angle(jnp.asarray(R), cos_angle=True)), atol=1e-6)


def test_acos_linear_extrapolation_hat_and_errors():
    x = np.linspace(-1.2, 1.2, 41).astype(np.float32)
    for bounds in [(-0.9999, 0.9999), (-0.5, 0.8)]:
        jv, tv = _vjp_both(lambda v: jt.acos_linear_extrapolation(v, bounds),
                           lambda v: tt.acos_linear_extrapolation(v, bounds), x)
        _close(tv, jv)
    with pytest.raises(ValueError):
        tt.acos_linear_extrapolation(torch.tensor(x), (0.5, -0.5))
    with pytest.raises(ValueError):
        tt.acos_linear_extrapolation(torch.tensor(x), (-1.0, 0.5))
    v = _log_rots("random", seed=5)
    H = tt.hat(torch.tensor(v))
    np.testing.assert_array_equal(H.numpy(), np.asarray(jt.hat(jnp.asarray(v))))
    np.testing.assert_array_equal(tt.hat_inv(H).numpy(), v)
    with pytest.raises(ValueError):
        tt.hat(torch.zeros(2, 4))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        R = tt.so3_exponential_map(torch.tensor(v))
    assert any(issubclass(x.category, PendingDeprecationWarning) for x in w)
    np.testing.assert_array_equal(R.numpy(), tt.so3_exp_map(torch.tensor(v)).numpy())


def _log_transforms(kind, n=6, seed=0):
    rng = np.random.RandomState(seed + 10)
    trans = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([trans if kind != "zero" else np.zeros_like(trans), _log_rots(kind, n, seed)], axis=1)


@pytest.mark.parametrize("kind", ["zero", "small", "random"])
def test_se3_exp_map_and_grad(kind):
    """(N, 4, 4) row-vector matrices and the gradient of a seeded cotangent
    with respect to the log; at zero (the pose fit's start) it is finite."""
    x = _log_transforms(kind)
    jv, tv = _vjp_both(jt.se3_exp_map, tt.se3_exp_map, x)
    assert np.isfinite(tv[1]).all()
    _close(tv[:1], jv[:1])
    _close(tv[1:], jv[1:], atol=GRAD_ATOL[kind])
    with pytest.raises(ValueError):
        tt.se3_exp_map(torch.zeros(3, 7))


def test_se3_V_matrix_cancellation_term_in_absolute_terms():
    """B = (t - sin t) / t^3 at t = sqrt(max(|w|^2, eps)) >= 0.01 loses ~0.5 %
    to float32 cancellation near t = 0.01, in both packages alike, so the V
    matrices are compared in absolute terms (its entries are O(1))."""
    w = np.concatenate([_log_rots(k, 4, seed=6) for k in ("zero", "small", "random")])
    jV = np.asarray(j_v_matrix(*j_v_input(jnp.asarray(w))))
    tV = t_v_matrix(*t_v_input(torch.tensor(w))).numpy()
    np.testing.assert_allclose(tV, jV, rtol=0, atol=2e-6)


@pytest.mark.parametrize("kind", ["small", "random"])
def test_se3_log_map_and_grad(kind):
    M = np.asarray(jt.se3_exp_map(jnp.asarray(_log_transforms(kind, seed=7))))
    jv, tv = _vjp_both(jt.se3_log_map, tt.se3_log_map, M)
    assert np.isfinite(tv[1]).all()
    _close(tv, jv, rtol=1e-4, atol=1e-4)  # a 3x3 solve of float32 V, in another order
    # round trip
    log = tt.se3_log_map(tt.se3_exp_map(torch.tensor(_log_transforms(kind, seed=7))))
    np.testing.assert_allclose(log.numpy(), _log_transforms(kind, seed=7), atol=1e-4)


def test_transform3d_indexing_stack_log_clone_to():
    logs = _log_transforms("random", n=5, seed=8)
    Mj = jt.se3_exp_map(jnp.asarray(logs))
    tj = jt.Transform3d.create(Mj)
    t = tt.Transform3d.create(np.asarray(Mj), device="cpu")
    for index in (0, 3, -1, slice(1, 4), [0, 2]):
        got = t[index].get_matrix().numpy()
        want = np.asarray(tj[index if not isinstance(index, list) else jnp.asarray(index)].get_matrix())
        assert got.ndim == 3
        np.testing.assert_array_equal(got, want)
    stacked = t[0].stack(t[1], t[2:4])
    np.testing.assert_array_equal(stacked.get_matrix().numpy(), np.asarray(tj[0].stack(tj[1], tj[2:4]).get_matrix()))
    np.testing.assert_allclose(t.get_se3_log().numpy(), np.asarray(tj.get_se3_log()), rtol=1e-4, atol=1e-4)
    c = t.clone()
    assert c.get_matrix() is not t.get_matrix() and torch.equal(c.get_matrix(), t.get_matrix())
    moved = t.to("cpu", dtype=torch.float64)
    assert moved.dtype == torch.float64 and t.cpu().device.type == "cpu"
