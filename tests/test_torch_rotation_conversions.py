"""The port's rotation conversions against the JAX package.

Every function of transforms/rotation_conversions.py on the same seeded
numpy inputs, at 1e-6 (1e-5 where the angle comes near pi, where the
matrix-to-quaternion candidates and atan2 lose digits).
`matrix_to_axis_angle` is held away from angle pi, where it is
ill-conditioned in float32.  The random draws come from different
generators (numpy's for JAX keys is not torch's), so they are held to
their properties: unit norm, non-negative real part, orthonormal matrices.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.transforms.rotation_conversions as jrc
import pytorch3d_tpu_torch.transforms.rotation_conversions as trc

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TOL, NEAR_PI = 1e-6, 1e-5


def _quats(n=64, seed=0):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _axis_angles(n=64, seed=1, max_angle=3.0):
    rng = np.random.RandomState(seed)
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.0, max_angle, (n, 1))
    aa = axis * angle
    aa[:4] = [[0, 0, 0], [1e-7, 0, 0], [0, 2e-6, -1e-6], [0.3, -0.2, 0.1]]  # the small-angle branches
    return aa.astype(np.float32)


def _both(name, *args, **kw):
    j = getattr(jrc, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    t = getattr(trc, name)(*(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    return np.asarray(j), t.numpy()


def _close(name, *args, tol=TOL, **kw):
    j, t = _both(name, *args, **kw)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=tol, rtol=0)


@pytest.mark.parametrize("name,inputs", [
    ("quaternion_to_matrix", lambda: (_quats(),)),
    ("standardize_quaternion", lambda: (_quats(),)),
    ("quaternion_raw_multiply", lambda: (_quats(seed=2), _quats(seed=3))),
    ("quaternion_multiply", lambda: (_quats(seed=2), _quats(seed=3))),
    ("quaternion_invert", lambda: (_quats(),)),
    ("quaternion_apply", lambda: (_quats(), np.random.RandomState(4).randn(64, 3).astype(np.float32))),
    ("axis_angle_to_quaternion", lambda: (_axis_angles(),)),
    ("quaternion_to_axis_angle", lambda: (_quats(),)),
    ("axis_angle_to_matrix", lambda: (_axis_angles(),)),
    ("rotation_6d_to_matrix", lambda: (np.random.RandomState(5).randn(64, 6).astype(np.float32),)),
])
def test_function(name, inputs):
    _close(name, *inputs())


def test_matrix_to_quaternion_and_axis_angle():
    R = np.asarray(jrc.quaternion_to_matrix(jnp.asarray(_quats(128, seed=6))))
    _close("matrix_to_quaternion", R)
    _close("matrix_to_rotation_6d", R)
    # away from angle pi: matrix_to_axis_angle is ill-conditioned there
    R = np.asarray(jrc.axis_angle_to_matrix(jnp.asarray(_axis_angles(128, seed=7, max_angle=2.8))))
    _close("matrix_to_axis_angle", R)
    # near pi the axis is still recovered, to NEAR_PI
    aa = _axis_angles(64, seed=8)
    aa *= (3.1 / np.maximum(np.linalg.norm(aa, axis=1, keepdims=True), 1e-12)).astype(np.float32)
    R = np.asarray(jrc.axis_angle_to_matrix(jnp.asarray(aa[4:])))
    _close("matrix_to_quaternion", R, tol=NEAR_PI)


@pytest.mark.parametrize("convention", ["".join(c) for c in itertools.product("XYZ", repeat=3)
                                        if c[1] not in (c[0], c[2])])
def test_euler_angles(convention):
    angles = np.random.RandomState(9).uniform(-1.4, 1.4, (32, 3)).astype(np.float32)
    _close("euler_angles_to_matrix", angles, convention)
    R = np.asarray(jrc.euler_angles_to_matrix(jnp.asarray(angles), convention))
    _close("matrix_to_euler_angles", R, convention, tol=NEAR_PI)
    back = trc.euler_angles_to_matrix(trc.matrix_to_euler_angles(torch.tensor(R), convention), convention)
    np.testing.assert_allclose(back.numpy(), R, atol=NEAR_PI)


@pytest.mark.parametrize("bad", ["XX", "XXY", "XYA"])
def test_bad_conventions(bad):
    with pytest.raises(ValueError):
        jrc.euler_angles_to_matrix(jnp.zeros((1, 3)), bad)
    with pytest.raises(ValueError):
        trc.euler_angles_to_matrix(torch.zeros(1, 3), bad)


def test_axis_angle_rotation():
    angle = np.random.RandomState(10).uniform(-3, 3, (16,)).astype(np.float32)
    for axis in "XYZ":
        j, t = _both("_axis_angle_rotation", axis, angle)
        np.testing.assert_allclose(t, j, atol=TOL, rtol=0)


def test_random_rotations():
    g = torch.Generator().manual_seed(0)
    q = trc.random_quaternions(500, generator=g)
    torch.testing.assert_close(q.norm(dim=1), torch.ones(500), atol=1e-6, rtol=0)
    assert (q[:, 0] >= 0).all()
    R = trc.random_rotations(100, generator=g)
    torch.testing.assert_close(R @ R.transpose(1, 2), torch.eye(3).expand(100, 3, 3), atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.linalg.det(R), torch.ones(100), atol=1e-5, rtol=0)
    assert trc.random_rotation(generator=g).shape == (3, 3)
    # seeded: the same generator state gives the same draws
    torch.testing.assert_close(trc.random_rotations(3, torch.Generator().manual_seed(1)),
                               trc.random_rotations(3, torch.Generator().manual_seed(1)))


def test_random_rotations_on_the_cpu_when_asked():
    R = trc.random_rotations(4, device="cpu")
    assert R.device.type == "cpu"
    # an explicit device is honoured with a generator too
    q = trc.random_quaternions(4, generator=torch.Generator().manual_seed(2), device="cpu")
    assert q.device.type == "cpu"
    assert trc.random_rotation(device=torch.device("cpu")).device.type == "cpu"


def test_random_rotations_default_to_the_default_device(monkeypatch):
    # With neither a generator nor a device the draw is made on DEFAULT_DEVICE:
    # pointed at the CPU it is the seed-0 draw there ...
    monkeypatch.setattr(trc, "DEFAULT_DEVICE", torch.device("cpu"))
    R = trc.random_rotations(3)
    assert R.device.type == "cpu"
    torch.testing.assert_close(R, trc.random_rotations(3, torch.Generator().manual_seed(0)), atol=0, rtol=0)
    # ... and, left at its value, the card (which a CPU-only torch refuses).
    monkeypatch.undo()
    assert trc.DEFAULT_DEVICE.type == "cuda"
    if torch.cuda.is_available():
        assert trc.random_rotations(3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            trc.random_rotations(3)


def test_gradients_are_finite_at_the_identity():
    aa = torch.zeros(2, 3, requires_grad=True)
    (trc.axis_angle_to_matrix(aa).sum() + trc.axis_angle_to_quaternion(aa).sum()).backward()
    assert torch.isfinite(aa.grad).all()
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], requires_grad=True)
    trc.quaternion_to_axis_angle(q).sum().backward()
    assert torch.isfinite(q.grad).all()
