"""The port's SfM cameras (`PerspectiveCameras`, `OrthographicCameras`)
against the JAX package: projection, NDC and screen transforms in NDC and
screen space, unprojection, and the checks of `_SfMCameraMixin`.

Inputs are seeded numpy arrays handed to both packages; values agree to
1e-5 relative (4x4 products of float32 matrices, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.renderer import OrthographicCameras as JOrtho
from pytorch3d_tpu.renderer import PerspectiveCameras as JPersp
from pytorch3d_tpu.transforms.rotation_conversions import random_rotations as j_random_rotations
from pytorch3d_tpu_torch.convert import orthographic_cameras_from_numpy, perspective_cameras_from_numpy
from pytorch3d_tpu_torch.renderer import OrthographicCameras, PerspectiveCameras

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-5


def _pose(N=3, seed=0):
    import jax

    R = np.array(j_random_rotations(N, key=jax.random.PRNGKey(seed)))
    T = np.random.RandomState(seed).uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    T[:, 2] += 4.0
    return R, T


def _points(N=3, P=50, seed=1):
    return np.random.RandomState(seed).uniform(-1, 1, (N, P, 3)).astype(np.float32)


CASES = {
    "perspective, NDC": (JPersp, PerspectiveCameras, dict(focal_length=1.7, principal_point=((0.1, -0.2),))),
    "perspective, fx fy": (JPersp, PerspectiveCameras,
                           dict(focal_length=((1.5, 2.0),), principal_point=((0.0, 0.05),))),
    "perspective, screen": (JPersp, PerspectiveCameras,
                            dict(focal_length=60.0, principal_point=((32.0, 20.0),), image_size=((48, 64),), in_ndc=False)),
    "orthographic, NDC": (JOrtho, OrthographicCameras, dict(focal_length=0.8, principal_point=((0.2, 0.1),))),
    "orthographic, screen": (JOrtho, OrthographicCameras,
                             dict(focal_length=((30.0, 25.0),), principal_point=((30.0, 24.0),), image_size=((48, 64),),
                                  in_ndc=False)),
}


def _both(case):
    jcls, tcls, kw = CASES[case]
    R, T = _pose()
    j = jcls.create(R=jnp.asarray(R), T=jnp.asarray(T), **kw)
    t = tcls.create(R=R, T=T, device=CPU, **kw)
    return j, t


@pytest.mark.parametrize("case", list(CASES))
def test_transforms(case):
    j, t = _both(case)
    assert t.is_perspective() == j.is_perspective() and t.in_ndc() == j.in_ndc()
    pts = _points()
    for name in ("transform_points", "transform_points_ndc"):
        want = np.asarray(getattr(j, name)(jnp.asarray(pts)))
        got = getattr(t, name)(torch.tensor(pts)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    for flip in (True, False):
        want = np.asarray(j.transform_points_screen(jnp.asarray(pts), with_xyflip=flip, image_size=(48, 64)))
        got = t.transform_points_screen(torch.tensor(pts), with_xyflip=flip, image_size=(48, 64)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)  # pixels: 1e-5 of 64
    np.testing.assert_allclose(
        t.get_projection_transform().get_matrix().numpy(), np.asarray(j.get_projection_transform().get_matrix()),
        rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(
        t.get_ndc_camera_transform().get_matrix().numpy(),
        np.asarray(j.get_ndc_camera_transform().get_matrix()), rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", [True, False])
def test_unproject(case, world):
    j, t = _both(case)
    xy_depth = np.random.RandomState(2).uniform(0.5, 3.0, (3, 20, 3)).astype(np.float32)
    want = np.asarray(j.unproject_points(jnp.asarray(xy_depth), world_coordinates=world))
    got = t.unproject_points(torch.tensor(xy_depth), world_coordinates=world).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if not t.in_ndc():
        want = np.asarray(j.unproject_points(jnp.asarray(xy_depth), world_coordinates=world, from_ndc=True))
        got = t.unproject_points(torch.tensor(xy_depth), world_coordinates=world, from_ndc=True).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a projection and its unprojection round trip (NDC cameras)
    if t.in_ndc() and world:
        pts = torch.tensor(_points())
        proj = t.transform_points(pts)
        depth = t.get_world_to_view_transform().transform_points(pts)[..., 2:]
        back = t.unproject_points(torch.cat([proj[..., :2], depth], -1))
        torch.testing.assert_close(back, pts, atol=1e-4, rtol=0)


def test_from_numpy_and_broadcasting():
    R, T = _pose(2)
    cams = perspective_cameras_from_numpy(R, T, np.asarray([[1.2], [1.4]], np.float32),
                                          np.zeros((1, 2), np.float32), device=CPU)
    assert len(cams) == 2 and cams.focal_length.shape == (2, 1) and cams.principal_point.shape == (2, 2)
    ortho = orthographic_cameras_from_numpy(R, T, np.ones((2, 2), np.float32), np.zeros((2, 2), np.float32),
                                            image_size=np.asarray([[32, 48]]), in_ndc=False, device=CPU)
    assert not ortho.in_ndc() and not ortho.is_perspective() and ortho.image_size.shape == (2, 2)
    with pytest.raises(ValueError):
        PerspectiveCameras.create(R=np.eye(3, dtype=np.float32)[None].repeat(2, 0), focal_length=[1.0, 2.0, 3.0],
                                  device=CPU)


def test_screen_transform_needs_image_size():
    _, t = _both("perspective, NDC")
    with pytest.raises(ValueError, match="image_size"):
        t.transform_points_screen(torch.zeros(3, 1, 3))
