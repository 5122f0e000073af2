"""The rest of the port's cameras against the JAX package: batch indexing,
`clone` / `to`, joining, `camera_utils`, the OpenCV and pulsar conversions,
`FishEyeCameras` (alone and through `MeshRasterizer`), `TensorProperties`,
the NDC grid samplers, `LinearWithRepeat` and the device helpers.

Inputs are seeded numpy arrays handed to both packages (the port on the
CPU); values agree to 1e-5 relative unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer as jr
from pytorch3d_tpu.common import LinearWithRepeat as JLinearWithRepeat
from pytorch3d_tpu.renderer import camera_conversions as jconv
from pytorch3d_tpu.renderer.fisheyecameras import FishEyeCameras as JFishEye
from pytorch3d_tpu.renderer.utils import ndc_grid_sample_packed as j_ndc_grid_sample_packed
from pytorch3d_tpu.transforms.rotation_conversions import random_rotations as j_random_rotations
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import convert
from pytorch3d_tpu_torch import renderer as tr
from pytorch3d_tpu_torch import utils as tu
from pytorch3d_tpu_torch.common import LinearWithRepeat, get_device, make_device
from pytorch3d_tpu_torch.common.compat import meshgrid_ij, prod
from pytorch3d_tpu_torch.renderer.utils import TensorAccessor, ndc_grid_sample_packed
from pytorch3d_tpu_torch.utils import ico_sphere

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-5
a = np.asarray


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pose(N=4, seed=0):
    R = np.array(j_random_rotations(N, key=jax.random.PRNGKey(seed)))
    T = np.random.RandomState(seed).uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    T[:, 2] += 4.0
    return R, T


def _cameras(kind, N=4):
    R, T = _pose(N)
    rng = np.random.RandomState(1)
    if kind == "fov":
        kw = dict(znear=rng.uniform(0.5, 1.0, N).astype(np.float32), fov=50.0)
        return jr.FoVPerspectiveCameras.create(R=jnp.asarray(R), T=jnp.asarray(T), **kw), \
            tr.FoVPerspectiveCameras.create(R=R, T=T, device=CPU, **kw)
    kw = dict(focal_length=rng.uniform(1.0, 2.0, (N, 2)).astype(np.float32),
              principal_point=rng.uniform(-0.1, 0.1, (N, 2)).astype(np.float32))
    return jr.PerspectiveCameras.create(R=jnp.asarray(R), T=jnp.asarray(T), **kw), \
        tr.PerspectiveCameras.create(R=R, T=T, device=CPU, **kw)


def _same_camera(t, j, names):
    for name in names:
        np.testing.assert_array_equal(_np(getattr(t, name)), a(getattr(j, name)), err_msg=name)


@pytest.mark.parametrize("kind", ["fov", "sfm"])
def test_camera_indexing_clone_to_match_jax(kind):
    """Every batched tensor field indexed, no flag; an int keeps the batch
    dim; out of range raises IndexError; the indexed camera projects as
    JAX's does."""
    jc, tc = _cameras(kind)
    names = ("R", "T", "znear", "zfar", "fov") if kind == "fov" else ("R", "T", "focal_length", "principal_point")
    pts = np.random.RandomState(2).uniform(-1, 1, (1, 20, 3)).astype(np.float32)
    for index in (1, -1, [0, 2], slice(1, 3), torch.tensor([3, 0])):
        jindex = jnp.asarray(index.numpy()) if torch.is_tensor(index) else index
        ti, ji = tc[index], jc[jindex]
        _same_camera(ti, ji, names)
        assert len(ti) == (1 if isinstance(index, int) else 2)
        got = ti.transform_points(torch.from_numpy(pts).expand(len(ti), -1, -1))
        np.testing.assert_allclose(_np(got), a(ji.transform_points(jnp.broadcast_to(pts, (len(ji), 20, 3)))),
                                   rtol=RTOL, atol=ATOL)
    if kind == "fov":
        assert tc[0].degrees == jc[0].degrees
    else:
        assert tc[0].in_ndc() == jc[0].in_ndc()
    for bad in (4, -5, [0, 9]):
        with pytest.raises(IndexError):
            tc[bad]
    c = tc.clone()
    assert c.R.data_ptr() != tc.R.data_ptr() and torch.equal(c.R, tc.R)
    assert tc.to("cpu").device.type == "cpu" and tc.dtype == torch.float32
    np.testing.assert_array_equal(_np(tc.get_znear()) if kind == "fov" else tc.get_znear(),
                                  a(jc.get_znear()) if kind == "fov" else jc.get_znear())
    pp = tc.get_principal_point()
    assert (pp is None) == (jc.get_principal_point() is None)


def test_join_cameras_and_camera_utils_match_jax():
    jc, tc = _cameras("fov")
    jj = jr.join_cameras_as_batch([jc[0], jc[2:], jc[1]])
    tj = tr.join_cameras_as_batch([tc[0], tc[2:], tc[1]])
    _same_camera(tj, jj, ("R", "T", "znear", "zfar", "fov", "aspect_ratio"))
    _, ts = _cameras("sfm")
    with pytest.raises(ValueError):
        tr.join_cameras_as_batch([tc, ts])
    with pytest.raises(ValueError):
        tr.join_cameras_as_batch([tc, tc.replace(degrees=False)])
    for g, w in zip(tr.camera_to_eye_at_up(tc.get_world_to_view_transform()),
                    jr.camera_to_eye_at_up(jc.get_world_to_view_transform())):
        np.testing.assert_allclose(_np(g), a(w), rtol=RTOL, atol=ATOL)
    rot = np.array(j_random_rotations(4, key=jax.random.PRNGKey(3)))
    for g, w in zip(tr.rotate_on_spot(tc.R, tc.T, torch.from_numpy(rot)),
                    jr.rotate_on_spot(jc.R, jc.T, jnp.asarray(rot))):
        np.testing.assert_allclose(_np(g), a(w), rtol=RTOL, atol=ATOL)


def _opencv(N=3, seed=4):
    R, _ = _pose(N, seed)
    rng = np.random.RandomState(seed)
    tvec = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    tvec[:, 2] += 5.0
    K = np.zeros((N, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = rng.uniform(200, 400, N), rng.uniform(200, 400, N)
    K[:, 0, 2], K[:, 1, 2] = rng.uniform(150, 170, N), rng.uniform(110, 130, N)
    K[:, 2, 2] = 1.0
    size = np.tile(np.array([[240, 320]], np.float32), (N, 1))
    return R, tvec, K, size


def test_opencv_conversions_match_jax():
    """cameras_from_opencv_projection (values and gradient), its inverse
    (a round trip to 1e-5) and both pulsar conversions."""
    R, tvec, K, size = _opencv()
    jc = jconv.cameras_from_opencv_projection(*map(jnp.asarray, (R, tvec, K, size)))
    tc = tr.cameras_from_opencv_projection(*map(torch.from_numpy, (R, tvec, K, size)))
    _same_camera(tc, jc, ("R", "T", "focal_length", "principal_point"))
    for g, w, x in zip(tr.opencv_from_cameras_projection(tc, torch.from_numpy(size)),
                       jconv.opencv_from_cameras_projection(jc, jnp.asarray(size)), (R, tvec, K)):
        np.testing.assert_allclose(_np(g), a(w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(g), x, rtol=1e-5, atol=1e-5)
    pj = jconv.pulsar_from_opencv_projection(*map(jnp.asarray, (R, tvec, K, size)))
    pt = tu.pulsar_from_opencv_projection(*map(torch.from_numpy, (R, tvec, K, size)))
    np.testing.assert_allclose(_np(pt), a(pj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(tu.pulsar_from_cameras_projection(tc, torch.from_numpy(size))),
                               a(jconv.pulsar_from_cameras_projection(jc, jnp.asarray(size))), rtol=1e-4, atol=1e-4)
    # gradients reach R, tvec and K through the flips
    ct = np.random.RandomState(5).normal(size=(3, 20, 3)).astype(np.float32)
    pts = np.random.RandomState(6).uniform(-1, 1, (3, 20, 3)).astype(np.float32)

    def jproj(R, t, K):
        return jconv.cameras_from_opencv_projection(R, t, K, jnp.asarray(size)).transform_points(jnp.asarray(pts))

    jg = jax.vjp(jax.jit(jproj), *map(jnp.asarray, (R, tvec, K)))[1](jnp.asarray(ct))
    xs = [torch.tensor(x, requires_grad=True) for x in (R, tvec, K)]
    tr.cameras_from_opencv_projection(*xs, torch.from_numpy(size)).transform_points(torch.from_numpy(pts)).backward(
        torch.from_numpy(ct))
    for x, w in zip(xs, jg):
        np.testing.assert_allclose(_np(x.grad), a(w), rtol=1e-4, atol=1e-4)


# The distortion of PyTorch3D's tests/test_render_meshes.py test_simple_sphere
# FishEye branch (tests/test_reference_goldens.py:57-103).
FISHEYE = dict(
    radial_params=((-1.0, -2.0, -3.0, 0.0, 0.0, 1.0),),
    tangential_params=((0.7002747019, -0.4005228974),),
    thin_prism_params=((-1.000134884, -1.000084822, -1.0009420014, -1.0001276838),),
)


def _fisheye(R, T, world_coordinates=True, **flags):
    j = JFishEye.create(R=jnp.asarray(R), T=jnp.asarray(T), world_coordinates=world_coordinates, **FISHEYE, **flags)
    t = convert.fisheye_cameras_from_numpy(
        R, T, a(j.focal_length), a(j.principal_point), a(j.radial_params), a(j.tangential_params),
        a(j.thin_prism_params), world_coordinates=world_coordinates, device=CPU, **flags)
    return j, t


def _world_points(t, max_deg, seed=7, n=64):
    """World points in front of camera t at view depth 1.7-3.7, up to
    `max_deg` degrees off its axis."""
    rng = np.random.RandomState(seed)
    ang = np.deg2rad(max_deg) * np.sqrt(rng.uniform(0, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(1.7, 3.7, n)
    view = np.stack([np.tan(ang) * np.cos(phi) * z, np.tan(ang) * np.sin(phi) * z, z], -1)[None].astype(np.float32)
    return _np(t.get_world_to_view_transform().inverse().transform_points(torch.from_numpy(view)))


# (flags, the largest angle off the axis in degrees at which the round trip
# is held, its tolerance relative to |x|).  The golden's thin-prism (-1) and
# tangential (0.7) terms are far beyond what 4 fixed-point steps undo: both
# packages' round trips drift to 5e-4 at 5 degrees and diverge past ~15, so
# those cases are held at 2 degrees; the radial polynomial alone inverts to
# ~2e-7 at 20 degrees (8 Newton steps).
FISHEYE_CASES = {
    "full": (dict(), 2.0, 5e-5),
    "radial only": (dict(use_tangential=False, use_thin_prism=False), 20.0, 1e-6),
    "no radial": (dict(use_radial=False), 2.0, 5e-5),
}


@pytest.mark.parametrize("case", list(FISHEYE_CASES))
def test_fisheye_matches_jax(case):
    """transform_points (values and the gradient with respect to the points,
    at up to 25 degrees off-axis) and unproject_points against JAX's, and
    unproject(transform(x)) = x within the case's angle and tolerance (of
    the point's distance from the camera)."""
    flags, max_deg, tol = FISHEYE_CASES[case]
    R, T = jr.look_at_view_transform(2.7, 10.0, 20.0)
    j, t = _fisheye(np.array(R), np.array(T), **flags)
    x = _world_points(t, 25.0)
    ct = np.random.RandomState(8).normal(size=x.shape).astype(np.float32)
    jy, pull = jax.vjp(jax.jit(j.transform_points), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    ty = t.transform_points(xt)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(_np(ty), a(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(xt.grad), a(pull(jnp.asarray(ct))[0]), rtol=1e-4, atol=1e-4)
    x = _world_points(t, max_deg, seed=9)
    depth = _np(t.get_world_to_view_transform().transform_points(torch.from_numpy(x)))[..., 2:]
    xy_depth = np.concatenate([_np(t.transform_points(torch.from_numpy(x)))[..., :2], depth], -1)
    back = t.unproject_points(torch.from_numpy(xy_depth))
    np.testing.assert_allclose(_np(back), a(jax.jit(j.unproject_points)(jnp.asarray(xy_depth))), rtol=1e-5, atol=1e-5)
    dist = np.linalg.norm(x - _np(t.get_camera_center())[:, None], axis=-1)  # from the camera
    err = float((np.abs(_np(back) - x).max(-1) / dist).max())
    assert err < tol, err
    assert not t.in_ndc() and not t.is_perspective()


def test_fisheye_through_mesh_rasterizer_matches_jax():
    """MeshRasterizer's non-linear branch carries FishEye (transform_points,
    then an identity NDC transform): ico_sphere(2) at 32^2 from the golden
    camera, fragments against JAX's (jitted): ids equal on >= 99 % of
    pixels, zbuf and bary within 1e-4 where they are."""
    R, T = jr.look_at_view_transform(2.7, 0.0, 0.0)
    j, t = _fisheye(np.array(R), np.array(T))
    settings = dict(image_size=32, blur_radius=0.0, faces_per_pixel=1)
    jm = j_ico_sphere(2)
    jf = jax.jit(lambda v: jr.MeshRasterizer(j, jr.RasterizationSettings(**settings))(jm.update_padded(v)))(
        jm.verts_padded())
    tf = tr.MeshRasterizer(t, tr.RasterizationSettings(**settings))(ico_sphere(2, device=CPU))
    same = _np(tf.pix_to_face) == a(jf.pix_to_face)
    assert same.mean() >= 0.99 and (a(jf.pix_to_face) >= 0).mean() > 0.05
    np.testing.assert_allclose(_np(tf.zbuf)[same], a(jf.zbuf)[same], atol=1e-4)
    np.testing.assert_allclose(_np(tf.bary_coords)[same], a(jf.bary_coords)[same], atol=1e-4)


def test_tensor_properties_match_jax():
    """Broadcasting of numbers, lists and tensors; indexing (broadcast
    scalars included, ints keeping the batch dim, IndexError out of range);
    the accessor's writes; clone, to and gather_props."""
    kw = dict(a=1.5, b=((1.0, 2.0, 3.0),), c=np.arange(6, dtype=np.float32).reshape(3, 2), flag="x")
    jp = jr.TensorProperties(**kw)
    tp = tr.TensorProperties(device=CPU, **kw)
    assert len(tp) == len(jp) == 3 and tp.flag == "x"
    for name in ("a", "b", "c"):
        np.testing.assert_array_equal(_np(getattr(tp, name)), a(getattr(jp, name)))
    for index in (1, -1, slice(0, 2)):
        ti, ji = tp[index], jp[index]
        assert len(ti) == len(ji)
        for name in ("a", "b", "c"):
            np.testing.assert_array_equal(_np(getattr(ti, name)), a(getattr(ji, name)))
    with pytest.raises(IndexError):
        tp[3]
    acc = TensorAccessor(tp, 1)
    np.testing.assert_array_equal(_np(acc.c), [2.0, 3.0])
    acc.a = 7.0  # the broadcast view is replaced, not written through
    np.testing.assert_array_equal(_np(tp.a), [1.5, 7.0, 1.5])
    c = tp.clone()
    assert c.c.data_ptr() != tp.c.data_ptr()
    assert tp.to("cpu") is tp and len(tp.gather_props(torch.tensor([2, 0]))) == 2
    with pytest.raises(ValueError):
        tr.TensorProperties(device=CPU, a=(1.0, 2.0), b=(1.0, 2.0, 3.0))
    for args in ((1.0, (2.0, 3.0), np.ones((2, 3), np.float32)), (np.float32(4.0),)):
        for g, w in zip(tr.convert_to_tensors_and_broadcast(*args, device=CPU),
                        jr.convert_to_tensors_and_broadcast(*args)):
            np.testing.assert_array_equal(_np(g), a(w))
    np.testing.assert_array_equal(_np(tr.format_tensor(2.0, device=CPU)), a(jr.format_tensor(2.0)))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_ndc_grid_sample_matches_jax(mode):
    """ndc_grid_sample (values; the gradient with respect to the image for
    bilinear) and ndc_grid_sample_packed on a non-square image."""
    rng = np.random.RandomState(9)
    img = rng.uniform(size=(2, 3, 6, 10)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 4, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(tr.ndc_to_grid_sample_coords(torch.from_numpy(grid), (6, 10))),
                               a(jr.ndc_to_grid_sample_coords(jnp.asarray(grid), (6, 10))), rtol=RTOL, atol=1e-7)
    ct = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    jy, pull = jax.vjp(jax.jit(lambda x: jr.ndc_grid_sample(x, jnp.asarray(grid), mode=mode)), jnp.asarray(img))
    xt = torch.tensor(img, requires_grad=True)
    ty = tr.ndc_grid_sample(xt, torch.from_numpy(grid), mode=mode)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(_np(ty), a(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(xt.grad), a(pull(jnp.asarray(ct))[0]), rtol=RTOL, atol=ATOL)
    xys, ids = grid.reshape(-1, 2), np.repeat(np.array([1, 0]), 20)
    np.testing.assert_allclose(
        _np(ndc_grid_sample_packed(torch.from_numpy(img), torch.from_numpy(xys), torch.from_numpy(ids), mode=mode)),
        a(j_ndc_grid_sample_packed(jnp.asarray(img), jnp.asarray(xys), jnp.asarray(ids), mode=mode)),
        rtol=RTOL, atol=ATOL)


def test_linear_with_repeat_and_device_helpers():
    """LinearWithRepeat with the flax module's params carried across
    (convert.linear_with_repeat_state_dict_from_flax): values and the
    gradients of a seeded cotangent; then make_device, get_device, meshgrid_ij
    and prod."""
    rng = np.random.RandomState(10)
    x = rng.normal(size=(2, 5, 7)).astype(np.float32)
    z = rng.normal(size=(2, 4)).astype(np.float32)
    ct = rng.normal(size=(2, 5, 3)).astype(np.float32)
    jmod = JLinearWithRepeat(features=3)
    params = jmod.init(jax.random.PRNGKey(0), (jnp.asarray(x), jnp.asarray(z)))
    jy, pull = jax.vjp(lambda p, x, z: jmod.apply(p, (x, z)), params, jnp.asarray(x), jnp.asarray(z))
    gp, gx, gz = pull(jnp.asarray(ct))
    mod = LinearWithRepeat(11, 3, device=CPU, generator=torch.Generator().manual_seed(0))
    assert mod.kernel.shape == (11, 3) and float(mod.kernel.abs().max()) <= 2 * (1 / 11) ** 0.5 / 0.8796 + 1e-6
    mod.load_state_dict(convert.linear_with_repeat_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                                          device=CPU))
    xt, zt = torch.tensor(x, requires_grad=True), torch.tensor(z, requires_grad=True)
    y = mod((xt, zt))
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(_np(y), a(jy), rtol=RTOL, atol=ATOL)
    for got, want in ((xt.grad, gx), (zt.grad, gz), (mod.kernel.grad, gp["params"]["kernel"]),
                      (mod.bias.grad, gp["params"]["bias"])):
        np.testing.assert_allclose(_np(got), a(want), rtol=RTOL, atol=ATOL)
    assert make_device("cpu") == CPU and get_device(torch.zeros(1)) == CPU and get_device(None, "cpu") == CPU
    gi, gj = meshgrid_ij(torch.arange(2), torch.arange(3))
    assert gi.shape == (2, 3) and int(gi[1, 0]) == 1 and prod([2, 3, 4]) == 24
