"""The port's pulsar renderer against the JAX package.

- `Renderer` forward at 32^2 and 48x64 with 20-200 spheres: the four camera
  layouts (8, 10, 11, 13 floats), orthogonal projection, a right-handed
  system, a background depth, opacities, `mode=1` hit maps and forward info.
- Gradients of a weighted image loss for positions, colours, radii,
  opacities, `bg_col` and `cam_params` against `jax.grad`.
- The scenarios of tests/test_more_components.py:26-60,
  tests/test_camera_pixels.py:104-125 and tests/test_gradcheck.py:122-140.
- `PulsarPointsRenderer` with FoV-perspective, FoV-orthographic and NDC
  `PerspectiveCameras`.
- The plain versions of kernels #6 and #8 (`rasterize_points_topk`,
  `pulsar_blend_grads_plain`) against the JAX Pallas kernels
  `select_from_binned` and `pulsar_blend_grads` run in interpret mode, and
  `pulsar_blend_grads_plain` against autograd of the plain blend.

Tolerances.  Cameras with an exact projection (identity rotation) give
both packages the same NDC coordinates bit for bit: images agree to 1e-5
and every gradient to 1e-5 of its largest entry (float32 sums in another
order).  A rotated camera's projection differs by an ulp between XLA's and
torch's matmul, which moves a pixel centre across a disc rim now and then;
the image barely moves (the closeness is 0 at the rim) but the closeness
gradient jumps there, so rotated cameras hold the image at 2e-5 and the
gradients at 2e-3 of their largest entry.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, through its plain versions.
"""

import math

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer.points.rasterize_points_pallas as rpp
from pytorch3d_tpu.renderer import FoVOrthographicCameras as JFoVOrtho
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JFoVPersp
from pytorch3d_tpu.renderer import PerspectiveCameras as JPersp
from pytorch3d_tpu.renderer import PointsRasterizationSettings as JSettings
from pytorch3d_tpu.renderer import PointsRasterizer as JRasterizer
from pytorch3d_tpu.renderer.points.pulsar import PulsarPointsRenderer as JPulsarPoints
from pytorch3d_tpu.renderer.points.pulsar import Renderer as JRenderer
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu_torch.renderer import (
    FoVOrthographicCameras,
    FoVPerspectiveCameras,
    PerspectiveCameras,
    PointsRasterizationSettings,
    PointsRasterizer,
    PulsarPointsRenderer,
)
from pytorch3d_tpu_torch.renderer.points.pulsar import Renderer
from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core
from pytorch3d_tpu_torch.renderer.points.rasterize_points import rasterize_points_topk
from pytorch3d_tpu_torch.renderer.points.rasterize_points_cuda import (
    bin_points_for_pulsar,
    pulsar_blend_grads_plain,
    select_points_cuda,
)
from pytorch3d_tpu_torch.structures import Pointclouds

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
EXACT = 1e-5  # images; gradients relative to their largest entry
ROTATED_IMAGE, ROTATED_GRAD = 2e-5, 2e-3


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rpp.pl, "pallas_call", patched)
    yield


def _scene(P, seed=0, depth=(2.0, 6.0), spread=1.0, C=3):
    rng = np.random.RandomState(seed)
    pos = np.concatenate([rng.uniform(-spread, spread, (P, 2)), rng.uniform(*depth, (P, 1))], 1)
    return (
        pos.astype(np.float32),
        rng.uniform(0, 1, (P, C)).astype(np.float32),
        rng.uniform(0.2, 0.6, (P,)).astype(np.float32),
        rng.uniform(0.3, 1.0, (P,)).astype(np.float32),
    )


_ROT6_IDENTITY = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]

# name -> (cam_params, renderer options, exact projection)
CAMERAS = {
    "8, identity": ([0.0, 0.0, 0.0, 0, 0, 0, 1.0, 2.0], {}, True),
    "8, translated": ([0.25, -0.125, -0.5, 0, 0, 0, 1.0, 2.0], {}, True),
    "8, rotated": ([0.05, -0.02, 0.1, 0.03, -0.05, 0.02, 1.0, 2.0], {}, False),
    "10, principal point": ([0.0, 0.0, 0.0, 0, 0, 0, 1.0, 2.0, 3.0, -2.0], {}, True),
    "11, 6D identity": ([0.0, 0.0, 0.0, *_ROT6_IDENTITY, 1.0, 2.0], {}, True),
    "11, 6D rotated": ([0.0, 0.0, 0.0, 1.0, 0.1, 0.0, -0.1, 1.0, 0.05, 1.0, 2.0], {}, False),
    "13, 6D and principal point": ([0.0, 0.0, 0.0, *_ROT6_IDENTITY, 1.0, 2.0, -4.0, 1.5], {}, True),
    "orthogonal": ([0.0, 0.0, 0.0, 0, 0, 0, 1.0, 3.0], {"orthogonal_projection": True}, True),
    "right-handed": ([0.0, 0.0, 0.0, 0, 0, 0, 1.0, 2.0], {"right_handed_system": True}, True),
    "background depth": ([0.0, 0.0, 0.0, 0, 0, 0, 1.0, 2.0], {"background_normalized_depth": 0.3}, True),
}


def _render_both(size, P, cam_name, seed=0, opacity=True, gamma=0.1, **call):
    H, W = size
    cam, opts, exact = CAMERAS[cam_name]
    cam = np.asarray(cam, np.float32)
    pos, col, rad, opa = _scene(P, seed)
    if opts.get("right_handed_system"):
        pos[:, 2] *= -1.0
    jr, tr = JRenderer(W, H, P, **opts), Renderer(W, H, P, **opts)
    j_opa = jnp.asarray(opa) if opacity else None
    t_opa = torch.tensor(opa) if opacity else None
    j = jr(jnp.asarray(pos), jnp.asarray(col), jnp.asarray(rad), jnp.asarray(cam), gamma, 10.0, 0.5,
           opacity=j_opa, **call)
    t = tr(torch.tensor(pos), torch.tensor(col), torch.tensor(rad), torch.tensor(cam), gamma, 10.0, 0.5,
           opacity=t_opa, **call)
    return j, t, exact


@pytest.mark.parametrize("size,P", [((32, 32), 20), ((48, 64), 200)])
@pytest.mark.parametrize("cam_name", list(CAMERAS))
def test_renderer_forward(size, P, cam_name):
    j, t, exact = _render_both(size, P, cam_name)
    assert t.shape == (*size, 3)
    covered = float((t.sum(-1) != 3.0).float().mean())
    assert covered > 0.05, covered
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=EXACT if exact else ROTATED_IMAGE, rtol=0)


@pytest.mark.parametrize("size,P", [((32, 32), 20), ((48, 64), 200)])
def test_renderer_without_opacity_and_mode1(size, P):
    j, t, _ = _render_both(size, P, "8, identity", opacity=False)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=EXACT, rtol=0)
    jh, th, _ = _render_both(size, P, "8, identity", mode=1)
    assert th.shape == (*size, 1)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.max() > 1  # overlapping spheres


def test_renderer_forward_info():
    (j, jinfo), (t, tinfo), _ = _render_both((48, 64), 200, "8, translated", return_forward_info=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=EXACT, rtol=0)
    ids = Renderer.sphere_ids_from_result_info_nograd(tinfo)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(JRenderer.sphere_ids_from_result_info_nograd(jinfo)))
    np.testing.assert_allclose(tinfo["weights"].numpy(), np.asarray(jinfo["weights"]), atol=EXACT, rtol=0)
    np.testing.assert_allclose(
        Renderer.depth_map_from_result_info_nograd(tinfo).numpy(),
        np.asarray(JRenderer.depth_map_from_result_info_nograd(jinfo)), atol=EXACT, rtol=0,
    )


def test_mode1_refuses_large_images():
    pos, col, rad, _ = _scene(2)
    with pytest.raises(NotImplementedError):
        Renderer(2048, 1025, 2)(torch.tensor(pos), torch.tensor(col), torch.tensor(rad),
                                torch.tensor(CAMERAS["8, identity"][0]), 0.1, 10.0, mode=1)


@pytest.mark.parametrize("cam_name", ["8, translated", "10, principal point", "13, 6D and principal point",
                                      "orthogonal", "background depth", "8, rotated"])
def test_renderer_gradients(cam_name):
    H, W, P = 32, 48, 40
    cam, opts, exact = CAMERAS[cam_name]
    cam = np.asarray(cam, np.float32)
    pos, col, rad, opa = _scene(P, seed=3)
    bg = np.asarray([0.2, 0.3, 0.4], np.float32)
    wts = np.random.RandomState(4).randn(H, W, 3).astype(np.float32)
    jr, tr = JRenderer(W, H, P, **opts), Renderer(W, H, P, **opts)

    def j_loss(p, c, r, o, b, cm):
        return jnp.sum(jr(p, c, r, cm, 0.1, 10.0, 0.5, bg_col=b, opacity=o) * wts)

    want = jax.grad(j_loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in (pos, col, rad, opa, bg, cam)))
    args = [torch.tensor(a, requires_grad=True) for a in (pos, col, rad, opa, bg, cam)]
    p, c, r, o, b, cm = args
    (tr(p, c, r, cm, 0.1, 10.0, 0.5, bg_col=b, opacity=o) * torch.tensor(wts)).sum().backward()
    tol = EXACT if exact else ROTATED_GRAD
    for name, w, a in zip(("positions", "colours", "radii", "opacity", "bg_col", "cam_params"), want, args):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        err = np.abs(a.grad.numpy() - w).max()
        assert err <= tol * scale, (name, err, scale)


class TestReferenceScenarios:
    """tests/test_more_components.py:26-60 and tests/test_gradcheck.py:122-140
    on the port, each against the JAX package as well."""

    CAM = [0, 0, 0, 0, 0, 0, 0.1, 0.2]

    def test_occlusion_and_color(self):
        args = ([[0.0, 0.0, 3.0], [0.0, 0.0, 5.0]], [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], [0.4, 0.4], self.CAM)
        img = Renderer(32, 32, 10)(*(torch.tensor(a, dtype=torch.float32) for a in args),
                                   gamma=1e-2, max_depth=10.0, min_depth=0.1)
        assert float(img[16, 16, 0]) > 0.5  # the near red sphere wins
        assert float(img[16, 16, 1]) < 0.5
        want = JRenderer(32, 32, 10)(*(jnp.asarray(a, jnp.float32) for a in args),
                                     gamma=1e-2, max_depth=10.0, min_depth=0.1)
        np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=EXACT, rtol=0)

    def test_gamma_softens(self):
        args = [torch.tensor(a, dtype=torch.float32) for a in
                ([[0.0, 0.0, 3.0], [0.0, 0.0, 3.5]], [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], [0.5, 0.5], self.CAM)]
        rend = Renderer(16, 16, 4)
        hard = rend(*args, gamma=1e-3, max_depth=10.0, min_depth=0.1)
        soft = rend(*args, gamma=1.0, max_depth=10.0, min_depth=0.1)
        assert float(soft[8, 8, 1]) > float(hard[8, 8, 1])

    def test_grad_left_half(self):
        cam = torch.tensor(self.CAM, dtype=torch.float32)
        pos = torch.tensor([[0.1, 0.0, 3.0]], requires_grad=True)
        img = Renderer(16, 16, 4)(pos, torch.ones((1, 3)), torch.tensor([0.5]), cam, gamma=0.1,
                                  max_depth=10.0, min_depth=0.1, bg_col=torch.zeros(3))
        img[:, :8].sum().backward()
        assert torch.isfinite(pos.grad).all() and pos.grad.abs().sum() > 0
        jren = JRenderer(16, 16, 4)
        want = jax.grad(lambda p: jnp.sum(jren(p, jnp.ones((1, 3)), jnp.asarray([0.5]), jnp.asarray(self.CAM, jnp.float32),
                                               gamma=0.1, max_depth=10.0, min_depth=0.1,
                                               bg_col=jnp.zeros((3,)))[:, :8]))(jnp.asarray([[0.1, 0.0, 3.0]]))
        # One sphere: each entry is a sum over pixels whose terms cancel to a
        # few per cent of their size, so float32 rounding shows at 1e-4.
        np.testing.assert_allclose(pos.grad.numpy(), np.asarray(want), atol=1e-4 * np.abs(want).max(), rtol=0)

    def test_position_gradient_against_finite_differences(self):
        cam = torch.tensor(self.CAM, dtype=torch.float64)
        pos = torch.tensor([[0.05, 0.02, 3.0], [-0.04, 0.01, 3.5]], dtype=torch.float64)
        col = torch.tensor([[1.0, 0.2, 0.1], [0.1, 0.9, 0.3]], dtype=torch.float64)
        rad = torch.tensor([0.4, 0.3], dtype=torch.float64)
        ramp = torch.linspace(0, 1, 12, dtype=torch.float64)[None, :, None]
        ren = Renderer(12, 12, 2)

        def f(p):
            return (ren(p, col, rad, cam, gamma=0.5, max_depth=10.0, min_depth=0.1,
                        bg_col=torch.zeros(3, dtype=torch.float64)) * ramp).sum()

        assert torch.autograd.gradcheck(f, (pos.requires_grad_(True),), eps=1e-6, atol=1e-5, rtol=1e-3)


def _cloud_inputs(n=2, P=80, seed=5):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (n, P, 2)), rng.uniform(-0.5, 0.5, (n, P, 1))], -1)
    return pts.astype(np.float32), rng.uniform(0, 1, (n, P, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["fov-perspective", "fov-orthographic", "ndc-perspective"])
def test_pulsar_points_renderer(kind):
    size, radius = (40, 48), 0.08
    pts, feats = _cloud_inputs()
    T = np.asarray([[0.0, 0.0, 3.0], [0.25, 0.0, 3.0]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    if kind == "fov-perspective":
        j_cams = JFoVPersp.create(R=jnp.asarray(R), T=jnp.asarray(T), fov=40.0)
        t_cams = FoVPerspectiveCameras.create(R=R, T=T, fov=40.0, device=CPU)
    elif kind == "fov-orthographic":
        j_cams = JFoVOrtho.create(R=jnp.asarray(R), T=jnp.asarray(T), znear=0.01)
        t_cams = FoVOrthographicCameras.create(R=R, T=T, znear=0.01, device=CPU)
    else:
        pp = ((0.1, -0.05), (0.0, 0.0))
        j_cams = JPersp.create(R=jnp.asarray(R), T=jnp.asarray(T), focal_length=2.0, principal_point=pp)
        t_cams = PerspectiveCameras.create(R=R, T=T, focal_length=2.0, principal_point=pp, device=CPU)
    j_r = JPulsarPoints(JRasterizer(j_cams, JSettings(image_size=size, radius=radius)))
    t_r = PulsarPointsRenderer(PointsRasterizer(t_cams, PointsRasterizationSettings(image_size=size, radius=radius)))
    kw = dict(gamma=(0.05,), znear=(1.0,), zfar=(10.0,))
    want = j_r(JPointclouds.create(jnp.asarray(pts), features=jnp.asarray(feats)), **kw)
    got = t_r(Pointclouds.create(pts, features=feats, device=CPU), **kw)
    assert got.shape == (2, *size, 3)
    assert float((got.sum(-1) != 3.0).float().mean()) > 0.05
    # The camera conversion goes through matrix_to_axis_angle at angle pi
    # (the x/y flip) and back: rotated-camera tolerance.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROTATED_IMAGE * 10, rtol=0)


def test_camera_pixels_pulsar():
    """tests/test_camera_pixels.py:104-125: one point at the centre of a
    known pixel of an NDC PerspectiveCameras batch renders at that pixel."""
    H, W = 249, 125
    cams = PerspectiveCameras.create(
        focal_length=1.0, image_size=((H, W),), in_ndc=True,
        T=[[0.0, 0.0, 0.0], [-1.0, H / W, 0.0]], principal_point=((-0.0, -0.0), (1.0, -H / W)), device=CPU,
    )
    cloud = Pointclouds.create([torch.tensor([[-0.304, 0.176, 1.0]])], features=[torch.ones((1, 3))], device=CPU).extend(2)
    rasterizer = PointsRasterizer(cams, PointsRasterizationSettings(image_size=(H, W), radius=0.0001, points_per_pixel=2))
    out = PulsarPointsRenderer(rasterizer=rasterizer)(
        cloud, gamma=(0.1, 0.1), znear=(0.1, 0.1), zfar=(70, 70), bg_col=torch.zeros(3)
    )
    assert out.shape == (2, H, W, 3)
    found = np.argwhere(out[0, :, :, 0].numpy() > 1e-3)
    assert found.tolist() == [[113, 81]]


def test_screen_space_cameras_refused():
    cams = PerspectiveCameras.create(focal_length=10.0, principal_point=((5.0, 5.0),), image_size=((10, 10),),
                                     in_ndc=False, device=CPU)
    r = PulsarPointsRenderer(PointsRasterizer(cams, PointsRasterizationSettings(image_size=10, radius=0.1)))
    with pytest.raises(ValueError, match="NDC"):
        r(Pointclouds.create([torch.tensor([[0.0, 0.0, 1.0]])], device=CPU))


def test_compute_binning_hints():
    pos, col, rad, _ = _scene(200, seed=7)
    cam = torch.tensor(CAMERAS["8, identity"][0])
    mppt, (ty, tx) = Renderer(64, 48, 200).compute_binning_hints(torch.tensor(pos), torch.tensor(rad), cam, 10.0, 0.5)
    assert mppt >= 1 and mppt & (mppt - 1) == 0
    assert ty >= 1 and tx >= 1


# --------------------------------------------------------------------------- #
# The plain versions of #6 and #8 against the JAX Pallas kernels
# --------------------------------------------------------------------------- #


def _ndc_scene(P=24, seed=11, H=32, W=32):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-1.1, 1.1, (P, 2)), rng.uniform(-0.5, 4.0, (P, 1))], 1).astype(np.float32)
    rad = rng.uniform(0.08, 0.35, (P,)).astype(np.float32)
    # spheres on both sides of both depth bounds (0.5, 3.5) and of z = 0
    valid = (pts[:, 2] > 0.5) & (pts[:, 2] < 3.5)
    return pts, rad, valid, (H, W)


def _jax_binning(pts, rad, valid, size, K):
    from pytorch3d_tpu.renderer.mesh.rasterize_pallas import _tile_for_k

    p, r, v = jnp.asarray(pts), jnp.asarray(rad), jnp.asarray(valid)
    need = int(rpp.required_points_per_tile(p, r, v, size))
    mppt = 1 << max(need - 1, 0).bit_length()
    t = rpp.required_tiles_per_point(p, r, v, size)
    tile = _tile_for_k(K)
    data, ids, counts, rows, n_ty, n_tx = rpp.bin_points_for_pulsar(
        p, r, v, size, mppt, (max(int(t[0]), 1), max(int(t[1]), 1)), tile
    )
    return data, ids, counts, rows, n_tx, tile


def test_select_plain_against_pallas(interpret_pallas):
    pts, rad, valid, size = _ndc_scene()
    K = 5
    data, ids, counts, _, n_tx, tile = _jax_binning(pts, rad, valid, size, K)
    want = np.asarray(rpp.select_from_binned(data, ids, counts, size, K, n_tx, tile))
    got = select_points_cuda(torch.tensor(pts), torch.tensor(rad), torch.tensor(valid), size, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 50 and (want < 0).any()


_BG = [0.2, 0.3, 0.4]


def _blend_env(pts, rad, valid, size, K, seed=12):
    H, W = size
    rng = np.random.RandomState(seed)
    P = pts.shape[0]
    table = np.concatenate([pts, np.maximum(rad, 1e-8)[:, None], rng.uniform(0.3, 1, (P, 1)),
                            rng.uniform(0, 1, (P, 3))], 1).astype(np.float32)
    idx = rasterize_points_topk(torch.tensor(pts), torch.tensor(rad), torch.tensor(valid), size, K)
    img, den, lm, _, _ = _blend_core(torch.tensor(table), idx, torch.tensor(_BG), 0.1, 0.5, 3.5, 0.0, H, W)
    ct = rng.randn(H, W, 3).astype(np.float32)
    return table, idx, ct, img, den, lm


def test_blend_grads_plain_against_pallas(interpret_pallas):
    pts, rad, valid, size = _ndc_scene()
    K = 5
    table, idx, ct, img, den, lm = _blend_env(pts, rad, valid, size, K)
    data, ids, counts, rows, n_tx, tile = _jax_binning(pts, rad, valid, size, K)
    want = np.asarray(rpp.pulsar_blend_grads(
        jnp.asarray(table), ids, counts, rows, jnp.asarray(idx.numpy().astype(np.int32)), jnp.asarray(ct),
        jnp.asarray(img.numpy()), jnp.asarray(den.numpy()), jnp.asarray(lm.numpy()), size, 0.1, 0.5, 3.5, n_tx, tile,
    ))
    got = pulsar_blend_grads_plain(
        torch.tensor(table), idx, torch.tensor(ct), den, lm, torch.tensor(_BG), size, 0.1, 0.5, 3.5, 0.0
    ).numpy()
    scale = np.abs(want).max(axis=0)
    assert (scale > 0).all()
    assert (np.abs(got - want).max(axis=0) <= EXACT * scale).all()


def test_blend_grads_plain_against_autograd():
    """In float64 the written-out gradient equals autograd of the blend to
    rounding; in float32 within 1e-5 of each field's largest entry."""
    pts, rad, valid, size = _ndc_scene(P=60, seed=13, H=40, W=48)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, EXACT)):
        table, idx, ct, _, _, _ = _blend_env(pts, rad, valid, size, 5)
        t = torch.tensor(table, dtype=dtype, requires_grad=True)
        bg = torch.tensor(_BG, dtype=dtype)
        img, den, lm, _, _ = _blend_core(t, idx, bg, 0.1, 0.5, 3.5, 0.0, *size)
        ctt = torch.tensor(ct, dtype=dtype)
        (want,) = torch.autograd.grad((img * ctt).sum(), t)
        got = pulsar_blend_grads_plain(t.detach(), idx, ctt, den.detach(), lm.detach(), bg, size, 0.1, 0.5, 3.5, 0.0)
        scale = want.abs().amax(dim=0)
        assert ((got - want).abs().amax(dim=0) <= tol * scale).all(), dtype


def test_pulsar_binning_rows():
    """Every (tile, sphere) slot is listed once under its sphere, in
    ascending tile order."""
    pts, rad, valid, size = _ndc_scene(P=40, H=64, W=80)
    tile_points, tile_start, n_ty, n_tx, slot_rows, sphere_start = bin_points_for_pulsar(
        torch.tensor(pts), torch.tensor(rad), torch.tensor(valid), size
    )
    assert tile_start.numel() == n_ty * n_tx + 1
    assert sorted(slot_rows.tolist()) == list(range(tile_points.numel()))
    tiles = torch.repeat_interleave(torch.arange(n_ty * n_tx), (tile_start[1:] - tile_start[:-1]).long())
    for p in range(pts.shape[0]):
        rows = slot_rows[sphere_start[p] : sphere_start[p + 1]].long()
        assert (tile_points[rows] == p).all()
        assert (tiles[rows].diff() > 0).all()
    live = valid & (pts[:, 2] >= 0)
    slots = (sphere_start[1:] - sphere_start[:-1]).numpy()
    assert (slots[~live] == 0).all() and (slots[live] > 0).any()


def test_rotation_round_trip_of_the_camera_conversion():
    """The unified renderer's x/y flip is a rotation by pi; its axis angle
    maps back to the same matrix."""
    from pytorch3d_tpu_torch.transforms.rotation_conversions import axis_angle_to_matrix, matrix_to_axis_angle

    R = torch.diag(torch.tensor([-1.0, -1.0, 1.0]))
    aa = matrix_to_axis_angle(R)
    assert abs(float(aa.norm()) - math.pi) < 1e-5
    torch.testing.assert_close(axis_angle_to_matrix(aa), R, atol=1e-6, rtol=0)


def test_chip_smoke_pulsar_bounds_count_the_function_work():
    """#6's bound is #5's rule on one cloud with 4 B per id slot; #8's reads
    the ids, cotangent, denom, logit_max, background and the table once and
    writes d(table) once, against its operations per filled hit, per pair
    of filled hits on a pixel and per pixel."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pts, rad, valid, size = _ndc_scene()
    p, r, v = torch.tensor(pts), torch.tensor(rad), torch.tensor(valid)
    idx = rasterize_points_topk(p, r, v, size, 5)
    filled = int((idx >= 0).sum())
    bound, by, tests = cs.select_bound(p, r, v, size, 5, filled)
    assert tests == cs.points_box_tests(p[None], r[None], v[None], size) > 0
    assert bound == pytest.approx(1e3 * max((pts.shape[0] * 17 + size[0] * size[1] * 5 * 4) / cs.PEAK_BYTES_PER_S,
                                            (tests * cs.POINTS_OPS_PER_CANDIDATE + filled * 5) / cs.PEAK_FP32_OPS_PER_S))
    table = torch.zeros((pts.shape[0], 8))
    bound, by, hits = cs.pulsar_grad_bound(table, idx)
    nbytes = size[0] * size[1] * (4 * 5 + 4 * 3 + 8) + 4 * 3 + 2 * table.numel() * 4
    per_pixel = (idx.numpy() >= 0).sum(-1)
    pairs = int((per_pixel * (per_pixel - 1)).sum())
    assert pairs > 0
    ops = filled * (33 + 7 * 3) + pairs * 3 * 3 + size[0] * size[1] * (3 + 3)
    assert hits == filled and bound == pytest.approx(1e3 * max(
        nbytes / cs.PEAK_BYTES_PER_S, ops / cs.PEAK_FP32_OPS_PER_S))
