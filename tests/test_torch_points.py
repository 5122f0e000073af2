"""The port's point-rendering path against the JAX package.

- The plain rasterizer (`rasterize_points_plain`) against the JAX XLA
  oracle (`rasterize_points_topk_xla` + `recompute_point_fragments`) and
  against the JAX Pallas kernel run in interpret mode, on
  tests/test_pallas_crosscheck.py:205-262's inputs and on the four radius
  and aspect regimes of tests/test_render_points.py:209-215.
- The CSR binning of the CUDA path is conservative: rasterizing each tile
  from its list alone reproduces the unbinned plain path bit for bit.
- Gradients with respect to the points against `jax.grad`.
- `FoVOrthographicCameras`, the compositing functions, both compositors,
  `PointsRenderer` and `chamfer_distance` on `Pointclouds`.
- `gather_rows`, and the work that chip_smoke.py's bounds of the points
  kernels count.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, through its plain versions.
"""

import importlib
import importlib.util
import pathlib

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer.points.rasterize_points_pallas as rpp
from pytorch3d_tpu.loss import chamfer_distance as j_chamfer
from pytorch3d_tpu.renderer import (
    AlphaCompositor as JAlpha,
    FoVOrthographicCameras as JOrtho,
    NormWeightedCompositor as JNorm,
    PointsRasterizationSettings as JSettings,
    PointsRasterizer as JRasterizer,
    PointsRenderer as JRenderer,
    look_at_view_transform as j_look_at,
)
from pytorch3d_tpu.renderer.points import compositing as jcomp
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu_torch.common.gather import gather_rows
from pytorch3d_tpu_torch.convert import fov_orthographic_cameras_from_numpy, pointclouds_from_numpy
from pytorch3d_tpu_torch.loss import chamfer_distance
from pytorch3d_tpu_torch.renderer import (
    AlphaCompositor,
    NormWeightedCompositor,
    PointsRasterizationSettings,
    PointsRasterizer,
    PointsRenderer,
)
from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import TILE
from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import pixel_centers_ndc
from pytorch3d_tpu_torch.renderer.points import compositing as tcomp
from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as trc

# The packages' points/__init__ re-exports the function under the module's name.
jrp_mod = importlib.import_module("pytorch3d_tpu.renderer.points.rasterize_points")
trp = importlib.import_module("pytorch3d_tpu_torch.renderer.points.rasterize_points")

CPU = torch.device("cpu")


def _cloud(seed, P, rlo, rhi, zlo=-0.2):
    """(P, 3) points in [-1.2, 1.2]^2 with z from zlo up (some behind the
    camera), (P,) radii in [rlo, rhi] and a valid mask with holes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (P, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) * 2.0 + zlo
    rad = rng.uniform(rlo, rhi, P).astype(np.float32)
    return pts, rad, np.arange(P) % 7 != 0


def _crosscheck_cloud(seed, P, r, xy=0.8, z=(1.0, 3.0)):
    """tests/test_pallas_crosscheck.py:207-217's inputs."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-xy, xy, (P, 2)), rng.uniform(*z, (P, 1))], axis=1).astype(np.float32)
    return pts, np.full(P, r, np.float32), np.ones(P, bool)


def _plain(pts, rad, valid, size, K):
    idx, zbuf, dists = trp.rasterize_points_plain(
        torch.from_numpy(pts)[None], torch.from_numpy(rad)[None], torch.from_numpy(valid)[None], size, K
    )
    return idx[0].numpy(), zbuf[0].numpy(), dists[0].numpy()


def _assert_fragments(got, want, atol=1e-6):
    """Ids equal exactly; zbuf and dists within atol (the same float32
    operations in the same order on both sides)."""
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=atol)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=atol)


# test_render_points.py:209-215's regimes (points, radius range, image size),
# each at one K of {1, 4, 8, 50}.
_REGIMES = [
    (2000, 0.005, 0.02, (128, 128), 4),
    (1000, 0.01, 0.3, (96, 192), 50),  # big discs, many tiles
    (300, 0.0, 0.0, (64, 64), 1),  # zero radius: nothing covers
    (1000, 0.05, 0.05, (100, 200), 8),  # ragged tiles
]


@pytest.mark.parametrize("P,rlo,rhi,size,K", _REGIMES)
def test_plain_matches_jax_xla(P, rlo, rhi, size, K):
    pts, rad, valid = _cloud(len(_REGIMES) + P, P, rlo, rhi)
    idx_j = jrp_mod.rasterize_points_topk_xla(jnp.asarray(pts), jnp.asarray(rad), jnp.asarray(valid), size, K)
    zj, dj = jrp_mod.recompute_point_fragments(jnp.asarray(pts), idx_j, size)
    got = _plain(pts, rad, valid, size, K)
    _assert_fragments(got, (idx_j, zj, dj))
    if rhi == 0.0:
        assert (got[0] == -1).all()
    else:
        assert (got[0] >= 0).any()


@pytest.mark.parametrize("K", [1, 4, 50])
def test_plain_matches_jax_xla_crosscheck_inputs(K):
    pts, rad, valid = _crosscheck_cloud(0, 500, 0.05)
    idx_j = jrp_mod.rasterize_points_topk_xla(jnp.asarray(pts), jnp.asarray(rad), jnp.asarray(valid), (64, 64), K)
    zj, dj = jrp_mod.recompute_point_fragments(jnp.asarray(pts), idx_j, (64, 64))
    _assert_fragments(_plain(pts, rad, valid, (64, 64), K), (idx_j, zj, dj))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rpp.pl, "pallas_call", patched)


def test_plain_matches_jax_pallas_interpret(interpret_pallas):
    pts, rad, valid = _crosscheck_cloud(0, 500, 0.05)
    want = jax.jit(rpp.rasterize_points_fragments_pallas, static_argnums=(3, 4))(
        jnp.asarray(pts), jnp.asarray(rad), jnp.asarray(valid), (64, 64), 4
    )
    _assert_fragments(_plain(pts, rad, valid, (64, 64), 4), want)


def _masked_loss_grad_port(pts, rad, valid, size, K):
    """Gradient of sum(zbuf * m) + sum(dists * m) (m = filled slots) through
    the port's plain path."""
    p = torch.from_numpy(pts)[None].requires_grad_(True)
    idx, zbuf, dists = trp.rasterize_points_plain(
        p, torch.from_numpy(rad)[None], torch.from_numpy(valid)[None], size, K
    )
    m = idx >= 0
    (torch.where(m, zbuf, 0.0).sum() + torch.where(m, dists, 0.0).sum()).backward()
    return p.grad[0].numpy()


def test_gradients_match_jax_pallas_interpret(interpret_pallas):
    # test_pallas_crosscheck.py:227-262: the Pallas custom VJP (#7's body).
    pts, rad, valid = _crosscheck_cloud(1, 200, 0.08, xy=0.5, z=(1.0, 2.0))

    def loss(p):
        idx, zb, dd = rpp.rasterize_points_fragments_pallas(p, jnp.asarray(rad), jnp.asarray(valid), (32, 32), 4)
        m = idx >= 0
        return jnp.sum(jnp.where(m, zb, 0.0)) + jnp.sum(jnp.where(m, dd, 0.0))

    want = jax.jit(jax.grad(loss))(jnp.asarray(pts))
    got = _masked_loss_grad_port(pts, rad, valid, (32, 32), 4)
    # Per-point sums in another order: rtol 1e-4, atol 1e-6.
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-6)


def _hetero(seed=3, counts=(300, 120, 40)):
    """Three clouds of different counts (padding in the last two), with
    per-point radii and some points behind the camera."""
    rng = np.random.default_rng(seed)
    P = max(counts)
    pts = rng.uniform(-1.0, 1.0, (len(counts), P, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) * 3.0 - 0.3
    rad = rng.uniform(0.02, 0.12, (len(counts), P)).astype(np.float32)
    feats = rng.uniform(size=(len(counts), P, 3)).astype(np.float32)
    return pts, rad, feats, np.asarray(counts)


@pytest.mark.parametrize("K", [1, 4, 50])
def test_rasterize_points_and_gradients_match_jax(K):
    pts, rad, _, counts = _hetero()
    size = (48, 64)

    def loss_j(p):
        clouds = JPointclouds.create(p, num_points_per_cloud=jnp.asarray(counts))
        idx, zb, dd = jrp_mod.rasterize_points(clouds, size, jnp.asarray(rad), K, bin_size=0)
        m = idx >= 0
        return jnp.sum(jnp.where(m, zb, 0.0)) + jnp.sum(jnp.where(m, dd, 0.0)), (idx, zb, dd)

    (_, want), gj = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(pts))
    p = torch.from_numpy(pts).requires_grad_(True)
    clouds = pointclouds_from_numpy(pts, num_points_per_cloud=counts, device=CPU).update_padded(p)
    idx, zbuf, dists = trp.rasterize_points(clouds, size, torch.from_numpy(rad), K)  # the CPU wrapper
    _assert_fragments((idx.numpy(), zbuf.detach().numpy(), dists.detach().numpy()), want)
    m = idx >= 0
    (torch.where(m, zbuf, 0.0).sum() + torch.where(m, dists, 0.0).sum()).backward()
    # Packed ids never point at padding.
    live = clouds.points_packed_mask().numpy()
    assert live[idx.numpy()[idx.numpy() >= 0]].all()
    # Per-point sums in another order: rtol 1e-4, atol 1e-6; at K=50 the
    # JAX file's own rtol 1e-3, atol 5e-5 (test_pallas_crosscheck.py:265).
    tol = dict(rtol=1e-3, atol=5e-5) if K == 50 else dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj), **tol)


@pytest.mark.parametrize("P,rlo,rhi,size", [
    (300, 0.0, 0.0, (64, 64)),  # radius 0
    (200, 0.01, 0.3, (48, 80)),  # discs of several tiles, non-square
    (300, 0.02, 0.05, (40, 72)),  # ragged tiles
])
def test_binning_is_conservative(P, rlo, rhi, size):
    clouds = [_cloud(s, P, rlo, rhi) for s in (11, 12)]
    pts, rad, valid = (torch.from_numpy(np.stack(a)) for a in zip(*clouds))
    # Some negative radii: the disc test squares them, so the boxes use |r|.
    rad[:, ::5] = -rad[:, ::5]
    H, W = size
    K = 4
    tile_points, tile_start, n_ty, n_tx = trc.bin_points(pts, rad, valid, size)
    assert tile_start.shape == (2 * n_ty * n_tx + 1,)
    live = valid & (pts[..., 2] >= 0)
    assert len(tile_points) <= int(live.sum()) * n_ty * n_tx
    TH, TW = TILE
    for n in range(2):
        full = trp.rasterize_points_topk(pts[n], rad[n], valid[n], size, K)
        for ty in range(n_ty):
            for tx in range(n_tx):
                i = (n * n_ty + ty) * n_tx + tx
                ids = tile_points[tile_start[i] : tile_start[i + 1]].long()
                assert (ids[1:] > ids[:-1]).all()  # ascending ids: the kernel's tie order
                assert live[n][ids].all()
                listed = torch.zeros_like(valid[n])
                listed[ids] = True
                tiled = trp.rasterize_points_topk(pts[n], rad[n], listed, size, K)
                rows, cols = slice(ty * TH, (ty + 1) * TH), slice(tx * TW, (tx + 1) * TW)
                # Same candidates, same order: bit for bit.
                assert torch.equal(tiled[rows, cols], full[rows, cols]), (n, ty, tx)
    if rhi > 0:
        assert len(tile_points) < int(live.sum()) * n_ty * n_tx  # the bins do prune


def test_cpu_wrappers_run_the_plain_versions():
    pts, rad, _, counts = _hetero()
    p = torch.from_numpy(pts)
    r = torch.from_numpy(rad)
    valid = torch.arange(p.shape[1])[None] < torch.from_numpy(counts)[:, None]
    before = (trc.rasterize_points_cuda.launches, trc.rasterize_points_grad_cuda.launches)
    got = trc.rasterize_points_cuda(p, r, valid, (32, 40), 4)
    want = trp.rasterize_points_plain(p, r, valid, (32, 40), 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    gen = torch.Generator().manual_seed(0)
    gz, gd = (torch.randn(want[1].shape, generator=gen) for _ in range(2))
    idx = want[0].int()
    assert torch.equal(
        trc.rasterize_points_grad_cuda(p, idx, gz, gd, (32, 40)),
        trp.rasterize_points_grad_plain(p, idx, gz, gd, (32, 40)),
    )
    assert (trc.rasterize_points_cuda.launches, trc.rasterize_points_grad_cuda.launches) == before
    # The plain backward is autograd of the plain forward.
    pg = p.clone().requires_grad_(True)
    _, zbuf, dists = trp.rasterize_points_plain(pg, r, valid, (32, 40), 4)
    (zbuf * gz + dists * gd).sum().backward()
    np.testing.assert_allclose(
        pg.grad.numpy(), trp.rasterize_points_grad_plain(p, idx, gz, gd, (32, 40)).numpy(), rtol=1e-6, atol=1e-7
    )
    assert torch.equal(trp.rasterize_points_grad_plain(p, idx, None, None, (32, 40)), torch.zeros_like(p))


def test_radius_formats_match_jax():
    pts, rad, _, counts = _hetero()
    jc = JPointclouds.create(jnp.asarray(pts), num_points_per_cloud=jnp.asarray(counts))
    tc = pointclouds_from_numpy(pts, num_points_per_cloud=counts, device=CPU)
    for r in (0.05, np.float32([0.01, 0.02, 0.03]), rad, rad.reshape(-1)):
        want = jrp_mod._format_radius(r if isinstance(r, float) else jnp.asarray(r), jc)
        got = trp._format_radius(r if isinstance(r, float) else torch.from_numpy(r), tc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        trp._format_radius(torch.zeros(5), tc)


# --------------------------------------------------------------------------- #
# Cameras
# --------------------------------------------------------------------------- #


def _ortho_both(R=None, T=None, **bounds):
    """The same FoVOrthographicCameras in both packages: by default the
    colored-points example's pose (dist 3, elev 25) at two azimuths."""
    if R is None:
        R, T = j_look_at(dist=3.0, elev=25.0, azim=jnp.asarray([30.0, 150.0]))
    jcams = JOrtho.create(R=jnp.asarray(R), T=jnp.asarray(T), znear=0.01, **bounds)
    tcams = fov_orthographic_cameras_from_numpy(
        *(np.asarray(getattr(jcams, k)) for k in ("R", "T", "znear", "zfar", "max_y", "min_y", "max_x", "min_x", "scale_xyz")),
        device=CPU,
    )
    return jcams, tcams


@pytest.mark.parametrize("bounds", [
    {},
    dict(max_y=1.5, min_y=-0.5, max_x=2.0, min_x=-1.0, scale_xyz=((0.8, 1.2, 2.0),), zfar=20.0),
])
def test_fov_orthographic_cameras_match_jax(bounds):
    jcams, tcams = _ortho_both(**bounds)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 50, 3)).astype(np.float32)
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcams.get_projection_transform().get_matrix().numpy(),
                               np.asarray(jcams.get_projection_transform().get_matrix()), **close)
    np.testing.assert_allclose(tcams.get_full_projection_transform().get_matrix().numpy(),
                               np.asarray(jcams.get_full_projection_transform().get_matrix()), **close)
    np.testing.assert_allclose(tcams.transform_points(torch.from_numpy(x)).numpy(),
                               np.asarray(jcams.transform_points(jnp.asarray(x))), **close)
    for world in (True, False):
        for scaled in (True, False):
            np.testing.assert_allclose(
                tcams.unproject_points(torch.from_numpy(x), world_coordinates=world, scaled_depth_input=scaled).numpy(),
                np.asarray(jcams.unproject_points(jnp.asarray(x), world_coordinates=world, scaled_depth_input=scaled)),
                rtol=1e-4, atol=1e-4,
            )
    assert not tcams.is_perspective() and tcams.in_ndc() and len(tcams) == 2


# --------------------------------------------------------------------------- #
# Compositing
# --------------------------------------------------------------------------- #


def _composite_inputs(seed=4, N=2, K=5, H=6, W=7, C=3, P=40):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, P, (N, K, H, W))
    alphas = rng.uniform(0.0, 1.0, (N, K, H, W)).astype(np.float32)
    feats = rng.standard_normal((C, P)).astype(np.float32)
    return idx, alphas, feats


@pytest.mark.parametrize("name", ["alpha_composite", "norm_weighted_sum", "weighted_sum"])
def test_compositing_and_gradients_match_jax(name):
    idx, alphas, feats = _composite_inputs()
    g = np.random.default_rng(5).standard_normal((2, 3, 6, 7)).astype(np.float32)

    def loss_j(a, f):
        out = getattr(jcomp, name)(jnp.asarray(idx), a, f)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), (ga, gf) = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(alphas), jnp.asarray(feats))
    a, f = torch.from_numpy(alphas).requires_grad_(True), torch.from_numpy(feats).requires_grad_(True)
    out = getattr(tcomp, name)(torch.from_numpy(idx), a, f)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("background", [None, (0.1, 0.2, 0.3), (0.1, 0.2)])
@pytest.mark.parametrize("compositor", ["alpha", "norm"])
def test_compositors_match_jax(compositor, background):
    idx, alphas, feats = _composite_inputs(seed=6)
    idx[:, :, 0, :3] = -1  # pixels no point covers
    jcls, tcls = (JAlpha, AlphaCompositor) if compositor == "alpha" else (JNorm, NormWeightedCompositor)
    want = jcls(background_color=background)(jnp.asarray(idx), jnp.asarray(alphas), jnp.asarray(feats))
    got = tcls(background_color=background)(torch.from_numpy(idx), torch.from_numpy(alphas), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # The background given at call time wins.
    want = jcls()(jnp.asarray(idx), jnp.asarray(alphas), jnp.asarray(feats), background_color=(1.0, 1.0, 1.0))
    got = tcls()(torch.from_numpy(idx), torch.from_numpy(alphas), torch.from_numpy(feats), background_color=(1.0, 1.0, 1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# PointsRenderer and chamfer on Pointclouds
# --------------------------------------------------------------------------- #


def _scene(P=1500, seed=7):
    """A torus-like ring of points coloured by position (the colored-points
    example's scene at a small size)."""
    rng = np.random.default_rng(seed)
    theta, phi = rng.uniform(0, 2 * np.pi, (2, P))
    pts = np.stack([(1.0 + 0.35 * np.cos(theta)) * np.cos(phi), (1.0 + 0.35 * np.cos(theta)) * np.sin(phi),
                    0.35 * np.sin(theta)], axis=-1).astype(np.float32)
    rgb = ((pts - pts.min(0)) / (pts.max(0) - pts.min(0))).astype(np.float32)
    return pts, rgb


# Two poses whose transforms are exact in float32 (a quarter turn about z,
# unit scales), so both packages rasterize the same NDC points: the look-at
# pose of the example rounds differently in the two (an ulp in ~30 % of the
# coordinates), and 1 - d/r^2 turns an ulp into ~5e-6 of a weight, which a
# normalized sum over tiny weights at a disc's rim can push past 1e-5.
_EXACT_R = np.asarray([np.eye(3), [[0, 1, 0], [-1, 0, 0], [0, 0, 1]]], np.float32)
_EXACT_T = np.asarray([[0.0, 0.0, 3.0], [0.25, -0.5, 3.0]], np.float32)


@pytest.mark.parametrize("compositor,per_point_radius", [("alpha", False), ("norm", True)])
def test_points_renderer_and_gradients_match_jax(compositor, per_point_radius):
    pts, rgb = _scene()
    jcams, tcams = _ortho_both(_EXACT_R, _EXACT_T)
    radius = (np.random.default_rng(8).uniform(0.03, 0.06, (2, len(pts))).astype(np.float32)
              if per_point_radius else 0.04)
    jcls, tcls = (JAlpha, AlphaCompositor) if compositor == "alpha" else (JNorm, NormWeightedCompositor)
    g = np.random.default_rng(9).standard_normal((2, 48, 48, 3)).astype(np.float32)

    def loss_j(p, f):
        clouds = JPointclouds.create(jnp.broadcast_to(p, (2, *p.shape)), features=jnp.broadcast_to(f, (2, *f.shape)))
        settings = JSettings(image_size=48, radius=radius if per_point_radius is False else jnp.asarray(radius),
                             points_per_pixel=4, bin_size=0)
        images = JRenderer(JRasterizer(jcams, settings), jcls())(clouds)
        return jnp.sum(images * jnp.asarray(g)), images

    (_, want), (gp_j, gf_j) = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(pts), jnp.asarray(rgb))

    p, f = torch.from_numpy(pts).requires_grad_(True), torch.from_numpy(rgb).requires_grad_(True)
    clouds = pointclouds_from_numpy(pts[None], features=rgb[None], device=CPU).extend(2)
    clouds = clouds.update_padded(p.expand(2, -1, -1), new_features_padded=f.expand(2, -1, -1))
    settings = PointsRasterizationSettings(
        image_size=48, radius=torch.from_numpy(radius) if per_point_radius else radius, points_per_pixel=4
    )
    images = PointsRenderer(PointsRasterizer(tcams, settings), tcls())(clouds)
    (images * torch.from_numpy(g)).sum().backward()
    assert images.shape == (2, 48, 48, 3)
    assert float((images.detach().sum(-1) > 0.05).float().mean()) > 0.05
    np.testing.assert_allclose(images.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf_j), rtol=1e-4, atol=1e-5)
    # Point gradients sum over pixels in another order: relative to their scale.
    scale = float(np.abs(np.asarray(gp_j)).max())
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_j), rtol=1e-4, atol=1e-5 * scale)


def test_chamfer_on_pointclouds_matches_jax():
    rng = np.random.default_rng(10)
    counts_x, counts_y = np.asarray([40, 25]), np.asarray([30, 55])
    x, y = (rng.standard_normal((2, 55, 3)).astype(np.float32) for _ in range(2))
    xn, yn = (rng.standard_normal((2, 55, 3)).astype(np.float32) for _ in range(2))

    def loss_j(a, b):
        cx = JPointclouds.create(a, normals=jnp.asarray(xn), num_points_per_cloud=jnp.asarray(counts_x))
        cy = JPointclouds.create(b, normals=jnp.asarray(yn), num_points_per_cloud=jnp.asarray(counts_y))
        loss, loss_n = j_chamfer(cx, cy)
        return loss + loss_n

    want, (gx, gy) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(y))
    a, b = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    cx = pointclouds_from_numpy(x, normals=xn, num_points_per_cloud=counts_x, device=CPU).update_padded(a)
    cy = pointclouds_from_numpy(y, normals=yn, num_points_per_cloud=counts_y, device=CPU).update_padded(b)
    loss, loss_n = chamfer_distance(cx, cy)
    (loss + loss_n).backward()
    np.testing.assert_allclose((loss + loss_n).item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gy), rtol=1e-4, atol=1e-6)


def test_gather_rows_reads_live_ids_and_spreads_empty_ones():
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.standard_normal((7, 2, 3)).astype(np.float32)).requires_grad_(True)
    ids = torch.from_numpy(rng.integers(-1, 7, (4, 5, 6)))
    live = ids >= 0
    got = gather_rows(table, ids)
    assert got.shape == (4, 5, 6, 2, 3)
    torch.testing.assert_close(got[live], table[ids[live]], rtol=0, atol=0)
    # Empty ids read rows of the table, spread over it (not all row 0).
    rows = {tuple(r.flatten().tolist()) for r in got[~live].detach()}
    assert len(rows) > 1 and rows <= {tuple(r.flatten().tolist()) for r in table.detach()}
    # Masked by the caller, empty slots add nothing to the gradient.
    g = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    (torch.where(live[..., None, None], got, 0.0) * g).sum().backward()
    expect = torch.zeros_like(table).index_add_(0, ids[live], g[live])
    torch.testing.assert_close(table.grad, expect)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_points_bounds_count_the_functions_work():
    """chip_smoke.py's bounds of the points kernels count the work of the
    function, not of the kernel: the pixel centres inside each live point's
    box (brute force here), and for the backward x and y of the points held
    by filled slots with a nonzero dists cotangent."""
    cs = _chip_smoke()
    rng = np.random.default_rng(12)
    N, P, size = 2, 60, (20, 30)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (N, P, 3)).astype(np.float32))
    rad = torch.from_numpy(rng.uniform(-0.1, 0.3, (N, P)).astype(np.float32))
    rad[0, :5] = 0.0
    valid = torch.from_numpy(np.arange(N * P).reshape(N, P) % 5 != 0)
    pxy = pixel_centers_ndc(*size, CPU)  # (H, W, 2)
    live = valid & (pts[..., 2] >= 0)
    inside = ((pxy[None, None, :, :, 0] - pts[..., 0, None, None]).abs() <= rad.abs()[..., None, None]) & (
        (pxy[None, None, :, :, 1] - pts[..., 1, None, None]).abs() <= rad.abs()[..., None, None]
    )
    want = float((inside & live[..., None, None]).sum())
    assert want > 0
    assert cs.points_box_tests(pts, rad, valid, size) == want
    K = 3
    idx, _, _ = trp.rasterize_points_plain(pts, rad, valid, size, K)
    filled = int((idx >= 0).sum())
    bound, by, tests, nbytes = cs.points_fine_bound(pts, rad, valid, size, K, filled)
    assert tests == want and nbytes == N * P * 17 + N * size[0] * size[1] * K * 12
    assert bound == pytest.approx(1e3 * max(nbytes / cs.PEAK_BYTES_PER_S,
                                            (want * cs.POINTS_OPS_PER_CANDIDATE + filled * K) / cs.PEAK_FP32_OPS_PER_S))
    gd = torch.from_numpy(rng.standard_normal(idx.shape).astype(np.float32))
    gd[..., 0] = 0.0
    held = (idx >= 0) & (gd != 0)
    touched = len({(n, int(p)) for n in range(N) for p in idx[n][held[n]]})
    _, _, got_filled, grad_bytes = cs.points_grad_bound(pts, idx, (None, gd))
    assert got_filled == filled
    assert grad_bytes == idx.numel() * 4 + filled * 4 + touched * 8 + N * P * 3 * 4
