"""The port's implicit-rendering pieces of the NeRF path against the JAX
package: the harmonic embedding, ray points, `unproject_points`, the NDC
grid and Monte Carlo samplers (with the JAX package's draws handed in),
`_shifted_cumprod`, `sample_pdf` (deterministic and with draws), grid
sampling of target images, the NeRF raymarcher and metrics, and the chunked
evaluation sampler's clamped last chunk.

Inputs are made with numpy from a seed (or drawn by `jax.random` and passed
as numpy) and handed to both packages; the port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.models.nerf.raymarcher import EmissionAbsorptionNeRFRaymarcher as JMarcher
from pytorch3d_tpu.models.nerf.raysampler import NeRFRaysampler as JNeRFSampler
from pytorch3d_tpu.models.nerf.utils import calc_mse as j_mse
from pytorch3d_tpu.models.nerf.utils import calc_psnr as j_psnr
from pytorch3d_tpu.models.nerf.utils import sample_images_at_mc_locs as j_sample_images
from pytorch3d_tpu.ops.grid_sample import grid_sample as j_grid_sample
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JPersp
from pytorch3d_tpu.renderer import look_at_view_transform as j_look_at
from pytorch3d_tpu.renderer.implicit.harmonic_embedding import HarmonicEmbedding as JEmbed
from pytorch3d_tpu.renderer.implicit.raymarching import _shifted_cumprod as j_shifted_cumprod
from pytorch3d_tpu.renderer.implicit.raysampling import MonteCarloRaysampler as JMC
from pytorch3d_tpu.renderer.implicit.raysampling import NDCMultinomialRaysampler as JNDC
from pytorch3d_tpu.renderer.implicit.sample_pdf import sample_pdf as j_sample_pdf
from pytorch3d_tpu.renderer.implicit.utils import RayBundle as JBundle
from pytorch3d_tpu.renderer.implicit.utils import ray_bundle_to_ray_points as j_ray_points
from pytorch3d_tpu_torch.convert import fov_perspective_cameras_from_numpy
from pytorch3d_tpu_torch.models.nerf import EmissionAbsorptionNeRFRaymarcher, NeRFRaysampler
from pytorch3d_tpu_torch.models.nerf.utils import calc_mse, calc_psnr, sample_images_at_mc_locs
from pytorch3d_tpu_torch.renderer.implicit import (
    HarmonicEmbedding,
    MonteCarloRaysampler,
    NDCMultinomialRaysampler,
    RayBundle,
    ray_bundle_to_ray_points,
    sample_pdf,
    sample_pdf_with_draws,
)
from pytorch3d_tpu_torch.renderer.implicit.raymarching import _shifted_cumprod

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

# float32 on both sides, the same formulas: 1e-6 of the values' magnitude
# unless a test says otherwise.
TOL = 1e-6


def _close(got, want, tol=TOL, scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    s = max(np.abs(want).max(), 1e-30) if scale is None else scale
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol * s, (err, s)


def _cameras(n=2, znear=1.0, zfar=4.5, fov=60.0):
    """Both packages' FoVPerspectiveCameras at the same look-at poses."""
    R, T = j_look_at(dist=2.7, elev=np.linspace(10.0, 30.0, n), azim=np.linspace(-40.0, 50.0, n))
    R, T = np.asarray(R), np.asarray(T)
    jc = JPersp.create(R=jnp.asarray(R), T=jnp.asarray(T), znear=znear, zfar=zfar, fov=fov)
    tc = fov_perspective_cameras_from_numpy(
        R, T, np.full(n, znear, np.float32), np.full(n, zfar, np.float32),
        np.ones(n, np.float32), np.full(n, fov, np.float32), device="cpu",
    )
    return jc, tc


def _bundles_close(tb, jb, tol=1e-5):
    # Rays come out of a 4x4 inverse that the two packages compute in their
    # own order: directions agree to ~1e-6 of the scene's extent.
    for name in ("origins", "directions", "lengths", "xys"):
        _close(getattr(tb, name), getattr(jb, name), tol)


@pytest.mark.parametrize("n_harmonics,append", [(6, True), (4, True), (3, False)])
def test_harmonic_embedding(n_harmonics, append):
    x = np.random.RandomState(0).uniform(-3, 3, (5, 7, 3)).astype(np.float32)
    want = JEmbed(n_harmonics, append_input=append)(jnp.asarray(x))
    emb = HarmonicEmbedding(n_harmonics, append_input=append)
    got = emb(torch.tensor(x))
    assert emb.get_output_dim(3) == want.shape[-1]
    # sin/cos of arguments up to 3 * 2^5 = 96: 1e-6 of the values' magnitude
    # plus the ulp of the argument (~8e-6 at 96).
    _close(got, want, 1e-5)
    # the integrated (mip-NeRF) embedding: each sin / cos damped by exp(-f^2 var / 2)
    var = np.random.RandomState(1).uniform(0, 0.01, (5, 7, 3)).astype(np.float32)
    _close(emb(torch.tensor(x), diag_cov=torch.tensor(var)),
           JEmbed(n_harmonics, append_input=append)(jnp.asarray(x), diag_cov=jnp.asarray(var)), 1e-5)


def test_ray_bundle_to_ray_points():
    rng = np.random.RandomState(1)
    o, d, l = rng.randn(2, 5, 3), rng.randn(2, 5, 3), rng.rand(2, 5, 8)
    o, d, l = (a.astype(np.float32) for a in (o, d, l))
    want = j_ray_points(JBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(l), jnp.zeros((2, 5, 2))))
    got = ray_bundle_to_ray_points(RayBundle(torch.tensor(o), torch.tensor(d), torch.tensor(l), torch.zeros(2, 5, 2)))
    _close(got, want)


@pytest.mark.parametrize("world", [True, False])
def test_unproject_points(world):
    jc, tc = _cameras()
    rng = np.random.RandomState(2)
    xy_depth = np.concatenate([rng.uniform(-1, 1, (2, 50, 2)), rng.uniform(1.0, 4.5, (2, 50, 1))], -1).astype(np.float32)
    want = jc.unproject_points(jnp.asarray(xy_depth), world_coordinates=world)
    got = tc.unproject_points(torch.tensor(xy_depth), world_coordinates=world)
    _close(got, want, 1e-5)
    # and back through the projection: NDC x, y and the depth's NDC z
    if world:
        back = tc.transform_points(got)
        _close(back[..., :2], xy_depth[..., :2], 1e-5, scale=1.0)


@pytest.mark.parametrize("width,height", [(16, 16), (20, 12), (12, 20)])
def test_ndc_grid_sampler(width, height):
    jc, tc = _cameras()
    jb = JNDC(image_width=width, image_height=height, n_pts_per_ray=8, min_depth=1.0, max_depth=4.5)(jc)
    tb = NDCMultinomialRaysampler(image_width=width, image_height=height, n_pts_per_ray=8, min_depth=1.0,
                                  max_depth=4.5)(tc)
    assert tb.origins.shape == (2, height, width, 3)
    _bundles_close(tb, jb)


def test_ndc_grid_sampler_stratified_with_draws():
    jc, tc = _cameras()
    key = jax.random.PRNGKey(3)
    jb = JNDC(image_width=16, image_height=12, n_pts_per_ray=8, min_depth=1.0, max_depth=4.5,
              stratified_sampling=True)(jc, key=key)
    # MultinomialRaysampler: key_sel, key_strat = split(key); the jiggle
    # draws uniform(key_strat, (B, H * W, S)).
    _, key_strat = jax.random.split(key)
    u = np.asarray(jax.random.uniform(key_strat, (2, 12 * 16, 8), jnp.float32)).reshape(2, 12, 16, 8)
    tb = NDCMultinomialRaysampler(image_width=16, image_height=12, n_pts_per_ray=8, min_depth=1.0, max_depth=4.5,
                                  stratified_sampling=True)(tc, u_jiggle=torch.tensor(u))
    _bundles_close(tb, jb)
    # drawn from a generator: stratified depths stay inside their strata
    tg = NDCMultinomialRaysampler(image_width=16, image_height=12, n_pts_per_ray=8, min_depth=1.0, max_depth=4.5,
                                  stratified_sampling=True)(tc, generator=torch.Generator().manual_seed(0))
    edges = np.linspace(1.0, 4.5, 8)
    mids = np.concatenate([[1.0], 0.5 * (edges[1:] + edges[:-1]), [4.5]])
    lengths = tg.lengths.numpy()
    assert (lengths >= mids[:-1] - 1e-6).all() and (lengths <= mids[1:] + 1e-6).all()


@pytest.mark.parametrize("stratified", [False, True])
def test_monte_carlo_sampler_with_draws(stratified):
    jc, tc = _cameras()
    key = jax.random.PRNGKey(4)
    jb = JMC(-1.0, 1.0, -1.0, 1.0, 64, 8, 1.0, 4.5)(jc, stratified_sampling=stratified, key=key)
    # MonteCarloRaysampler: key_xy, key_strat = split(key).
    key_xy, key_strat = jax.random.split(key)
    u_xy = torch.tensor(np.asarray(jax.random.uniform(key_xy, (2, 64, 2), jnp.float32)))
    u_jig = torch.tensor(np.asarray(jax.random.uniform(key_strat, (2, 64, 8), jnp.float32))) if stratified else None
    sampler = MonteCarloRaysampler(-1.0, 1.0, -1.0, 1.0, 64, 8, 1.0, 4.5, stratified_sampling=stratified)
    _bundles_close(sampler.with_draws(tc, u_xy, u_jig), jb)
    drawn = sampler(tc, generator=torch.Generator().manual_seed(0))
    assert drawn.xys.shape == (2, 64, 2) and drawn.xys.abs().max() <= 1.0


def test_shifted_cumprod():
    x = np.random.RandomState(5).uniform(0.5, 1.0, (3, 4, 9)).astype(np.float32)
    for shift in (1, 2):
        _close(_shifted_cumprod(torch.tensor(x), shift), j_shifted_cumprod(jnp.asarray(x), shift))


def _pdf_inputs(rng, rows=300, n_bins=15, dtype=np.float32):
    bins = np.sort(rng.uniform(0.5, 4.5, (rows, n_bins + 1)), axis=-1).astype(dtype)
    weights = rng.uniform(0.0, 1.0, (rows, n_bins)).astype(dtype)
    return bins, weights


def test_sample_pdf_deterministic():
    bins, weights = _pdf_inputs(np.random.RandomState(6))
    want = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 16, det=True)
    got = sample_pdf(torch.tensor(bins), torch.tensor(weights), 16, det=True)
    # Samples are bins + t * width with t = (u - cdf0) / pdf: the cdf's
    # float32 rounding (sums in another order) scaled by 1 / pdf >= 1 / 0.2.
    _close(got, want, 1e-5)


def test_sample_pdf_with_draws():
    bins, weights = _pdf_inputs(np.random.RandomState(7))
    key = jax.random.PRNGKey(8)
    want = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 16, det=False, key=key)
    u = np.asarray(jax.random.uniform(key, (300, 16), jnp.float32))
    got = sample_pdf_with_draws(torch.tensor(bins), torch.tensor(weights), torch.tensor(u))
    _close(got, want, 1e-5)
    drawn = sample_pdf(torch.tensor(bins), torch.tensor(weights), 16, generator=torch.Generator().manual_seed(0))
    assert (drawn >= torch.tensor(bins)[:, :1]).all() and (drawn <= torch.tensor(bins)[:, -1:]).all()


def test_sample_pdf_near_empty_bins_in_float64():
    """With near-empty bins (pdf ~ eps) the samples are discontinuous in the
    cdf: t = (u - cdf0) / pdf, and the `denom < eps` branch.  float32 cdfs
    summed in another order differ by ~3e-7 and move samples by percents of
    a bin, so the algorithm is compared in float64, where both packages'
    cdfs agree to ~1e-16.  One discontinuity remains at any precision: the
    deterministic last quantile u = 1 lands on the last edge when the cdf's
    last entry rounds to <= 1 and, when the last bin's pdf is below eps, on
    the edge before it when that entry rounds to just above 1."""
    rng = np.random.RandomState(9)
    bins, weights = _pdf_inputs(rng, dtype=np.float64)
    weights = weights ** 8
    weights[:100] *= 1e-6
    u = rng.uniform(0.0, 1.0, (300, 16))
    with jax.enable_x64(True):
        want_det = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 16, det=True)
        key = jax.random.PRNGKey(10)
        want = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 16, det=False, key=key)
        u = np.asarray(jax.random.uniform(key, (300, 16), jnp.float64))
    got_det = sample_pdf(torch.tensor(bins), torch.tensor(weights), 16, det=True).numpy()
    got = sample_pdf_with_draws(torch.tensor(bins), torch.tensor(weights), torch.tensor(u))
    _close(got, want, 1e-9)
    _close(got_det[:, :-1], np.asarray(want_det)[:, :-1], 1e-9)
    w = weights + 1e-5
    pdf_last = w[:, -1] / w.sum(-1)
    sure = pdf_last >= 2e-5
    _close(got_det[sure, -1], np.asarray(want_det)[sure, -1], 1e-9)
    near_edge = np.minimum(np.abs(got_det[~sure, -1] - bins[~sure, -1]), np.abs(got_det[~sure, -1] - bins[~sure, -2]))
    assert near_edge.max() <= 1e-4, near_edge.max()


def test_grid_sample_border_matches_jax():
    rng = np.random.RandomState(11)
    images = rng.rand(2, 3, 9, 13).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 7, 2)).astype(np.float32)  # some outside [-1, 1]
    want = j_grid_sample(jnp.asarray(images), jnp.asarray(grid), mode="bilinear", padding_mode="border",
                         align_corners=False)
    got = torch.nn.functional.grid_sample(torch.tensor(images), torch.tensor(grid), mode="bilinear",
                                          padding_mode="border", align_corners=False)
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 50), (2, 4, 6)])
def test_sample_images_at_mc_locs(shape):
    rng = np.random.RandomState(12)
    images = rng.rand(2, 16, 24, 3).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, shape + (2,)).astype(np.float32)
    want = j_sample_images(jnp.asarray(images), jnp.asarray(xy))
    got = sample_images_at_mc_locs(torch.tensor(images), torch.tensor(xy))
    _close(got, want)


def test_nerf_raymarcher_and_metrics():
    rng = np.random.RandomState(13)
    dens = rng.rand(3, 10, 12, 1).astype(np.float32)
    feats = rng.rand(3, 10, 12, 3).astype(np.float32)
    jf, jw = JMarcher()(jnp.asarray(dens), jnp.asarray(feats))
    tf, tw = EmissionAbsorptionNeRFRaymarcher()(torch.tensor(dens), torch.tensor(feats))
    _close(tf, jf)
    _close(tw, jw)
    a, b = rng.rand(4, 3).astype(np.float32), rng.rand(4, 3).astype(np.float32)
    _close(calc_mse(torch.tensor(a), torch.tensor(b)), j_mse(jnp.asarray(a), jnp.asarray(b)))
    _close(calc_psnr(torch.tensor(a), torch.tensor(b)), j_psnr(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("chunk_idx", [0, 3, 4])
def test_chunked_eval_clamps_the_last_chunk(chunk_idx):
    """12 x 10 = 120 rays in chunks of 32: JAX's dynamic_slice clamps the
    start of chunk 3 (96) to 88, so the last chunk repeats rays 88..95 of
    chunk 2 instead of coming back short; a chunk index past the end clamps
    the same way."""
    jc, tc = _cameras(n=1)
    kw = dict(n_pts_per_ray=8, min_depth=1.0, max_depth=4.5, n_rays_per_image=64, image_width=12, image_height=10)
    jb = JNeRFSampler(**kw)(jc, chunksize=32, chunk_idx=chunk_idx, training=False)
    sampler = NeRFRaysampler(**kw)
    tb = sampler(tc, chunksize=32, chunk_idx=chunk_idx, training=False)
    assert tb.origins.shape == (1, 32, 3)
    _bundles_close(tb, jb)
    assert sampler.get_n_chunks(32, 1) == 4
    if chunk_idx >= 3:
        full = sampler(tc, training=False)
        _close(tb.xys, full.xys.reshape(1, -1, 2)[:, 88:120])
