"""The port's implicit and volume renderers against the JAX package's: the
two raymarchers, grid subsampling (mask-weighted, without replacement, with
replacement) and `n_rays_total` bundles of both samplers with the JAX
package's draws handed in, `VolumeRenderer` on a small volume (images and
gradients to the densities and features), `ImplicitRenderer` around the
port's `NeuralRadianceField` (weights from `nerf_state_dict_from_flax`),
the integrated (mip-NeRF) embedding, `sample_pdf_python`, and `remat`
against JAX's `remat=True` and the port's own `remat=False`.

Inputs are made with numpy from a seed, or drawn by `jax.random` and passed
as numpy; the port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pytorch3d_tpu.models.nerf.implicit_function import NeuralRadianceField as JField
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JPersp
from pytorch3d_tpu.renderer import look_at_view_transform as j_look_at
from pytorch3d_tpu.renderer.implicit import AbsorptionOnlyRaymarcher as JAbsorption
from pytorch3d_tpu.renderer.implicit import EmissionAbsorptionRaymarcher as JEA
from pytorch3d_tpu.renderer.implicit import HarmonicEmbedding as JEmbed
from pytorch3d_tpu.renderer.implicit import ImplicitRenderer as JImplicitRenderer
from pytorch3d_tpu.renderer.implicit import MonteCarloRaysampler as JMC
from pytorch3d_tpu.renderer.implicit import NDCMultinomialRaysampler as JNDC
from pytorch3d_tpu.renderer.implicit import VolumeRenderer as JVolumeRenderer
from pytorch3d_tpu.renderer.implicit import sample_pdf_python as j_sample_pdf_python
from pytorch3d_tpu.structures import Volumes as JVolumes
from pytorch3d_tpu_torch.convert import fov_perspective_cameras_from_numpy, nerf_state_dict_from_flax
from pytorch3d_tpu_torch.models import NeuralRadianceField, RadianceFieldRenderer
from pytorch3d_tpu_torch.renderer.implicit import (
    AbsorptionOnlyRaymarcher,
    EmissionAbsorptionRaymarcher,
    GridRaysampler,
    HarmonicEmbedding,
    HeterogeneousRayBundle,
    ImplicitRenderer,
    MonteCarloRaysampler,
    NDCGridRaysampler,
    NDCMultinomialRaysampler,
    VolumeRenderer,
    sample_pdf_python,
)
from pytorch3d_tpu_torch.structures import Volumes

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

# float32 on both sides, the same formulas in another order: 1e-5 of the
# values' (or gradients') magnitude unless a test says otherwise.  Rays come
# out of a 4x4 inverse each package computes in its own order, ~1e-6 of the
# scene's extent.
TOL = 1e-5
W, H, S = 12, 10, 8  # the grid samplers' image and points per ray


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a):
    return torch.tensor(np.asarray(a))


def _cameras(n=2, znear=1.0, zfar=4.5, fov=60.0):
    """Both packages' FoVPerspectiveCameras at the same look-at poses."""
    R, T = j_look_at(dist=2.7, elev=np.linspace(10.0, 30.0, n), azim=np.linspace(-40.0, 50.0, n))
    R, T = np.asarray(R), np.asarray(T)
    jc = JPersp.create(R=jnp.asarray(R), T=jnp.asarray(T), znear=znear, zfar=zfar, fov=fov)
    tc = fov_perspective_cameras_from_numpy(
        R, T, np.full(n, znear, np.float32), np.full(n, zfar, np.float32), np.ones(n, np.float32),
        np.full(n, fov, np.float32), device="cpu",
    )
    return jc, tc


def _bundles_close(tb, jb):
    for name in ("origins", "directions", "lengths", "xys"):
        assert _err(getattr(tb, name), getattr(jb, name)) <= TOL, name


@pytest.mark.parametrize("thickness", [1, 2])
def test_emission_absorption_raymarcher(thickness):
    rng = np.random.RandomState(0)
    dens = rng.uniform(0.05, 0.95, (2, 7, S, 1)).astype(np.float32)
    feats = rng.randn(2, 7, S, 3).astype(np.float32)
    cot = rng.randn(2, 7, 4).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda d, f: JEA(thickness)(d, f)), jnp.asarray(dens), jnp.asarray(feats))
    jd, jf = vjp(jnp.asarray(cot))
    td, tf = _t(dens).requires_grad_(True), _t(feats).requires_grad_(True)
    got = EmissionAbsorptionRaymarcher(thickness)(rays_densities=td, rays_features=tf)
    got.backward(_t(cot))
    assert got.shape == (2, 7, 4)
    assert _err(got, want) <= TOL and _err(td.grad, jd) <= TOL and _err(tf.grad, jf) <= TOL
    with pytest.raises(ValueError):
        EmissionAbsorptionRaymarcher()(td[..., 0], tf)


def test_absorption_only_raymarcher():
    rng = np.random.RandomState(1)
    dens = rng.uniform(-0.2, 1.2, (3, 5, S, 1)).astype(np.float32)  # some clamped
    cot = rng.randn(3, 5, 1).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda d: JAbsorption()(d)), jnp.asarray(dens))
    td = _t(dens).requires_grad_(True)
    got = AbsorptionOnlyRaymarcher()(rays_densities=td)
    got.backward(_t(cot))
    assert _err(got, want) <= TOL and _err(td.grad, vjp(jnp.asarray(cot))[0]) <= TOL


def _permutation_keys(keys, n):
    """The sort keys jax.random.permutation(k, n) sorts by, for each key k,
    for n small enough that it takes one round of its shuffle."""
    assert int(np.ceil(3 * np.log(n) / np.log(np.iinfo(np.uint32).max))) == 1
    bits = jax.vmap(lambda k: jax.random.bits(jax.random.split(k)[1], (n,), jnp.uint32))(keys)
    return np.asarray(bits).astype(np.int64)


def _select_draws(key_sel, B, n, masked):
    """The subsampling draws the JAX grid sampler takes from key_sel: per
    image, Gumbel noise (masked), permutation sort keys (n <= H*W) or
    randint indices (n > H*W)."""
    keys = jax.random.split(key_sel, B)
    if masked:
        return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n, H * W), jnp.float32))(keys))
    if n <= H * W:
        return _permutation_keys(keys, H * W)
    return np.asarray(jax.vmap(lambda k: jax.random.randint(k, (n,), 0, H * W))(keys)).astype(np.int64)


@pytest.mark.parametrize("n_rays,masked,stratified", [(40, True, True), (40, False, False), (300, False, True)])
def test_grid_subsampling_with_jax_draws(n_rays, masked, stratified):
    jc, tc = _cameras()
    key = jax.random.PRNGKey(3)
    mask = (np.random.RandomState(2).uniform(0, 1, (2, H, W)) > 0.6).astype(np.float32) if masked else None
    kw = dict(image_width=W, image_height=H, n_pts_per_ray=S, min_depth=1.0, max_depth=4.5,
              n_rays_per_image=n_rays, stratified_sampling=stratified)
    jb = jax.jit(lambda c, m, k: JNDC(**kw)(c, mask=m, key=k))(jc, None if mask is None else jnp.asarray(mask), key)
    key_sel, key_strat = jax.random.split(key)
    u_jiggle = jax.random.uniform(key_strat, (2, n_rays, S), jnp.float32) if stratified else None
    tb = NDCMultinomialRaysampler(**kw)(
        tc, mask=None if mask is None else _t(mask), select=_t(_select_draws(key_sel, 2, n_rays, masked)),
        u_jiggle=None if u_jiggle is None else _t(u_jiggle),
    )
    assert tb.xys.shape == (2, n_rays, 2)
    _bundles_close(tb, jb)
    if masked:  # every chosen ray lies where the mask is set
        assert np.isin(tb.xys.numpy().reshape(-1, 2).round(5),
                       NDCMultinomialRaysampler(**{**kw, "n_rays_per_image": None})(tc).xys.numpy()
                       .reshape(2, -1, 2)[mask.reshape(2, -1) > 0].round(5)).all()
    drawn = NDCMultinomialRaysampler(**kw)(tc, mask=None if mask is None else _t(mask),
                                           generator=torch.Generator().manual_seed(0))
    assert drawn.lengths.shape == (2, n_rays, S)
    if not masked and n_rays <= H * W:  # no replacement: each image's rays distinct
        assert all(len(np.unique(xy, axis=0)) == n_rays for xy in drawn.xys.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_grid_n_rays_total_with_jax_draws(masked):
    jc, tc = _cameras(n=3)
    key = jax.random.PRNGKey(4)
    n_total = 24
    mask = (np.random.RandomState(5).uniform(0, 1, (3, H, W)) > 0.5).astype(np.float32) if masked else None
    kw = dict(image_width=W, image_height=H, n_pts_per_ray=S, min_depth=1.0, max_depth=4.5, n_rays_total=n_total)
    jb = jax.jit(lambda c, m, k: JNDC(**kw)(c, mask=m, key=k))(jc, None if mask is None else jnp.asarray(mask), key)
    key_cam, key = jax.random.split(key)
    ids = np.asarray(jax.random.randint(key_cam, (n_total,), 0, 3)).astype(np.int64)
    key_sel, _ = jax.random.split(key)
    tb = NDCMultinomialRaysampler(**kw)(tc, mask=None if mask is None else _t(mask), camera_ids=_t(ids),
                                        select=_t(_select_draws(key_sel, n_total, 1, masked)))
    assert isinstance(tb, HeterogeneousRayBundle) and tb.origins.shape == (n_total, 1, 3)
    _bundles_close(tb, jb)
    assert tb.camera_ids.tolist() == np.asarray(jb.camera_ids).tolist()
    assert tb.camera_counts.tolist() == np.asarray(jb.camera_counts).tolist()
    with pytest.raises(ValueError):
        NDCMultinomialRaysampler(**kw)(tc, n_rays_per_image=4)
    drawn = NDCMultinomialRaysampler(**kw)(tc, generator=torch.Generator().manual_seed(1))
    assert int(drawn.camera_counts.sum()) == n_total and drawn.xys.shape == (n_total, 1, 2)


def test_monte_carlo_n_rays_total_with_jax_draws():
    jc, tc = _cameras(n=3)
    key = jax.random.PRNGKey(6)
    kw = dict(n_rays_total=30, stratified_sampling=True)
    jb = jax.jit(lambda c, k: JMC(-1.0, 1.0, -0.8, 0.9, 16, S, 1.0, 4.5, **kw)(c, key=k))(jc, key)
    key_cam, key = jax.random.split(key)
    ids = np.asarray(jax.random.randint(key_cam, (30,), 0, 3)).astype(np.int64)
    key_xy, key_strat = jax.random.split(key)
    sampler = MonteCarloRaysampler(-1.0, 1.0, -0.8, 0.9, 16, S, 1.0, 4.5, **kw)
    tb = sampler.with_draws(tc, _t(jax.random.uniform(key_xy, (30, 1, 2))),
                            _t(jax.random.uniform(key_strat, (30, 1, S))), camera_ids=_t(ids))
    _bundles_close(tb, jb)
    assert tb.camera_counts.tolist() == np.asarray(jb.camera_counts).tolist()
    drawn = sampler(tc, generator=torch.Generator().manual_seed(2))
    assert isinstance(drawn, HeterogeneousRayBundle) and drawn.lengths.shape == (30, 1, S)


def test_deprecated_factories():
    _, tc = _cameras()
    with pytest.warns(PendingDeprecationWarning):
        grid = GridRaysampler(-1.0, 1.0, -1.0, 1.0, W, H, S, 1.0, 4.5)
    with pytest.warns(PendingDeprecationWarning):
        ndc = NDCGridRaysampler(W, H, S, 1.0, 4.5)
    assert grid(tc).lengths.shape == ndc(tc).lengths.shape == (2, H, W, S)


def test_volume_renderer():
    """A 12^3 volume (voxel 0.2, off-centre) seen by two cameras: images and
    the gradients to its densities and features.  Without features the
    render is the opacity channel alone, with the same densities' gradient
    through it."""
    jc, tc = _cameras()
    rng = np.random.RandomState(7)
    dens = rng.uniform(0, 0.3, (2, 1, 12, 12, 12)).astype(np.float32)
    feats = rng.uniform(0, 1, (2, 3, 12, 12, 12)).astype(np.float32)
    kw = dict(voxel_size=0.2, volume_translation=(0.1, -0.05, 0.0))
    cot = rng.randn(2, H, W, 4).astype(np.float32)
    raysampler = dict(image_width=W, image_height=H, n_pts_per_ray=S, min_depth=1.5, max_depth=4.0)
    jren = JVolumeRenderer(JNDC(**raysampler), JEA())
    want, vjp = jax.vjp(jax.jit(lambda d, f: jren(cameras=jc, volumes=JVolumes.create(d, f, **kw))[0]),
                        jnp.asarray(dens), jnp.asarray(feats))
    jgrads = vjp(jnp.asarray(cot))
    renderer = VolumeRenderer(NDCMultinomialRaysampler(**raysampler), EmissionAbsorptionRaymarcher())
    td, tf = _t(dens).requires_grad_(True), _t(feats).requires_grad_(True)
    images, bundle = renderer(cameras=tc, volumes=Volumes.create(td, tf, device="cpu", **kw))
    assert images.shape == (2, H, W, 4) and bundle.lengths.shape == (2, H, W, S)
    assert _err(images, want) <= TOL
    images.backward(_t(cot))
    assert _err(td.grad, jgrads[0]) <= TOL and _err(tf.grad, jgrads[1]) <= TOL
    only = _t(dens).requires_grad_(True)
    opacity, _ = renderer(cameras=tc, volumes=Volumes.create(only, device="cpu", **kw))
    assert opacity.shape == (2, H, W, 1) and torch.equal(opacity, images[..., 3:].detach())
    opacity.backward(_t(cot[..., 3:]))
    full = _t(dens).requires_grad_(True)
    renderer(cameras=tc, volumes=Volumes.create(full, tf.detach(), device="cpu", **kw))[0][..., 3:].backward(
        _t(cot[..., 3:]))
    assert torch.equal(only.grad, full.grad)


def test_implicit_renderer_around_the_nerf_field():
    """The port's NeuralRadianceField (plain path) with a flax field's
    weights as the volumetric function: images and every weight's gradient."""
    jc, tc = _cameras()
    jf = JField(n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,))
    raysampler = dict(image_width=W, image_height=H, n_pts_per_ray=S, min_depth=1.0, max_depth=4.5)
    jbundle = JNDC(**raysampler)(jc)
    params = jax.jit(jf.init)(jax.random.PRNGKey(8), jbundle)
    cot = np.random.RandomState(9).randn(2, H, W, 4).astype(np.float32)
    jren = JImplicitRenderer(JNDC(**raysampler), JEA())

    def jrender(p):
        return jren(jc, lambda ray_bundle, cameras, **kw: jf.apply(p, ray_bundle))[0]

    want, vjp = jax.vjp(jax.jit(jrender), params)
    jgrads = vjp(jnp.asarray(cot))[0]
    field = NeuralRadianceField(n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,),
                                device="cpu")
    inner = jax.tree_util.tree_map(np.asarray, params["params"])
    state = nerf_state_dict_from_flax({"_renderer_coarse_field": inner, "_renderer_fine_field": inner}, device="cpu")
    prefix = "_renderer_coarse_field."
    field.load_state_dict({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})
    images, _ = ImplicitRenderer(NDCMultinomialRaysampler(**raysampler), EmissionAbsorptionRaymarcher())(
        cameras=tc, volumetric_function=field
    )
    assert _err(images, want) <= TOL
    images.backward(_t(cot))
    inner_g = jax.tree_util.tree_map(np.asarray, jgrads["params"])
    ref = nerf_state_dict_from_flax({"_renderer_coarse_field": inner_g, "_renderer_fine_field": inner_g}, device="cpu")
    for name, p in field.named_parameters():
        assert _err(p.grad, ref[prefix + name]) <= 1e-4, name  # sums over every ray's points
    with pytest.raises(ValueError):
        ImplicitRenderer(NDCMultinomialRaysampler(**raysampler), EmissionAbsorptionRaymarcher())(tc, None)


def test_integrated_embedding_and_gradients():
    rng = np.random.RandomState(10)
    x = rng.uniform(-2, 2, (4, 6, 3)).astype(np.float32)
    var = rng.uniform(0, 0.05, (4, 6, 3)).astype(np.float32)
    cot = rng.randn(4, 6, 3 * (2 * 5 + 1)).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda a, v: JEmbed(5)(a, diag_cov=v)), jnp.asarray(x), jnp.asarray(var))
    jx, jv = vjp(jnp.asarray(cot))
    tx, tv = _t(x).requires_grad_(True), _t(var).requires_grad_(True)
    got = HarmonicEmbedding(5)(tx, diag_cov=tv)
    got.backward(_t(cot))
    # sin / cos of arguments up to 2 * 16: the argument's ulp (~4e-6)
    assert _err(got, want) <= TOL and _err(tx.grad, jx) <= 1e-4 and _err(tv.grad, jv) <= TOL


def test_sample_pdf_python():
    rng = np.random.RandomState(11)
    bins = np.sort(rng.uniform(0.5, 4.5, (50, 16)), axis=-1).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (50, 15)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    both = jax.jit(lambda b, w, k: (j_sample_pdf_python(b, w, 8, key=k), j_sample_pdf_python(b, w, 8, det=True)))
    want, want_det = both(jnp.asarray(bins), jnp.asarray(weights), key)
    u = jax.random.uniform(key, (50, 8), jnp.float32)
    assert _err(sample_pdf_python(_t(bins), _t(weights), 8, u=_t(u)), want) <= TOL
    assert _err(sample_pdf_python(_t(bins), _t(weights), 8, det=True), want_det) <= TOL
    drawn = sample_pdf_python(_t(bins), _t(weights), 8, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (50, 8)


TINY = dict(
    n_pts_per_ray=8, n_pts_per_ray_fine=8, n_rays_per_image=64, min_depth=0.5, max_depth=4.0,
    n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,),
)


def test_remat_matches_jax_remat_and_the_port_without_it():
    """`remat=True` gradients: against JAX's remat=True at tests/test_torch_nerf.py's
    gates (1e-4 of each coarse tensor's largest entry; 5e-3 for the fine
    field, whose depths move by rounding / pdf), and equal to the bit to the
    port's own remat=False (the same float32 operations, run again).  Each
    field runs twice per step under remat: once in the forward, once in the
    backward."""
    cams, image, _ = graft._tiny_inputs()
    key = jax.random.PRNGKey(13)
    jm = graft._tiny_model().clone(remat=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), cams, image=image, key=key)

    def loss_fn(p):
        _, m = jm.apply(p, cams, image=image, training=True, key=key)
        return m["mse_coarse"] + m["mse_fine"]

    jgrads = jax.jit(jax.grad(loss_fn))(params)
    k_rays, _, k_fine = jax.random.split(key, 3)
    key_xy, key_strat = jax.random.split(k_rays)
    draws = {"xy": jax.random.uniform(key_xy, (1, 64, 2)), "jiggle": jax.random.uniform(key_strat, (1, 64, 8)),
             "pdf": jax.random.uniform(k_fine, (1, 64, 8))}
    draws = {k: _t(v) for k, v in draws.items()}
    tc = fov_perspective_cameras_from_numpy(
        *(np.asarray(getattr(cams, k)) for k in ("R", "T", "znear", "zfar", "aspect_ratio", "fov")), device="cpu"
    )
    state = nerf_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    grads, calls = {}, {}
    for remat in (True, False):
        model = RadianceFieldRenderer(32, 32, **TINY, remat=remat, device="cpu")
        model.load_state_dict(state)
        calls[remat] = []
        model._renderer_coarse_field.register_forward_hook(lambda *a, r=remat: calls[r].append("coarse"))
        _, m = model(tc, image=_t(image), training=True, draws=draws)
        (m["mse_coarse"] + m["mse_fine"]).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    assert calls == {True: ["coarse", "coarse"], False: ["coarse"]}
    assert all(torch.equal(grads[True][n], grads[False][n]) for n in grads[False])
    inner = jax.tree_util.tree_map(np.asarray, jgrads)
    ref = nerf_state_dict_from_flax(inner, device="cpu")
    for name, g in grads[True].items():
        assert _err(g, ref[name]) <= (1e-4 if "coarse" in name else 5e-3), name
