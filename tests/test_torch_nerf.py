"""The port's `RadianceFieldRenderer` against the JAX package's, on the same
flax-initialised weights converted by `convert.nerf_state_dict_from_flax`,
at the tiny config of `__graft_entry__._tiny_model` (32^2, 8 + 8 points,
64 rays, hidden 32, direction head 16, 2 layers, skip at layer 1):

- evaluation images (the full grid and a chunk);
- training with the JAX package's draws handed in (rebuilt from its key
  with the same split tree as nerf_renderer.py:106-145 and
  raysampling.py:367-383): the rgb of both passes, mse and psnr;
- every parameter's gradient against `jax.grad`, for the renderer and for
  one field on the same ray bundle;
- `__graft_entry__.entry()`'s (rgb_fine, mse_fine);
- the flax -> torch -> flax round trip of the weights.

The port runs on the CPU, where both fields take the plain versions of the
fused kernels; the fine pass's depths come from `sample_pdf`, whose samples
amplify float32 rounding of the coarse weights by 1 / pdf within a bin
(tests/test_torch_implicit.py), so the fine pass is held more loosely than
the coarse one, as each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pytorch3d_tpu.models.nerf.implicit_function import NeuralRadianceField as JField
from pytorch3d_tpu.renderer.implicit.utils import RayBundle as JBundle
from pytorch3d_tpu_torch.convert import (
    fov_perspective_cameras_from_numpy,
    nerf_state_dict_from_flax,
    nerf_state_dict_to_flax,
)
from pytorch3d_tpu_torch.models import NeuralRadianceField, RadianceFieldRenderer
from pytorch3d_tpu_torch.renderer.implicit import RayBundle

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TINY = dict(
    n_pts_per_ray=8, n_pts_per_ray_fine=8, n_rays_per_image=64, min_depth=0.5, max_depth=4.0,
    n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,),
)
# Coarse pass: the same float32 formulas in another summation order.
COARSE_TOL = 1e-5


@pytest.fixture(scope="module")
def graft_entry():
    """`__graft_entry__.entry()`'s model, weights and inputs; the weights
    from a jitted init (bit-equal to entry()'s eager one, which
    test_graft_entry_is_reproduced checks)."""
    cams, image, key = graft._tiny_inputs()
    params = jax.jit(graft._tiny_model().init)(jax.random.PRNGKey(1), cams, image=image, key=key)
    return None, params, cams, image, key


def _apply(params, cams, key, image=None, **kw):
    """The JAX renderer's (out, metrics), jitted."""
    return jax.jit(lambda p, c, i, k: graft._tiny_model().apply(p, c, image=i, key=k, **kw))(params, cams, image, key)


def _port_model(params, use_fused_kernel=True):
    model = RadianceFieldRenderer(32, 32, **TINY, use_fused_kernel=use_fused_kernel, device="cpu")
    model.load_state_dict(nerf_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return model


def _port_cameras(cams):
    return fov_perspective_cameras_from_numpy(
        *(np.asarray(getattr(cams, k)) for k in ("R", "T", "znear", "zfar", "aspect_ratio", "fov")), device="cpu"
    )


def _jax_draws(key, B=1, R=64, S=8, Sf=8):
    """The uniforms the JAX renderer draws at training from `key`."""
    k_rays, _, k_fine = jax.random.split(key, 3)
    key_xy, key_strat = jax.random.split(k_rays)
    draws = {
        "xy": jax.random.uniform(key_xy, (B, R, 2), jnp.float32),
        "jiggle": jax.random.uniform(key_strat, (B, R, S), jnp.float32),
        "pdf": jax.random.uniform(k_fine, (B, R, Sf), jnp.float32),
    }
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.abs(got.astype(np.float64) - np.asarray(want, np.float64))


def _jax_fine_pass(params, cams, key, chunk=None):
    """The JAX renderer's fine-pass ray bundle at evaluation (its bound
    submodules in the order of nerf_renderer.py:106-145) and the rgb its fine
    field renders from that bundle."""
    kw = {} if chunk is None else dict(chunksize=chunk[0], chunk_idx=chunk[1])

    def fine_pass(module, cams, key):
        k_rays, _, k_fine = jax.random.split(key, 3)
        bundle = module._raysampler(cams, key=k_rays, training=False, **kw)
        _, weights = module._raymarcher(*module._renderer_coarse_field(bundle))
        fine = module._raysampler_fine(bundle, weights, training=False, key=k_fine)
        rgb, w = module._raymarcher(*module._renderer_fine_field(fine))
        return fine, rgb + (1.0 - jnp.sum(w, axis=-1, keepdims=True)) * jnp.asarray(module.bg_color)

    return jax.jit(lambda p, c, k: graft._tiny_model().apply(p, c, k, method=fine_pass))(params, cams, key)


@pytest.mark.parametrize("chunk", [None, (400, 2)])
def test_eval_matches_jax(graft_entry, chunk):
    """The coarse pass within COARSE_TOL on every ray.  The fine depths are
    sample_pdf's inverse cdf of the coarse weights, which amplifies their
    float32 differences (~1e-5 here: the 6-harmonic embedding multiplies the
    rays' last-bit differences by up to 32) by 1 / pdf, up to ~1e4 in
    near-empty bins; so the fine pass is held (1) on the JAX package's own
    fine depths within COARSE_TOL, and (2) end to end within 1e-5 on >= 85 %
    of the rays (measured 92 %; 79 % against JAX run eagerly) and within
    1e-2 on all (measured 1.6e-3)."""
    _, params, cams, _, key = graft_entry
    jm, model, tc = graft._tiny_model(), _port_model(params), _port_cameras(cams)
    kw = {} if chunk is None else dict(chunksize=chunk[0], chunk_idx=chunk[1])
    want, _ = _apply(params, cams, key, training=False, **kw)
    with torch.no_grad():
        got, _ = model(tc, training=False, **kw)
    assert got["rgb_fine"].shape == want["rgb_fine"].shape
    assert _err(got["rgb_coarse"], want["rgb_coarse"]).max() <= COARSE_TOL
    # (1) the port's fine field and raymarcher on the JAX package's depths
    jb, jrgb = _jax_fine_pass(params, cams, key, chunk)
    fine = RayBundle(*(torch.tensor(np.asarray(getattr(jb, k))) for k in ("origins", "directions", "lengths", "xys")))
    with torch.no_grad():
        rgb, w = model._raymarcher(*model._renderer_fine_field(fine))
        rgb = rgb + (1.0 - w.sum(-1, keepdim=True)) * model.bg_color
    assert _err(rgb, jrgb).max() <= COARSE_TOL
    # (2) end to end
    err = _err(got["rgb_fine"], want["rgb_fine"]).max(-1)
    assert (err <= 1e-5).mean() >= 0.85, (err <= 1e-5).mean()
    assert err.max() <= 1e-2, err.max()


def test_training_with_jax_draws_matches_jax(graft_entry):
    _, params, cams, image, _ = graft_entry
    key = jax.random.PRNGKey(11)
    jm, model, tc = graft._tiny_model(), _port_model(params), _port_cameras(cams)
    want, want_m = _apply(params, cams, key, image, training=True)
    got, got_m = model(tc, image=torch.tensor(np.asarray(image)), training=True, draws=_jax_draws(key))
    assert _err(got["rgb_coarse"], want["rgb_coarse"]).max() <= COARSE_TOL
    assert _err(got["rgb_gt"], want["rgb_gt"]).max() <= COARSE_TOL
    # Fine depths move by rounding / pdf (up to ~1e-4 at pdf ~ 3e-4).
    assert _err(got["rgb_fine"], want["rgb_fine"]).max() <= 2e-4
    for name in ("mse_coarse", "psnr_coarse"):
        assert _err(got_m[name], want_m[name]) <= 1e-5 * abs(float(want_m[name])), name
    for name in ("mse_fine", "psnr_fine"):
        assert _err(got_m[name], want_m[name]) <= 1e-4 * abs(float(want_m[name])), name


def _grad_ratios(model, jgrads):
    """{parameter: max |g - g_jax| / max |g_jax|}."""
    ref = nerf_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    return {n: float((p.grad - ref[n]).abs().max() / ref[n].abs().max().clamp(min=1e-30))
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("use_fused_kernel", [True, False])
def test_gradients_match_jax_grad(graft_entry, use_fused_kernel):
    """Through the fused field's explicit reverse (use_fused_kernel) and
    through torch autograd of the plain chain."""
    _, params, cams, image, _ = graft_entry
    key = jax.random.PRNGKey(12)
    jm, model, tc = graft._tiny_model(), _port_model(params, use_fused_kernel), _port_cameras(cams)

    def loss_fn(p):
        _, m = jm.apply(p, cams, image=image, training=True, key=key)
        return m["mse_coarse"] + m["mse_fine"]

    jgrads = jax.jit(jax.grad(loss_fn))(params)
    _, m = model(tc, image=torch.tensor(np.asarray(image)), training=True, draws=_jax_draws(key))
    (m["mse_coarse"] + m["mse_fine"]).backward()
    ratios = _grad_ratios(model, jgrads)
    assert len(ratios) == 24
    # The coarse field sees the same rays: 1e-4 of each gradient's largest
    # entry.  The fine field sees depths moved by rounding / pdf (measured
    # ~1e-3 of the largest entry at this config): 5e-3.
    for name, r in ratios.items():
        assert r <= (1e-4 if "coarse" in name else 5e-3), (name, r)


def test_field_gradients_match_jax_on_one_bundle(graft_entry):
    """One field on the same ray bundle in both packages: densities, colours
    and every parameter's gradient of a weighted sum of them."""
    _, params, _, _, _ = graft_entry
    rng = np.random.RandomState(0)
    o = rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
    d = rng.randn(2, 50, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(0.5, 4.0, (2, 50, 8)), -1).astype(np.float32)
    a = rng.randn(2, 50, 8, 1).astype(np.float32)
    b = rng.randn(2, 50, 8, 3).astype(np.float32)
    field_params = {"params": params["params"]["_renderer_fine_field"]}
    jf = JField(n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,))
    jb = JBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lengths), jnp.zeros((2, 50, 2)))

    def jloss(p):
        dens, cols = jf.apply(p, jb)
        return jnp.sum(dens * a) + jnp.sum(cols * b), (dens, cols)

    (_, (jd, jc)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(field_params)
    field = NeuralRadianceField(n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,),
                                device="cpu")
    sd = nerf_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    prefix = "_renderer_fine_field."
    field.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    tb = RayBundle(torch.tensor(o), torch.tensor(d), torch.tensor(lengths), torch.zeros(2, 50, 2))
    td, tcol = field(tb)
    ((td * torch.tensor(a)).sum() + (tcol * torch.tensor(b)).sum()).backward()
    assert _err(td, jd).max() <= 1e-5 and _err(tcol, jc).max() <= 1e-5
    ref = nerf_state_dict_from_flax({"params": {"_renderer_coarse_field": jax.tree_util.tree_map(
        np.asarray, jg["params"]), "_renderer_fine_field": jax.tree_util.tree_map(np.asarray, jg["params"])}},
        device="cpu")
    for n, p in field.named_parameters():
        want = ref["_renderer_coarse_field." + n]
        assert float((p.grad - want).abs().max()) <= 1e-5 * float(want.abs().max()), n


def test_graft_entry_is_reproduced(graft_entry):
    """`__graft_entry__.entry()`'s jitted forward: (rgb_fine, mse_fine) of
    the coarse + fine render at training, key PRNGKey(0)."""
    fn, (params, cams, image, key) = graft.entry()
    same = jax.tree_util.tree_map(lambda a, b: bool((a == b).all()), params, graft_entry[1])
    assert all(jax.tree_util.tree_leaves(same))
    want_rgb, want_mse = jax.jit(fn)(params, cams, image, key)
    model = _port_model(params)
    with torch.no_grad():
        got, m = model(_port_cameras(cams), image=torch.tensor(np.asarray(image)), training=True,
                       draws=_jax_draws(key))
    assert got["rgb_fine"].shape == want_rgb.shape == (1, 64, 3)
    assert _err(got["rgb_fine"], want_rgb).max() <= 2e-4
    assert _err(m["mse_fine"], want_mse) <= 1e-4 * float(want_mse)


def test_weights_round_trip(graft_entry):
    """flax init -> port state_dict -> flax tree: every leaf equal, and the
    port's own initialisation converts to a tree the JAX model renders
    with (the same image as the port's at evaluation)."""
    _, params, cams, _, key = graft_entry
    flat = jax.tree_util.tree_map(np.asarray, params)
    back = nerf_state_dict_to_flax(nerf_state_dict_from_flax(flat, device="cpu"))
    leaves_a, tree_a = jax.tree_util.tree_flatten(flat)
    leaves_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(x, y) for x, y in zip(leaves_a, leaves_b))

    model = RadianceFieldRenderer(32, 32, **TINY, device="cpu", generator=torch.Generator().manual_seed(3))
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name  # zero biases, as flax initialises them
    jparams = jax.tree_util.tree_map(jnp.asarray, nerf_state_dict_to_flax(model.state_dict()))
    want, _ = _apply(jparams, cams, key, training=False, chunksize=256)
    with torch.no_grad():
        got, _ = model(_port_cameras(cams), training=False, chunksize=256)
    assert _err(got["rgb_coarse"], want["rgb_coarse"]).max() <= COARSE_TOL


def test_left_out_options_raise():
    """bf16 still raises, for the renderer and the training step; remat is
    ported (tests/test_torch_implicit_renderer.py), and so is ray sharding:
    the one rank of a (1, 1) mesh renders every ray, as without it
    (tests/test_torch_parallel.py shards over ranks)."""
    from pytorch3d_tpu_torch.parallel import get_device_mesh, make_nerf_train_step, shard_rays

    assert RadianceFieldRenderer(32, 32, **TINY, remat=True, device="cpu").remat
    with pytest.raises(NotImplementedError):
        RadianceFieldRenderer(32, 32, **TINY, dtype=torch.bfloat16, device="cpu")
    model = RadianceFieldRenderer(32, 32, **TINY, device="cpu")
    with pytest.raises(NotImplementedError):
        make_nerf_train_step(model, torch.optim.Adam(model.parameters()), compute_dtype=torch.bfloat16)
    cams = _port_cameras(graft._tiny_inputs()[0])
    with torch.no_grad():
        want, _ = model(cams, training=False, chunksize=256)
        got, _ = model(cams, training=False, chunksize=256, ray_sharding=shard_rays(get_device_mesh((1, 1))))
    assert all(torch.equal(got[k], want[k]) for k in want)
