"""The port's Implicitron models against the JAX package's, on the CPU:
the raymarchers, the ray samplers (training draws from the mask, the full
grid, `n_rays_total`, the cone-cast branch) with the JAX package's draws
handed in, the refiner with and without blurpool, the NeRF implicit
function's three branches (fused field, trunk alone, a global code), both
metrics classes, the global encoders' rows, `GenericModel` in evaluation
(chunked against unchunked and against JAX) and in training (objective and
every parameter's gradient against `jax.grad`), pass sharing and a
heterogeneous coarse pass, the model helpers, and `ModelDBIR`.

Sizes are tiny (2 layers of width 32, 3 + 2 harmonics, 8 x 8 images, 16
rays, 8 + 8 points).  The weights are seeded numpy arrays in the flax
variables' layout, handed to JAX as they are and to the port through
`convert.generic_model_state_dict_from_flax`.  The JAX side is jitted.

Tolerances: the same float32 formulas in another order, 1e-5 of the
values' magnitude, unless a test states another.  The fine pass's depths
are `sample_pdf`'s inverse cdf of the coarse weights, which amplifies
their last bits by 1 / pdf: it is held by the share of rays within 1e-5.
At this model JAX's eager and jitted evaluation renders are equal, and the
port's is within 1e-5 on 100 % of rays (max 1.8e-7; run this file as a
script to print both).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.implicitron.models import GenericModel as JGenericModel
from pytorch3d_tpu.implicitron.models import ModelDBIR as JModelDBIR
from pytorch3d_tpu.implicitron.models import RegularizationMetrics as JRegMetrics
from pytorch3d_tpu.implicitron.models import ViewMetrics as JViewMetrics
from pytorch3d_tpu.implicitron.models.global_encoder.global_encoder import HarmonicTimeEncoder as JTimeEncoder
from pytorch3d_tpu.implicitron.models.global_encoder.global_encoder import SequenceAutodecoder as JSeqAD
from pytorch3d_tpu.implicitron.models.implicit_function.neural_radiance_field import (
    NeuralRadianceFieldImplicitFunction as JNeRFFn,
)
from pytorch3d_tpu.implicitron.models.renderer import base as jbase
from pytorch3d_tpu.implicitron.models.renderer.base import EvaluationMode as JMode
from pytorch3d_tpu.implicitron.models.renderer.base import ImplicitronRayBundle as JBundle
from pytorch3d_tpu.implicitron.models.renderer.base import RendererOutput as JOutput
from pytorch3d_tpu.implicitron.models.renderer.ray_point_refiner import RayPointRefiner as JRefiner
from pytorch3d_tpu.implicitron.models.renderer.ray_point_refiner import apply_blurpool_on_weights as j_blurpool
from pytorch3d_tpu.implicitron.models.renderer.ray_sampler import AdaptiveRaySampler as JAdaptive
from pytorch3d_tpu.implicitron.models.renderer.ray_sampler import NearFarRaySampler as JNearFar
from pytorch3d_tpu.implicitron.models.renderer.raymarcher import CumsumRaymarcher as JCumsum
from pytorch3d_tpu.implicitron.models.renderer.raymarcher import EmissionAbsorptionRaymarcher as JEA
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JPersp
from pytorch3d_tpu_torch.convert import fov_perspective_cameras_from_numpy, generic_model_state_dict_from_flax
from pytorch3d_tpu_torch.implicitron.models import GenericModel, ModelDBIR, OverfitModel, RegularizationMetrics, ViewMetrics
from pytorch3d_tpu_torch.implicitron.models import utils as mutils
from pytorch3d_tpu_torch.implicitron.models.base_model import ImplicitronModelBase, ImplicitronRender
from pytorch3d_tpu_torch.implicitron.models.global_encoder import Autodecoder, HarmonicTimeEncoder, SequenceAutodecoder
from pytorch3d_tpu_torch.implicitron.models.implicit_function import NeuralRadianceFieldImplicitFunction
from pytorch3d_tpu_torch.implicitron.models.renderer import (
    AdaptiveRaySampler,
    CumsumRaymarcher,
    EmissionAbsorptionRaymarcher,
    EvaluationMode,
    ImplicitronRayBundle,
    NearFarRaySampler,
    RayPointRefiner,
    RendererOutput,
)
from pytorch3d_tpu_torch.implicitron.models.renderer import base as tbase
from pytorch3d_tpu_torch.implicitron.models.renderer.ray_point_refiner import apply_blurpool_on_weights
from pytorch3d_tpu_torch.implicitron.models.renderer.raymarcher import RaymarcherBase
from pytorch3d_tpu_torch.implicitron.tools.config import registry

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TOL = 1e-5
H = W = 8
N_RAYS, S = 16, 8
FN = dict(n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16,
          n_layers_xyz=2, append_xyz=(1,))
MODEL = dict(
    render_image_width=W, render_image_height=H, chunk_size_grid=16, implicit_function_args=FN,
    raysampler_args=dict(scene_extent=2.0, n_pts_per_ray_training=S, n_pts_per_ray_evaluation=S,
                         n_rays_per_image_sampled_from_mask=N_RAYS),
    renderer_args=dict(n_pts_per_ray_fine_training=S, n_pts_per_ray_fine_evaluation=S),
)


def _jit(fn):
    """jax.jit(fn), compiled without XLA's expensive CPU passes: a third of
    the compile time of these small graphs, the results within float32
    rounding of the optimised build's."""

    def run(*args):
        return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)

    return run


FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _err(got, want):
    """max |got - want| / max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a):
    return torch.tensor(np.asarray(a))


def _cameras():
    """Two cameras 2.5 from the origin: looking down -z, and a quarter turn
    about y (rotations exact in float32, so both packages project alike)."""
    R = np.stack([np.eye(3), np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])]).astype(np.float32)
    T = np.array([[0.0, 0.0, 2.5], [0.1, -0.05, 2.5]], np.float32)
    ones = np.ones(2, np.float32)
    jc = JPersp.create(R=jnp.asarray(R), T=jnp.asarray(T), znear=0.5, zfar=5.0, fov=50.0)
    tc = fov_perspective_cameras_from_numpy(R, T, 0.5 * ones, 5.0 * ones, ones, 50.0 * ones, device="cpu")
    return jc, tc


def _frames(seed=0):
    """(image (2, H, W, 3), fg probability (2, H, W, 1) with soft edges,
    depth (2, H, W, 1))."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    disc = np.exp(-((yy - 3.5) ** 2 + (xx - 3.5) ** 2) / 6.0)
    fg = np.clip(disc[None, ..., None] + rng.uniform(-0.2, 0.2, (2, H, W, 1)), 0, 1).astype(np.float32)
    depth = rng.uniform(1.5, 3.0, (2, H, W, 1)).astype(np.float32) * (fg > 0.3)
    return image, fg, depth


def _dense(rng, fan_in, fan_out):
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return {"kernel": rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, (fan_out,)).astype(np.float32)}


def _fn_params(rng, d_in=21, color_dim=3, hidden=32, hidden_dir=16, d_dir=15, n_layers=2, skip=1):
    """A NeRF implicit function's flax params (trunk input d_in: the
    harmonic embedding plus any code)."""
    trunk = {f"layer{i}": _dense(rng, (hidden if i else d_in) + (d_in if i == skip else 0), hidden)
             for i in range(n_layers)}
    return {
        "xyz_encoder": trunk,
        "intermediate_linear": _dense(rng, hidden, hidden),
        "density_layer": _dense(rng, hidden, 1),
        "color_layer_hidden": _dense(rng, hidden + d_dir, hidden_dir),
        "color_layer_out": _dense(rng, hidden_dir, color_dim),
    }


def _variables(seed, n_fns=2, code=None, **kw):
    rng = np.random.default_rng(seed)
    params = {f"implicit_function_{i}": _fn_params(rng, **kw) for i in range(n_fns)}
    if code is not None:
        params["_global_encoder"] = {"autodecoder": {"Embed_0": {"embedding": rng.standard_normal(code)
                                                                 .astype(np.float32)}}}
    return {"params": params}


def _port_model(variables, cls=GenericModel, **cfg):
    model = cls(**cfg, device="cpu")
    model.load_state_dict(generic_model_state_dict_from_flax(variables, device="cpu"), strict=True)
    return model


def _model_draws(key, B):
    """The draws the JAX GenericModel takes from `key` in training (call
    inside a jit): key -> (rays, render); rays -> (select, stratify); a
    mask-weighted choice is argmax(log mask + Gumbel(per-image key, (n,
    H*W))); the refine's quantiles are uniform(render key, (B, n, n_fine))."""
    k_rays, k_render = jax.random.split(key)
    key_sel, key_strat = jax.random.split(k_rays)
    return {"u_jiggle": jax.random.uniform(key_strat, (B, N_RAYS, S)),
            "u_pdf": jax.random.uniform(k_render, (B, N_RAYS, S)),
            "select": jax.vmap(lambda k: jax.random.gumbel(k, (N_RAYS, H * W), jnp.float32))(
                jax.random.split(key_sel, B))}


def _draws_t(draws):
    return {k: _t(v) for k, v in draws.items()}


def _bundle(tb, jb):
    for name in ("origins", "directions", "lengths", "xys"):
        assert _err(getattr(tb, name), getattr(jb, name)) <= TOL, name


# --------------------------------------------------------------------------- #
# raymarchers, samplers, refiner, frustums
# --------------------------------------------------------------------------- #


MARCHERS = [("EmissionAbsorptionRaymarcher", {}),
            ("EmissionAbsorptionRaymarcher", dict(surface_thickness=2, blend_output=True, bg_color=(0.2, 0.4, 0.6))),
            ("CumsumRaymarcher", dict(replicate_last_interval=True))]


def _marcher_inputs():
    rng = np.random.default_rng(1)
    dens = rng.uniform(-0.2, 1.5, (2, 5, S, 1)).astype(np.float32)
    feats = rng.uniform(0, 1, (2, 5, S, 3)).astype(np.float32)
    lengths = np.sort(rng.uniform(1.0, 3.0, (2, 5, S)), -1).astype(np.float32)
    cot = rng.standard_normal((2, 5, 5)).astype(np.float32)
    return dens, feats, lengths, cot


@functools.lru_cache(maxsize=None)
def _jax_marchers():
    """Each case's [features, depth, mask] and its VJP, in one jit."""
    dens, feats, lengths, cot = _marcher_inputs()
    jcls = {"EmissionAbsorptionRaymarcher": JEA, "CumsumRaymarcher": JCumsum}

    def all_cases(d, f):
        outs = []
        for name, kw in MARCHERS:
            def run(d, f, name=name, kw=kw):
                out = jcls[name](**kw)(d, f, ray_lengths=jnp.asarray(lengths))
                return jnp.concatenate([out.features, out.depths, out.masks], -1)

            want, vjp = jax.vjp(run, d, f)
            outs.append((want, *vjp(jnp.asarray(cot))))
        return outs

    return jax.tree_util.tree_map(np.asarray, _jit(all_cases)(jnp.asarray(dens), jnp.asarray(feats)))


@pytest.mark.parametrize("case", range(len(MARCHERS)))
def test_raymarchers(case):
    name, kw = MARCHERS[case]
    dens, feats, lengths, cot = _marcher_inputs()
    want, jd, jf = _jax_marchers()[case]
    td, tf = _t(dens).requires_grad_(True), _t(feats).requires_grad_(True)
    marcher = registry.get(RaymarcherBase, name)(**kw)
    out = marcher(td, tf, ray_lengths=_t(lengths))
    got = torch.cat([out.features, out.depths, out.masks], -1)
    got.backward(_t(cot))
    assert isinstance(marcher, {"EmissionAbsorptionRaymarcher": EmissionAbsorptionRaymarcher,
                                "CumsumRaymarcher": CumsumRaymarcher}[name])
    assert out.weights.shape == (2, 5, S)
    assert _err(got, want) <= TOL and _err(td.grad, jd) <= TOL and _err(tf.grad, jf) <= TOL


def test_ray_samplers_with_jax_draws():
    """Training (drawn from the mask, stratified), evaluation (the full
    grid), n_rays_total with fixed bounds; AdaptiveRaySampler's bounds stay
    tensors."""
    jc, tc = _cameras()
    _, fg, _ = _frames()
    mask = (fg[..., 0] > 0.5).astype(np.float32)
    kw = dict(image_width=W, image_height=H, n_pts_per_ray_training=S, n_pts_per_ray_evaluation=S,
              n_rays_per_image_sampled_from_mask=N_RAYS, scene_extent=2.0)
    kw_nf = dict(image_width=W, image_height=H, n_pts_per_ray_training=S, n_rays_total_training=12,
                 stratified_point_sampling_training=False, min_depth=1.0, max_depth=4.0)

    def jrun(c, m, key):
        sampler = JAdaptive(**kw)
        out = {"train": sampler(c, JMode.TRAINING, mask=m, key=key), "eval": sampler(c, JMode.EVALUATION),
               "bounds": sampler._get_min_max_depth_bounds(c), "nf": JNearFar(**kw_nf)(c, JMode.TRAINING, key=key)}
        key_sel, key_strat = jax.random.split(key)
        out["select"] = jax.vmap(lambda k: jax.random.gumbel(k, (N_RAYS, H * W), jnp.float32))(
            jax.random.split(key_sel, 2))
        out["u_jiggle"] = jax.random.uniform(key_strat, (2, N_RAYS, S))
        key_cam, key = jax.random.split(key)  # n_rays_total: the cameras first, then one ray per row
        out["ids"] = jax.random.randint(key_cam, (12,), 0, 2)
        key_sel, _ = jax.random.split(key)
        out["order"] = jax.vmap(lambda k: jax.random.bits(jax.random.split(k)[1], (H * W,), jnp.uint32))(
            jax.random.split(key_sel, 12))
        return out

    j = _jit(jrun)(jc, jnp.asarray(mask), jax.random.PRNGKey(3))
    sampler = AdaptiveRaySampler(**kw)
    ttrain = sampler(tc, EvaluationMode.TRAINING, mask=_t(mask), select=_t(j["select"]), u_jiggle=_t(j["u_jiggle"]))
    _bundle(ttrain, j["train"])
    teval = sampler(tc, EvaluationMode.EVALUATION)
    assert teval.lengths.shape == (2, H, W, S)
    _bundle(teval, j["eval"])
    near, far = sampler._get_min_max_depth_bounds(tc)
    assert isinstance(near, torch.Tensor) and _err(near, j["bounds"][0]) <= TOL and _err(far, j["bounds"][1]) <= TOL
    tnf = NearFarRaySampler(**kw_nf)(tc, EvaluationMode.TRAINING, camera_ids=_t(j["ids"]).long(),
                                     select=_t(np.asarray(j["order"]).astype(np.int64)))
    _bundle(tnf, j["nf"])
    assert tnf.is_packed() and tnf.camera_ids.tolist() == np.asarray(j["nf"].camera_ids).tolist()
    drawn = sampler(tc, EvaluationMode.TRAINING, mask=_t(mask), generator=torch.Generator().manual_seed(0))
    assert drawn.lengths.shape == (2, N_RAYS, S) and torch.isfinite(drawn.lengths).all()
    with pytest.raises(ValueError):
        AdaptiveRaySampler(sampling_mode_training="full_grid", n_rays_total_training=4)


def test_cone_cast_bundle_and_frustum_gaussians():
    """cast_ray_bundle_as_cone: bins (S + 1 edges), their midpoints as
    lengths, each pixel's radius, and the frustums' Gaussians."""
    jc, tc = _cameras()
    kw = dict(image_width=W, image_height=H, n_pts_per_ray_evaluation=S, cast_ray_bundle_as_cone=True,
              min_depth=1.0, max_depth=4.0)

    def jrun(c):
        b = JNearFar(**kw)(c, JMode.EVALUATION)
        return b, jbase.conical_frustum_to_gaussian(b)

    jb, (jmeans, jcov) = _jit(jrun)(jc)
    tb = NearFarRaySampler(**kw)(tc, EvaluationMode.EVALUATION)
    assert tb.bins.shape == (2, H, W, S + 1) and tb.lengths.shape == (2, H, W, S)
    _bundle(tb, jb)
    assert _err(tb.bins, jb.bins) <= TOL and _err(tb.pixel_radii_2d, jb.pixel_radii_2d) <= TOL
    means, cov = tbase.conical_frustum_to_gaussian(tb)
    assert _err(means, jmeans) <= TOL and _err(cov, jcov) <= 1e-4  # variances: differences of near-equal squares
    with pytest.raises(ValueError):
        tbase.conical_frustum_to_gaussian(tb.replace(bins=None))
    with pytest.raises(TypeError):
        NearFarRaySampler(cast_ray_bundle_as_cone=True, n_rays_total_training=4)


REFINES = [(False, True), (True, True), (True, False)]  # (blurpool, random)


def _refiner_inputs():
    rng = np.random.default_rng(4)
    lengths = np.sort(rng.uniform(1.0, 3.0, (2, 6, S)), -1).astype(np.float32)
    weights = rng.uniform(0, 1, (2, 6, S)).astype(np.float32)
    o = rng.standard_normal((2, 6, 3)).astype(np.float32)
    return lengths, weights, o


@functools.lru_cache(maxsize=None)
def _jax_refines():
    """Each case's refined lengths, the quantiles JAX drew, and JAX's
    blurpool, in one jit."""
    lengths, weights, o = _refiner_inputs()
    key = jax.random.PRNGKey(5)

    def run(w):
        jb = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(o), lengths=jnp.asarray(lengths),
                     xys=jnp.asarray(o[..., :2]))
        out = [JRefiner(n_pts_per_ray=S, random_sampling=r)(jb, w, b, key=key).lengths for b, r in REFINES]
        return out, jax.random.uniform(key, (2, 6, S)), j_blurpool(w)

    return jax.tree_util.tree_map(np.asarray, _jit(run)(jnp.asarray(weights)))


@pytest.mark.parametrize("case", range(len(REFINES)))
def test_refiner(case):
    blurpool, random = REFINES[case]
    lengths, weights, o = _refiner_inputs()
    want, u, blurred = _jax_refines()
    tb = ImplicitronRayBundle(_t(o), _t(o), _t(lengths), _t(o[..., :2]))
    tr = RayPointRefiner(n_pts_per_ray=S, random_sampling=random)(tb, _t(weights), blurpool,
                                                                  u=_t(u) if random else None)
    assert tr.lengths.shape == (2, 6, 2 * S)
    assert _err(tr.lengths, want[case]) <= TOL
    assert _err(apply_blurpool_on_weights(_t(weights)), blurred) == 0.0


# --------------------------------------------------------------------------- #
# the implicit function, metrics, encoders
# --------------------------------------------------------------------------- #


BRANCHES = {"fused_field": (3, 0), "trunk_alone": (4, 0), "global_code": (3, 4)}  # (color_dim, code width)


def _branch_inputs(branch):
    rng = np.random.default_rng(6)
    color_dim, code_dim = BRANCHES[branch]
    params = _fn_params(rng, d_in=21 + code_dim, color_dim=color_dim)
    o = rng.standard_normal((2, 5, 3)).astype(np.float32) * 0.3
    d = rng.standard_normal((2, 5, 3)).astype(np.float32)
    lengths = np.sort(rng.uniform(1.0, 3.0, (2, 5, S)), -1).astype(np.float32)
    code = rng.standard_normal((2, code_dim)).astype(np.float32) if code_dim else None
    cot = rng.standard_normal((2, 5, S, 1 + color_dim)).astype(np.float32)
    return params, o, d, lengths, code, cot


@functools.lru_cache(maxsize=None)
def _jax_branches():
    """Each branch's (densities | colours) and its VJP, in one jit."""

    def all_branches():
        outs = {}
        for branch, (color_dim, _) in BRANCHES.items():
            params, o, d, lengths, code, cot = _branch_inputs(branch)

            def run(p, o, d, lengths=lengths, code=code, color_dim=color_dim):
                b = JBundle(origins=o, directions=d, lengths=jnp.asarray(lengths), xys=o[..., :2])
                dens, col = JNeRFFn(**FN, color_dim=color_dim).apply(
                    {"params": p}, ray_bundle=b, global_code=None if code is None else jnp.asarray(code))
                return jnp.concatenate([dens, col], -1)

            want, vjp = jax.vjp(run, params, jnp.asarray(o), jnp.asarray(d))
            outs[branch] = (want, *vjp(jnp.asarray(cot)))
        return outs

    return jax.tree_util.tree_map(np.asarray, _jit(all_branches)())


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_nerf_implicit_function_branches(branch):
    """color_dim 3 (the fused field: #12 / #13's plain versions here),
    color_dim 4 (the trunk alone: #10 / #11's), and a (B, 4) global code
    concatenated to the embedding; outputs and every gradient."""
    color_dim, code_dim = BRANCHES[branch]
    params, o, d, lengths, code, cot = _branch_inputs(branch)
    want, jgrads, jgo, jgd = _jax_branches()[branch]
    fn = NeuralRadianceFieldImplicitFunction(**FN, color_dim=color_dim, latent_dim=code_dim, device="cpu")
    state = generic_model_state_dict_from_flax({"implicit_function_0": params}, device="cpu")
    fn.load_state_dict({k[len("implicit_function_0."):]: v for k, v in state.items()}, strict=True)
    to, td = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    dens, col = fn(ImplicitronRayBundle(to, td, _t(lengths), to[..., :2]),
                   global_code=None if code is None else _t(code))
    got = torch.cat([dens, col], -1)
    got.backward(_t(cot))
    assert got.shape == (2, 5, S, 1 + color_dim) and _err(got, want) <= TOL
    assert _err(to.grad, jgo) <= 1e-4 and _err(td.grad, jgd) <= 1e-4  # through the embedding's 4x frequency
    jflat = generic_model_state_dict_from_flax({"implicit_function_0": jgrads}, device="cpu")
    for name, p in fn.named_parameters():
        assert _err(p.grad, jflat["implicit_function_0." + name]) <= TOL, name
    assert NeuralRadianceFieldImplicitFunction(use_transformer_trunk=True, device="cpu").xyz_encoder.n_layers == 8

    def per_view(p):
        return p[None]

    per_view.per_view = True
    with pytest.raises(ValueError):  # per-view features need the transformer trunk
        fn(ImplicitronRayBundle(to, td, _t(lengths), to[..., :2]), fun_viewpool=per_view)


def test_view_and_regularization_metrics():
    """Every loss of ViewMetrics on a grid bundle and on a packed one
    (camera_ids), and RegularizationMetrics' depth and eikonal terms."""
    image, fg, depth = _frames(2)
    rng = np.random.default_rng(7)
    xys = rng.uniform(-1, 1, (2, 6, 2)).astype(np.float32)
    feats, depths = rng.uniform(0, 1, (2, 6, 3)).astype(np.float32), rng.uniform(-0.5, 3, (2, 6, 1)).astype(np.float32)
    masks = rng.uniform(0, 1, (2, 6, 1)).astype(np.float32)
    grad_theta = rng.standard_normal((2, 6, 3)).astype(np.float32)
    ids = np.array([0, 1, 1, 0, 1, 0, 0, 0, 1, 1, 0, 1], np.int64)

    def jrun(camera_ids, xy):
        out = JOutput(features=jnp.asarray(feats.reshape(xy.shape[:-1] + (3,))),
                      depths=jnp.asarray(depths.reshape(xy.shape[:-1] + (1,))),
                      masks=jnp.asarray(masks.reshape(xy.shape[:-1] + (1,))), aux={"grad_theta": grad_theta})
        r = JViewMetrics()({}, out, image_rgb=jnp.asarray(image), depth_map=jnp.asarray(depth),
                           fg_probability=jnp.asarray(fg), xys=xy, camera_ids=camera_ids)
        return JRegMetrics()(r, raymarched=out)

    for camera_ids, xy in ((None, xys), (ids, xys.reshape(12, 1, 2))):
        want = _jit(jrun)(camera_ids, jnp.asarray(xy))
        out = RendererOutput(features=_t(feats).reshape(xy.shape[:-1] + (3,)),
                             depths=_t(depths).reshape(xy.shape[:-1] + (1,)),
                             masks=_t(masks).reshape(xy.shape[:-1] + (1,)), aux={"grad_theta": _t(grad_theta)})
        got = ViewMetrics()({}, out, image_rgb=_t(image), depth_map=_t(depth), fg_probability=_t(fg), xys=_t(xy),
                            camera_ids=None if camera_ids is None else _t(camera_ids))
        got = RegularizationMetrics()(got, raymarched=out)
        assert sorted(got) == sorted(want) and len(got) == 11
        for name in want:
            assert _err(got[name], want[name]) <= TOL, name


def test_global_encoders_rows():
    """Sequence names map to crc32(name) % n_instances rows, JAX's rows;
    integer codes to code % n_instances; the time encoder's embedding."""
    table = np.random.default_rng(8).standard_normal((5, 3)).astype(np.float32)
    names = ["apple_12", "teddybear_34", "", "car_0", "apple_12"]
    jenc = JSeqAD(encoding_dim=3, n_instances=5)
    want = jenc.apply({"params": {"autodecoder": {"Embed_0": {"embedding": table}}}}, sequence_name=names)
    enc = SequenceAutodecoder(encoding_dim=3, n_instances=5, device="cpu")
    enc.load_state_dict({"autodecoder.embedding": _t(table)}, strict=True)
    assert np.array_equal(enc(sequence_name=names).detach().numpy(), np.asarray(want))
    assert enc.autodecoder.rows(torch.tensor([7, 3])).tolist() == [2, 3] and enc.get_encoding_dim() == 3
    assert Autodecoder(0, device="cpu")(names) is None
    assert Autodecoder(3, 5, ignore_input=True, device="cpu").rows(names).tolist() == [0]
    t = np.array([0.0, 0.25, 1.5], np.float32)
    want = _jit(lambda x: JTimeEncoder(n_harmonic_functions=3, time_divisor=2.0).apply({}, frame_timestamp=x))(t)
    henc = HarmonicTimeEncoder(n_harmonic_functions=3, time_divisor=2.0, device="cpu")
    assert henc.get_encoding_dim() == 7 and _err(henc(frame_timestamp=_t(t)), want) <= TOL
    with pytest.raises(ValueError):
        henc()


# --------------------------------------------------------------------------- #
# GenericModel
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def generic():
    """The JAX GenericModel's evaluation render and training objective and
    gradients (jitted) at MODEL, with a SequenceAutodecoder code."""
    jc, tc = _cameras()
    image, fg, _ = _frames()
    cfg = dict(MODEL, global_encoder_class_type="SequenceAutodecoder",
               global_encoder_args=dict(encoding_dim=4, n_instances=3))
    variables = _variables(9, code=(3, 4), d_in=25)
    names = ["seq_a", "seq_b"]
    key = jax.random.PRNGKey(10)
    jm = JGenericModel(**cfg)
    batch = dict(image_rgb=jnp.asarray(image), camera=jc, fg_probability=jnp.asarray(fg))

    def jrun(v):
        render = jm.apply(v, **batch, sequence_name=names, evaluation_mode=JMode.EVALUATION, key=key)
        def jloss(v):
            preds = jm.apply(v, **batch, sequence_name=names, evaluation_mode=JMode.TRAINING, key=key)
            return preds["objective"], {k: x for k, x in preds.items() if k.startswith("loss")}

        return render["images_render"], jax.value_and_grad(jloss, has_aux=True)(v), _model_draws(key, 2)

    want_eval, ((objective, losses), grads), draws = jax.tree_util.tree_map(np.asarray, _jit(jrun)(variables))
    return dict(cfg=cfg, variables=variables, names=names, tc=tc, image=image, fg=fg, draws=_draws_t(draws),
                want_eval=want_eval, objective=objective, preds=losses, grads=grads)


def _fine_share(got, want):
    err = np.abs(got.detach().numpy().astype(np.float64) - np.asarray(want, np.float64)).max(-1)
    return float((err <= 1e-5).mean()), float(err.max())


def test_generic_model_evaluation_chunked_and_against_jax(generic):
    """The full-grid render in chunks of 16 rays equals the unchunked one to
    the bit; against JAX's render, every ray within 1e-5: the share JAX's
    own eager and jitted renders reach (they are equal; measured here: the
    port's max 1.8e-7)."""
    g = generic
    model = _port_model(g["variables"], **g["cfg"])
    batch = dict(image_rgb=_t(g["image"]), camera=g["tc"], fg_probability=_t(g["fg"]), sequence_name=g["names"])
    with torch.no_grad():
        chunked = model(**batch, evaluation_mode=EvaluationMode.EVALUATION)
        model.chunk_size_grid = 0
        whole = model(**batch, evaluation_mode=EvaluationMode.EVALUATION)
    assert chunked["images_render"].shape == (2, H, W, 3)
    for name in ("images_render", "depths_render", "masks_render"):
        assert torch.equal(chunked[name], whole[name]), name
    share, worst = _fine_share(chunked["images_render"], g["want_eval"])
    assert share == 1.0 and worst <= 1e-5, (share, worst)
    assert isinstance(chunked["implicitron_render"], RendererOutput)


def test_generic_model_training_objective_and_gradients(generic):
    """With JAX's draws: the coarse losses within 1e-5, the fine ones and
    the objective within 1e-4 (fine depths move by rounding / pdf); every
    coarse-function and encoder gradient within 1e-4 of its largest entry,
    the fine function's within 2e-3."""
    g = generic
    model = _port_model(g["variables"], **g["cfg"])
    preds = model(image_rgb=_t(g["image"]), camera=g["tc"], fg_probability=_t(g["fg"]), sequence_name=g["names"],
                  evaluation_mode=EvaluationMode.TRAINING, draws=g["draws"])
    preds["objective"].backward()
    assert _err(preds["objective"], g["objective"]) <= 1e-4
    assert sorted(k for k in preds if k.startswith("loss")) == sorted(g["preds"])
    for name, want in g["preds"].items():
        assert _err(preds[name], want) <= (TOL if "prev_stage" in name else 1e-4), name
    ref = generic_model_state_dict_from_flax(g["grads"], device="cpu")
    assert sorted(ref) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        assert _err(p.grad, ref[name]) <= (2e-3 if name.startswith("implicit_function_1") else 1e-4), name


COARSE = dict(FN, n_harmonic_functions_xyz=2, n_hidden_neurons_xyz=24, n_layers_xyz=3, append_xyz=(2,))


def test_pass_sharing_and_heterogeneous_coarse_pass():
    """One implicit function for both passes (one set of weights, both
    passes' gradients summed into it); a coarse pass of its own
    architecture (2 harmonics, 3 layers of 24, the skip at 2) before the
    fine pass.  The coarse loss within 1e-5, the objective within 1e-4 and
    every gradient within 2e-3 of its largest entry (the fine pass's
    depths move by rounding / pdf)."""
    jc, tc = _cameras()
    image, fg, _ = _frames(3)
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(13)
    cases = [
        (dict(MODEL, share_implicit_function_across_passes=True), _variables(12, n_fns=1)),
        (dict(MODEL, coarse_implicit_function_class_type="NeuralRadianceFieldImplicitFunction",
              coarse_implicit_function_args=COARSE),
         {"params": {"implicit_function_0": _fn_params(rng, d_in=15, hidden=24, n_layers=3, skip=2),
                     "implicit_function_1": _fn_params(rng)}}),
    ]
    batch_j = dict(image_rgb=jnp.asarray(image), camera=jc, fg_probability=jnp.asarray(fg))

    def jrun(all_variables):
        out = []
        for (cfg, _), v in zip(cases, all_variables):
            def jloss(v, jm=JGenericModel(**cfg)):
                preds = jm.apply(v, **batch_j, evaluation_mode=JMode.TRAINING, key=key)
                return preds["objective"], preds["loss_prev_stage_rgb_mse"]

            out.append(jax.value_and_grad(jloss, has_aux=True)(v))
        return out, _model_draws(key, 2)

    results, draws = jax.tree_util.tree_map(np.asarray, _jit(jrun)([v for _, v in cases]))
    batch_t = dict(image_rgb=_t(image), camera=tc, fg_probability=_t(fg))
    for (cfg, variables), ((obj, coarse_mse), grads) in zip(cases, results):
        model = _port_model(variables, **cfg)
        assert len(list(model.parameters())) == sum(
            2 * (len(p["xyz_encoder"]) + 4) for p in variables["params"].values())
        preds = model(**batch_t, evaluation_mode=EvaluationMode.TRAINING, draws=_draws_t(draws))
        preds["objective"].backward()
        assert _err(preds["loss_prev_stage_rgb_mse"], coarse_mse) <= TOL
        assert _err(preds["objective"], obj) <= 1e-4
        ref = generic_model_state_dict_from_flax(grads, device="cpu")
        for name, p in model.named_parameters():
            assert _err(p.grad, ref[name]) <= 2e-3, name


def test_model_helpers_and_epoch_callbacks():
    """OverfitModel's defaults, the empty epoch schedule of NeRF, view
    pooling through an identity aggregator without a function that attends
    over the views raising, and the helpers of models/utils.py."""
    model = OverfitModel(**MODEL, device="cpu", generator=torch.Generator().manual_seed(0))
    assert model.num_passes == 2 and model.epoch_subscriptions() == ()
    state = model.state_dict()
    same, changed = model.apply_epoch_callbacks(state, 3)
    assert same is state and not changed
    with pytest.raises(ValueError):
        GenericModel(view_pooler_enabled=True, view_pooler_args=dict(
            feature_aggregator_class_type="IdentityFeatureAggregator"), device="cpu")
    assert registry.get(ImplicitronModelBase, "GenericModel") is GenericModel
    rng = np.random.default_rng(14)
    bundle = ImplicitronRayBundle(*(_t(rng.standard_normal((2, 3, 5, k)).astype(np.float32)) for k in (3, 3, S, 2)))
    extra = _t(rng.standard_normal((2, 15, 4)).astype(np.float32))
    chunks = list(mutils.chunk_generator(4, bundle, {"extra": extra, "flag": 1}, "arg", scale=2))
    assert [a[0].origins.shape[1] for a, _ in chunks] == [4, 4, 4, 3] and chunks[0][0][1] == "arg"
    assert torch.equal(torch.cat([kw["extra"] for _, kw in chunks], 1), extra) and chunks[0][1]["scale"] == 2
    out = mutils.apply_chunked(lambda b, *a, **kw: {"sum": b.lengths.sum(-1), "render": ImplicitronRender(
        image_render=kw["extra"])}, chunks, lambda xs: torch.cat(xs, 1))
    assert torch.equal(out["sum"], bundle.lengths.reshape(2, 15, S).sum(-1))
    assert torch.equal(out["render"].image_render, extra) and out["render"].depth_render is None
    cat = mutils.cat_dataclass([bundle, bundle], lambda xs: torch.cat(xs, 0))
    assert cat.origins.shape == (4, 3, 5, 3) and cat.bins is None
    image, fg, depth = _frames(4)
    img, mask, dep = mutils.preprocess_input(_t(image), _t(fg), _t(depth), True, True, 0.5, (0.1, 0.2, 0.3))
    m = (fg >= 0.5).astype(np.float32)
    assert np.allclose(img.numpy(), image * m + (1 - m) * np.array([0.1, 0.2, 0.3], np.float32))
    assert np.array_equal(mask.numpy(), m) and np.array_equal(dep.numpy(), depth * m)
    with pytest.raises(ValueError):
        mutils.preprocess_input(_t(image[0]), None, None, True, True, 0.5, 0.0)
    preds = {"loss_a": torch.tensor(2.0), "loss_b": torch.tensor(3.0)}
    assert float(mutils.weighted_sum_losses(preds, {"loss_a": 0.5, "loss_b": 2.0, "loss_c": 1.0})) == 7.0
    with pytest.warns(UserWarning):
        assert mutils.weighted_sum_losses(preds, {"loss_c": 1.0}) is None


def test_model_dbir_against_jax():
    """ModelDBIR's unprojected cloud and its render (the plain points
    rasterizer here), below max_points and subsampled with JAX's scores:
    masks equal, images and depths within 1e-5."""
    jc, tc = _cameras()
    image, fg, depth = _frames(5)
    depth = np.where(depth > 0, depth, -1.0).astype(np.float32)  # background behind the camera
    sizes = (0, 60)

    def jrun(c, i, d):
        outs = [JModelDBIR(render_image_width=W, render_image_height=H, max_points=m)(camera=c, image_rgb=i,
                                                                                     depth_map=d) for m in sizes]
        scores = jax.random.uniform(jax.random.PRNGKey(0), (1, 2 * H * W))  # the subsample's, in JAX's Pointclouds
        return [{k: o[k] for k in ("images_render", "depths_render", "masks_render")} for o in outs], scores

    jouts, jscores = _jit(jrun)(jc, jnp.asarray(image), jnp.asarray(depth))
    for max_points, jout in zip(sizes, jouts):
        scores = _t(jscores) if max_points else None
        out = ModelDBIR(render_image_width=W, render_image_height=H, max_points=max_points)(
            camera=tc, image_rgb=_t(image), depth_map=_t(depth), scores=scores)
        assert out["point_cloud"].points_padded().shape == (1, max_points or 2 * H * W, 3)
        assert torch.equal(out["masks_render"], _t(jout["masks_render"]))
        for name in ("images_render", "depths_render"):
            assert _err(out[name], jout[name]) <= TOL, name
        assert out["implicitron_render"].image_render is out["images_render"]


if __name__ == "__main__":
    # The fine pass's agreement between JAX's own eager and jitted
    # evaluation renders, and the port's against the jitted one.
    jc, tc = _cameras()
    image, fg, _ = _frames()
    variables = _variables(9)
    jm = JGenericModel(**MODEL)
    batch = dict(image_rgb=jnp.asarray(image), camera=jc, fg_probability=jnp.asarray(fg))

    def jeval(v):
        return jm.apply(v, **batch, evaluation_mode=JMode.EVALUATION, key=jax.random.PRNGKey(10))["images_render"]

    jitted = jax.jit(jeval)(variables)
    eager = jeval(variables)
    with torch.no_grad():
        got = _port_model(variables, **MODEL)(image_rgb=_t(image), camera=tc, fg_probability=_t(fg),
                                              evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
    print("JAX eager vs jitted: share within 1e-5 %.4f, max %.3g" % _fine_share(torch.tensor(np.asarray(eager)), jitted))
    print("port vs JAX jitted:  share within 1e-5 %.4f, max %.3g" % _fine_share(got, jitted))
