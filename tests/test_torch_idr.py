"""The port's IDR family against the JAX package's, on the CPU: weight norm
and the geometric initialisation's layout, `RayTracing` on analytic sphere
SDFs (the cases of tests/test_ray_tracing.py) and on the IDR field, the
colouring network in its three modes, and GenericModel with
`IdrFeatureField` and `SignedDistanceFunctionRenderer`: the training
objective (rgb, mask BCE, eikonal) and every gradient, second-order terms
included, against `jax.grad`, with the eikonal draws handed in; and the
evaluation render, chunked equal to unchunked, against JAX's.

Sizes are tiny: an IDR field of 2 x 32 with the skip at 1 and 2
harmonics, a colouring network of 2 x 32, n_steps 16, 2 images of 8 x 8,
32 rays an image.  The weights are the port's seeded geometric
initialisation as numpy arrays in the flax layout, handed to JAX as they
are and to the port through `convert.generic_model_state_dict_from_flax`;
the JAX side is jitted.  The port's GenericModel gives the SDF renderer the
foreground at each ray as its object mask, which JAX's GenericModel does
not pass: its renderer here is a subclass that samples the same mask
(`_MaskedRenderer`).  Tolerance: 1e-5 of the values' magnitude unless a
test states another.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.implicitron.models import GenericModel as JGenericModel
from pytorch3d_tpu.implicitron.models.implicit_function.idr_feature_field import IdrFeatureField as JIdr
from pytorch3d_tpu.implicitron.models.implicit_function.idr_feature_field import _WeightNormDense as JWeightNorm
from pytorch3d_tpu.implicitron.models.renderer.base import EvaluationMode as JMode
from pytorch3d_tpu.implicitron.models.renderer.ray_tracing import RayTracing as JRayTracing
from pytorch3d_tpu.implicitron.models.renderer.rgb_net import RayNormalColoringNetwork as JRgbNet
from pytorch3d_tpu.implicitron.models.renderer.sdf_renderer import SignedDistanceFunctionRenderer as JSdfRenderer
from pytorch3d_tpu.implicitron.tools.config import registry as jregistry
from pytorch3d_tpu.renderer.utils import ndc_grid_sample as j_ndc_grid_sample
from pytorch3d_tpu_torch.convert import generic_model_state_dict_from_flax
from pytorch3d_tpu_torch.implicitron.models import GenericModel
from pytorch3d_tpu_torch.implicitron.models.implicit_function import IdrFeatureField
from pytorch3d_tpu_torch.implicitron.models.implicit_function.idr_feature_field import _WeightNormDense
from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode, RayTracing
from pytorch3d_tpu_torch.implicitron.models.renderer.rgb_net import RayNormalColoringNetwork
from test_torch_implicitron_models import _cameras, _err, _frames, _jit, _t

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TOL = 1e-5
H = W = 8
N_RAYS = 32
IDR = dict(n_harmonic_functions_xyz=2, dims=(32, 32), skip_in=(1,), bias=0.6)
RGB = dict(dims=(32, 32))
LOSSES = {"loss_rgb_mse": 1.0, "loss_mask_bce": 1.0, "loss_eikonal": 0.1}
MODEL = dict(
    render_image_width=W, render_image_height=H, num_passes=1, chunk_size_grid=24, loss_weights=LOSSES,
    raysampler_args=dict(scene_extent=3.0, n_pts_per_ray_training=4, n_pts_per_ray_evaluation=4,
                         n_rays_per_image_sampled_from_mask=N_RAYS),
    implicit_function_class_type="IdrFeatureField", implicit_function_args=IDR,
    global_encoder_class_type="SequenceAutodecoder", global_encoder_args=dict(encoding_dim=4, n_instances=3),
)
_MASK = {}  # the masked JAX renderer's foreground, set before its trace


@jregistry.register
@dataclasses.dataclass
class _MaskedRenderer(JSdfRenderer):
    """JAX's SDF renderer given the foreground at each ray as its object
    mask, sampled as the port's GenericModel samples it."""

    def __call__(self, ray_bundle, implicit_functions=(), evaluation_mode=JMode.EVALUATION, object_mask=None,
                 key=None, **kwargs):
        fg = (_MASK["fg"] >= 0.5).astype(jnp.float32)
        sampled = j_ndc_grid_sample(jnp.moveaxis(fg, -1, 1), ray_bundle.xys, mode="nearest")[:, 0] > 0.5
        return super().__call__(ray_bundle, implicit_functions, evaluation_mode, object_mask=sampled, key=key,
                                **kwargs)


def _flax(state, prefix=""):
    """The flax tree of the port's state dict entries under `prefix` (all
    where it is empty)."""
    tree = {}
    for name, value in state.items():
        if prefix and not name.startswith(prefix + "."):
            continue
        *path, leaf = (name[len(prefix) + 1:] if prefix else name).split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().numpy().copy()
    return tree


def _variables(seed, rgb=True):
    """Seeded weights in the flax layout: the port's geometric
    initialisation of the field, the colouring network's torch-Linear
    draws, and a code table."""
    g = torch.Generator().manual_seed(seed)
    model = GenericModel(**_model_cfg(rgb), device="cpu", generator=g)
    state = model.state_dict()
    params = {"implicit_function_0": _flax(state, "implicit_function_0"),
              "_global_encoder": {"autodecoder": {"Embed_0": _flax(state, "_global_encoder.autodecoder")}}}
    if rgb:
        params["_renderer_flax_module"] = _flax(state, "_renderer.rgb_network")
    return {"params": params}


def _model_cfg(rgb=True, masked=False):
    renderer = dict(ray_tracer_args=dict(n_steps=16))
    if rgb:
        renderer["ray_normal_coloring_network_args"] = RGB
    return dict(MODEL, renderer_args=renderer,
                renderer_class_type="_MaskedRenderer" if masked else "SignedDistanceFunctionRenderer")


def test_weight_norm_and_geometric_init():
    """Weight norm: W = scale * v / sqrt(sum v^2 + 1e-12) per output column,
    the port's layer against JAX's on the same kernel, scale and bias
    (1e-6); the scale starts at the column norms.  The geometric
    initialisation's layout, in both packages: the first layer reads only
    the embedding's last three (raw xyz) channels, the skip layer's rows of
    the appended harmonics are zero, the last layer's kernel is
    sqrt(pi / in) within 1e-3 and its bias -bias; the field starts near the
    sphere SDF |x| - bias, as far in both packages."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((7, 5)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 2, 5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    x = rng.standard_normal((4, 7)).astype(np.float32)
    pts = rng.uniform(-0.6, 0.6, (256, 3)).astype(np.float32)

    def jrun(x, pts):
        params = JIdr(**IDR).init(jax.random.PRNGKey(1), pts)["params"]
        dense = JWeightNorm(5).apply({"params": {"kernel": v, "scale": scale, "bias": bias}}, x)
        return dense, params, JIdr(**IDR).apply({"params": params}, pts)[..., 0]

    want, jparams, jax_sdf = jax.tree_util.tree_map(np.asarray, _jit(jrun)(jnp.asarray(x), jnp.asarray(pts)))
    layer = _WeightNormDense(7, 5, device="cpu")
    layer.load_state_dict({"kernel": _t(v), "scale": _t(scale), "bias": _t(bias)})
    assert _err(layer(_t(x)), want) <= 1e-6
    layer.init_scale()
    assert torch.allclose(layer.scale, torch.linalg.norm(_t(v), dim=0), rtol=1e-6)

    field = IdrFeatureField(**IDR, device="cpu", generator=torch.Generator().manual_seed(1))
    embed = 3 * (2 * IDR["n_harmonic_functions_xyz"] + 1)
    for kernels in ({n: getattr(field, n).kernel.detach().numpy() for n in ("linear0", "linear1", "linear2")},
                    {n: np.asarray(jparams[n]["kernel"]) for n in ("linear0", "linear1", "linear2")}):
        assert not kernels["linear0"][:-3].any() and kernels["linear0"][-3:].all()
        assert not kernels["linear1"][-embed:-3].any() and kernels["linear1"][-3:].all()
        assert abs(kernels["linear2"].mean() - np.sqrt(np.pi / 32)) < 1e-3
    assert torch.all(field.linear2.bias == -0.6) and np.all(np.asarray(jparams["linear2"]["bias"]) == -0.6)
    sphere = np.linalg.norm(pts, axis=-1) - 0.6
    with torch.no_grad():
        port = field.get_sdf(_t(pts)).numpy()
    # at this width both packages' initial fields sit 0.08-0.18 from the sphere on average over seeds 0-3 (here
    # 0.083 and 0.131), correlated with it at 0.57-0.85
    for sdf in (port, jax_sdf):
        assert np.abs(sdf - sphere).mean() < 0.25 and np.corrcoef(sdf, sphere)[0, 1] > 0.5


def _sphere_rays(impact):
    b = np.asarray(impact, np.float32)
    o = np.stack([b, np.zeros_like(b), np.full_like(b, 3.0)], axis=-1)[None]
    d = np.broadcast_to(np.asarray([0.0, 0.0, -1.0], np.float32), o.shape).copy()
    return o, d


# tests/test_ray_tracing.py's cases: (impact parameters, radius, the SDF's scale, tracer args)
TRACE_CASES = [
    ([0.0, 0.2, 0.4, 0.6], 0.8, 1.0, dict(sphere_tracing_iters=16, n_steps=24)),
    ([0.788, 0.792, 0.796, 0.804, 0.81, 0.82], 0.8, 1.0, dict(sphere_tracing_iters=8, n_steps=24)),
    ([0.7, 0.9], 0.5, 1.0, dict(sphere_tracing_iters=8, n_steps=48)),
    ([1.5], 0.8, 1.0, {}),
    ([0.0, 0.3], 0.8, 2.0, dict(sphere_tracing_iters=6, n_steps=24, line_step_iters=1)),
]


def test_ray_tracing_analytic_spheres():
    """Every case of tests/test_ray_tracing.py (direct hits, grazing rays,
    misses, a ray outside the bounding sphere, an overshooting SDF): the
    same hits, and points and depths within 1e-6 of JAX's."""
    def jtrace_all(args):
        out = []
        for (impact, r, k, kw), (o, d) in zip(TRACE_CASES, args):
            tracer = JRayTracing(object_bounding_sphere=1.0, n_secant_steps=8, **kw)
            out.append(tracer(lambda p, r=r, k=k: k * (jnp.linalg.norm(p, axis=-1) - r), o,
                              jnp.ones(o.shape[:-1], bool), d))
        return out

    rays = [_sphere_rays(c[0]) for c in TRACE_CASES]
    want = jax.tree_util.tree_map(np.asarray, _jit(jtrace_all)([tuple(map(jnp.asarray, r)) for r in rays]))
    for (impact, r, k, kw), (o, d), (wp, wm, wd) in zip(TRACE_CASES, rays, want):
        tracer = RayTracing(object_bounding_sphere=1.0, n_secant_steps=8, **kw)
        p, m, dist = tracer(lambda p, r=r, k=k: k * (torch.linalg.norm(p, dim=-1) - r), _t(o),
                            torch.ones(o.shape[:-1], dtype=torch.bool), _t(d))
        assert np.array_equal(m.numpy(), wm), impact
        assert np.abs(p.numpy() - wp).max() <= 1e-6 and np.abs(dist.numpy() - wd).max() <= 1e-6, impact


def test_ray_tracing_idr_field_and_rgb_net_modes():
    """The tracer on the IDR field (rays from the two cameras' origins
    through a spread of directions): the same hits, depths within 1e-5 of
    the largest; then the colouring network in its three modes (with 2
    direction harmonics in "no_normal") at the traced points, 1e-5."""
    variables = _variables(2)
    fvars = {"params": variables["params"]["implicit_function_0"]}
    rng = np.random.default_rng(3)
    o = np.repeat(np.array([[[0.0, 0.0, 2.5]], [[0.3, -0.2, 2.4]]], np.float32), 40, axis=1)
    d = (rng.uniform(-0.45, 0.45, (2, 40, 3)) + np.array([0.0, 0.0, -1.0])).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    modes = [("idr", {}), ("no_view_dir", {}), ("no_normal", dict(n_harmonic_functions_dir=2))]
    rgb_nets = [(JRgbNet(**RGB, mode=m, **kw), RayNormalColoringNetwork(**RGB, mode=m, **kw, device="cpu",
                                                                        generator=torch.Generator().manual_seed(i)))
                for i, (m, kw) in enumerate(modes)]
    rgb_vars = [{"params": _flax(net.state_dict())} for _, net in rgb_nets]
    feats = rng.standard_normal((80, 3)).astype(np.float32)
    normals = rng.standard_normal((80, 3)).astype(np.float32)

    def jrun(fvars, o, d, rgb_vars):
        def sdf(p):
            return JIdr(**IDR).apply(fvars, p)[..., 0]

        traced = JRayTracing(n_steps=16)(sdf, o, jnp.ones(o.shape[:-1], bool), d)
        colours = [jnet.apply(v, jnp.asarray(feats), traced[0], jnp.asarray(normals), d.reshape(-1, 3))
                   for (jnet, _), v in zip(rgb_nets, rgb_vars)]
        return traced, colours

    (wp, wm, wd), wcol = jax.tree_util.tree_map(np.asarray, _jit(jrun)(fvars, jnp.asarray(o), jnp.asarray(d),
                                                                      rgb_vars))
    field = IdrFeatureField(**IDR, device="cpu")
    field.load_state_dict({k[len("implicit_function_0."):]: v for k, v in generic_model_state_dict_from_flax(
        variables, device="cpu").items() if k.startswith("implicit_function_0.")}, strict=True)
    p, m, dist = RayTracing(n_steps=16)(lambda x: field(x)[..., 0], _t(o), torch.ones((2, 40), dtype=torch.bool),
                                        _t(d))
    assert np.array_equal(m.numpy(), wm) and 0 < wm.sum() < wm.size
    assert _err(dist, wd) <= TOL and _err(p, wp) <= TOL
    with torch.no_grad():
        for (_, net), want in zip(rgb_nets, wcol):
            assert _err(net(_t(feats), p, _t(normals), _t(d).reshape(-1, 3)), want) <= TOL


def _draws(key, B):
    """The JAX GenericModel's draws from `key` in training (inside a jit):
    key -> (rays, render); rays -> (select, stratify); the eikonal points
    uniform(render key, (B * rays // 2, 3)) in the bounding box."""
    k_rays, k_render = jax.random.split(key)
    key_sel, key_strat = jax.random.split(k_rays)
    return {"u_jiggle": jax.random.uniform(key_strat, (B, N_RAYS, 4)),
            "select": jax.vmap(lambda k: jax.random.gumbel(k, (N_RAYS, H * W), jnp.float32))(
                jax.random.split(key_sel, B)),
            "eikonal": jax.random.uniform(k_render, (B * N_RAYS // 2, 3), minval=-1.0, maxval=1.0)}


@pytest.fixture(scope="module")
def idr_model():
    """The JAX GenericModel's (IDR, SDF renderer with the colouring network,
    the masked renderer) training objective, losses and gradients and its
    evaluation render (jitted together)."""
    jc, tc = _cameras()
    image, fg, _ = _frames(5)
    variables = _variables(4)
    names = ["seq_a", "seq_b"]
    key = jax.random.PRNGKey(21)
    _MASK["fg"] = jnp.asarray(fg)
    jm = JGenericModel(**_model_cfg(masked=True))
    batch = dict(image_rgb=jnp.asarray(image), camera=jc, fg_probability=jnp.asarray(fg), sequence_name=names)

    def jrun(v):
        def jloss(v):
            preds = jm.apply(v, **batch, evaluation_mode=JMode.TRAINING, key=key)
            return preds["objective"], {k: x for k, x in preds.items() if k.startswith("loss")}

        render = jm.apply(v, **batch, evaluation_mode=JMode.EVALUATION, key=key)
        return (jax.value_and_grad(jloss, has_aux=True)(v),
                [render[k] for k in ("images_render", "depths_render", "masks_render")], _draws(key, 2))

    ((objective, losses), grads), renders, draws = jax.tree_util.tree_map(np.asarray, _jit(jrun)(variables))
    return dict(variables=variables, tc=tc, image=image, fg=fg, names=names, objective=objective, losses=losses,
                grads=grads, renders=renders, draws={k: _t(v) for k, v in draws.items()})


def _port(case, cfg):
    model = GenericModel(**cfg, device="cpu")
    model.load_state_dict(generic_model_state_dict_from_flax(case["variables"], device="cpu"), strict=True)
    return model


def test_generic_model_training_objective_and_gradients(idr_model):
    """Training with JAX's draws: the objective and each loss within 1e-5
    (measured 5e-7); every parameter's gradient within 1e-5 of its largest
    entry (measured 1.1e-6; the eikonal term's and the normals'
    second-order terms included; the code table's is zero: IDR takes no
    global code, in both)."""
    c = idr_model
    model = _port(c, _model_cfg())
    preds = model(image_rgb=_t(c["image"]), camera=c["tc"], fg_probability=_t(c["fg"]), sequence_name=c["names"],
                  evaluation_mode=EvaluationMode.TRAINING, draws=c["draws"])
    preds["objective"].backward()
    assert _err(preds["objective"], c["objective"]) <= TOL
    for name in LOSSES:
        assert _err(preds[name], c["losses"][name]) <= TOL, name
    ref = generic_model_state_dict_from_flax(c["grads"], device="cpu")
    assert sorted(ref) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        if name.startswith("_global_encoder"):
            assert p.grad is None and not ref[name].any()
            continue
        assert _err(p.grad, ref[name]) <= TOL, name


def test_generic_model_evaluation_chunked_and_against_jax(idr_model):
    """The full 8 x 8 grid in chunks of 24 rays equals the unchunked render
    to the bit; images, depths and masks within 1e-5 of JAX's (measured
    2.4e-6 on the soft masks; 30 % of the rays hit)."""
    c = idr_model
    model = _port(c, _model_cfg())
    batch = dict(image_rgb=_t(c["image"]), camera=c["tc"], fg_probability=_t(c["fg"]), sequence_name=c["names"])
    with torch.no_grad():
        chunked = model(**batch, evaluation_mode=EvaluationMode.EVALUATION)
        model.chunk_size_grid = 0
        whole = model(**batch, evaluation_mode=EvaluationMode.EVALUATION)
    for name, want in zip(("images_render", "depths_render", "masks_render"), c["renders"]):
        assert torch.equal(chunked[name], whole[name]), name
        assert _err(chunked[name], want) <= TOL, name
