"""The port's view pooling against the JAX package's, on the CPU: the
feature extractor's pieces (the antialiased resize, "SAME" stride-2 convs,
the two ResNet blocks, the extractor with its flags), the aggregators, the
view sampler and per-view sampling, the NeRF function with aggregated
pooled features, the plain fused field at the view-conditioned NeRF's input
width, `GenericModel` with WCE pooling (repro_*_nerf_wce's layout at tiny
widths) in training and evaluation, its `source_views` render against
the JAX pieces composed by hand, and `render_flyaround`.

Sizes are tiny: 32^2 images, resnet18 stages (1, 2) with proj_dim 8, 3
source views, 16 rays an image, 8 + 8 points, NeRF layers of 32.  The
weights are seeded numpy arrays in the flax variables' layout (the JAX
tree's shapes from `jax.eval_shape`), handed to JAX as they are and to the
port through `convert.generic_model_state_dict_from_flax`.  The JAX side
is jitted, once per module fixture.

Tolerances: the same float32 formulas in another order, 1e-5 of the
values' magnitude, unless a test states another.  The fine pass's depths
are `sample_pdf`'s inverse cdf of the coarse weights, which amplifies
their last bits: it is held by the share of rays within 1e-5 (run this
file as a script to print JAX's eager-against-jitted share and the
port's).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from pytorch3d_tpu.implicitron.models import GenericModel as JGenericModel
from pytorch3d_tpu.implicitron.models.feature_extractor import resnet_feature_extractor as jrfe
from pytorch3d_tpu.implicitron.models.implicit_function.neural_radiance_field import (
    NeuralRadianceFieldImplicitFunction as JNeRFFn,
)
from pytorch3d_tpu.implicitron.models.renderer.base import EvaluationMode as JMode
from pytorch3d_tpu.implicitron.models.renderer.base import ImplicitronRayBundle as JBundle
from pytorch3d_tpu.implicitron.models.view_pooler import feature_aggregator as jagg
from pytorch3d_tpu.implicitron.models.view_pooler.view_pooler import ViewPooler as JViewPooler
from pytorch3d_tpu.implicitron.models.view_pooler.view_sampler import ViewSampler as JViewSampler
from pytorch3d_tpu.ops import fused_mlp_pallas as jfm
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JPersp
from pytorch3d_tpu_torch.convert import fov_perspective_cameras_from_numpy, generic_model_state_dict_from_flax
from pytorch3d_tpu_torch.implicitron.models import GenericModel
from pytorch3d_tpu_torch.implicitron.models.feature_extractor import resnet_feature_extractor as trfe
from pytorch3d_tpu_torch.implicitron.models.implicit_function import NeuralRadianceFieldImplicitFunction
from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode, ImplicitronRayBundle
from pytorch3d_tpu_torch.implicitron.models.view_pooler import feature_aggregator as tagg
from pytorch3d_tpu_torch.implicitron.models.view_pooler.view_pooler import ViewPooler
from pytorch3d_tpu_torch.implicitron.models.view_pooler.view_sampler import (
    ViewSampler,
    cameras_points_cartesian_product,
    handle_seq_id,
    project_points_and_sample,
)
from pytorch3d_tpu_torch.ops import fused_mlp_cuda as tfm

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TOL = 1e-5
SIZE = 32
V = 3
N_RAYS, S = 16, 8
EXTRACTOR = dict(arch="resnet18", stages=(1, 2), proj_dim=8, image_rescale=0.5)
FN = dict(n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16,
          n_layers_xyz=2, append_xyz=(1,))
# repro_multiseq_nerf_wce's layout: an angle-weighted reduction over the views and a sequence code
WCE = dict(
    render_image_width=SIZE, render_image_height=SIZE, chunk_size_grid=256, implicit_function_args=FN,
    raysampler_args=dict(scene_extent=2.0, n_pts_per_ray_training=S, n_pts_per_ray_evaluation=S,
                         n_rays_per_image_sampled_from_mask=N_RAYS),
    renderer_args=dict(n_pts_per_ray_fine_training=S, n_pts_per_ray_fine_evaluation=S),
    view_pooler_enabled=True, image_feature_extractor_args=EXTRACTOR,
    view_pooler_args=dict(feature_aggregator_class_type="AngleWeightedReductionFeatureAggregator"),
    global_encoder_class_type="SequenceAutodecoder", global_encoder_args=dict(encoding_dim=4, n_instances=3),
)
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, static_argnums=()):
    """jax.jit(fn), compiled without XLA's expensive CPU passes (a third of
    the compile time; the results within float32 rounding of the optimised
    build's)."""

    def run(*args):
        return jax.jit(fn, static_argnums=static_argnums).lower(*args).compile(compiler_options=FAST_XLA)(
            *(a for i, a in enumerate(args) if i not in static_argnums))

    return run


def _err(got, want):
    """max |got - want| / max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _err_floor(got, want, floor):
    """max |got - want| / max(max |want|, floor): for a gradient that is
    zero up to rounding (attention's key bias: the softmax ignores a shift
    common to every key), held against a floor set from its neighbours."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-30)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fill(shapes, seed):
    """Seeded values for a flax variable tree of these shapes: kernels
    uniform within sqrt(3 / fan_in) (attention's q / k / v over their input
    width), biases within 0.1, batch and layer norm scales and variances
    in [0.8, 1.2], embeddings standard normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        shape = s.shape
        if name == "kernel":
            fan_in = shape[0] if parent in ("query", "key", "value") else math.prod(shape[:-1])
            lim = math.sqrt(3.0 / fan_in)
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "embedding":
            return rng.standard_normal(shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(module, variables, prefix):
    """module.load_state_dict of the flax subtree `prefix` (strict)."""
    state = generic_model_state_dict_from_flax({prefix: variables}, device="cpu")
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in state.items()}, strict=True)
    return module


def _cameras(n=V):
    """Source cameras 2.5 from the origin with rotations exact in float32
    (identity, a quarter and a half turn about y), so both packages
    project alike."""
    rots = [np.eye(3), np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]), np.diag([-1.0, 1.0, -1.0])]
    R = np.stack(rots[:n]).astype(np.float32)
    T = np.array([[0.0, 0.0, 2.5], [0.1, -0.05, 2.5], [-0.1, 0.05, 2.4]][:n], np.float32)
    ones = np.ones(n, np.float32)
    jc = JPersp.create(R=jnp.asarray(R), T=jnp.asarray(T), znear=0.5, zfar=5.0, fov=50.0)
    tc = fov_perspective_cameras_from_numpy(R, T, 0.5 * ones, 5.0 * ones, ones, 50.0 * ones, device="cpu")
    return jc, tc


def _frames(seed=0, n=V):
    """(image (n, SIZE, SIZE, 3), fg probability (n, SIZE, SIZE, 1) with
    soft edges)."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    c = (SIZE - 1) / 2
    disc = np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (SIZE * SIZE / 10))
    fg = np.clip(disc[None, ..., None] + rng.uniform(-0.2, 0.2, (n, SIZE, SIZE, 1)), 0, 1).astype(np.float32)
    return image, fg


def _sample_inputs(seed=1, P=40, C=5):
    """Points around the origin, feature maps (V, C, 8, 8), masks (V, 1, 8,
    8) with a zero view in places."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (1, P, 3)).astype(np.float32)
    feats = {"a": rng.standard_normal((V, C, 8, 8)).astype(np.float32),
             "b": rng.standard_normal((V, 2, 8, 8)).astype(np.float32)}
    masks = (rng.uniform(0, 1, (V, 1, 8, 8)) > 0.3).astype(np.float32)
    return pts, feats, masks


AGGREGATORS = {
    "identity": ("IdentityFeatureAggregator", {}),
    "reduction": ("ReductionFeatureAggregator", dict(reduction_functions=("avg", "std", "std_avg", "max"))),
    "angle identity": ("AngleWeightedIdentityFeatureAggregator", dict(weight_by_ray_angle_gamma=2.0)),
    "angle reduction": ("AngleWeightedReductionFeatureAggregator", dict(min_ray_angle_weight=0.3)),
}
EXTRACTOR_FLAGS = {
    "defaults": dict(EXTRACTOR),
    "no pool, no norm, no image norm": dict(EXTRACTOR, first_max_pool=False, l2_norm=False, normalize_image=False,
                                            image_rescale=0.375),
    "global pool, rescaled, no masks or images": dict(EXTRACTOR, global_average_pool=True, feature_rescale=2.0,
                                                      add_masks=False, add_images=False, image_rescale=1.0),
    "bottleneck, no projection": dict(arch="resnet50", stages=(1,), proj_dim=0, image_rescale=0.5),
}


@functools.lru_cache(maxsize=None)
def _jax_pieces():
    """Every JAX piece of the extractor and the pooler on the tests' inputs,
    in one jit: ({name: variables}, {name: outputs})."""
    image, fg = _frames()
    x_img = jnp.asarray(image)
    pieces = {
        "conv even": (fnn.Conv(6, (3, 3), strides=(2, 2), use_bias=False), np.zeros((1, 16, 16, 4), np.float32)),
        "conv odd": (fnn.Conv(6, (3, 3), strides=(2, 2), use_bias=False), np.zeros((1, 15, 17, 4), np.float32)),
        "basic": (jrfe.BasicBlock(12, stride=2), np.zeros((2, 9, 10, 8), np.float32)),
        "bottleneck": (jrfe.Bottleneck(16, stride=2), np.zeros((2, 9, 10, 8), np.float32)),
    }
    for name, flags in EXTRACTOR_FLAGS.items():
        pieces[name] = (jrfe.ResNetFeatureExtractor(**flags), None)
    key = jax.random.PRNGKey(0)
    variables = {}
    for i, (name, (module, x)) in enumerate(pieces.items()):
        args = (x_img, jnp.asarray(fg)) if x is None else (jnp.asarray(x),)
        variables[name] = _fill(jax.eval_shape(module.init, key, *args), 100 + i)
    rng = np.random.default_rng(5)
    inputs = {n: rng.uniform(-1, 1, x.shape).astype(np.float32) for n, (_, x) in pieces.items() if x is not None}
    pts, feats, masks = _sample_inputs()
    jc, _ = _cameras()

    def run(variables, inputs, image, fg, pts, feats, masks):
        out = {f"resize {s}": jax.image.resize(image, (V, int(round(SIZE * s)), int(round(SIZE * s)), 3), "bilinear")
               for s in (0.16, 0.375, 1.5)}
        for name, (module, x) in pieces.items():
            args = (image, fg) if x is None else (inputs[name],)
            out[name] = module.apply(variables[name], *args)
        sampled, smasks = JViewSampler()(jnp.asarray(pts), None, jc, None, feats, masks)
        out["sampler"] = (sampled, smasks)
        out["project"] = __import__(
            "pytorch3d_tpu.implicitron.models.view_pooler.view_sampler", fromlist=["x"]
        ).project_points_and_sample(jnp.concatenate([pts, pts[:, ::-1] * 0.5]), feats, jc, masks)
        for name, (cls, kw) in AGGREGATORS.items():
            agg = getattr(jagg, cls)(**kw)
            out[name] = agg(sampled, smasks, camera=jc, pts=pts)
            pooler = JViewPooler(feature_aggregator_class_type=cls, feature_aggregator_args=kw)
            out[f"pooler {name}"] = (pooler(pts=pts, camera=jc, feats=feats, masks=masks),
                                     pooler.sample_per_view(pts=pts, camera=jc, feats=feats, masks=masks))
        return out

    outs = _jit(run)(variables, inputs, x_img, jnp.asarray(fg), jnp.asarray(pts),
                     {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(masks))
    return _np_tree(variables), inputs, _np_tree(outs)


def _tree_close(got, want, tol=TOL):
    for k in want:
        assert _err(got[k], want[k]) <= tol, k


@pytest.mark.parametrize("scale", [0.16, 0.375, 1.5])
def test_resize_matches_jax_image_resize(scale):
    """`jax.image.resize(..., "bilinear")` antialiases when it shrinks:
    F.interpolate(antialias=True) at 0.16 and 0.375 (5^2 and 12^2 from
    32^2), and the plain bilinear at 1.5 (48^2), within 1e-5."""
    image, _ = _frames()
    _, _, outs = _jax_pieces()
    side = int(round(SIZE * scale))
    got = trfe.resize_bilinear(_t(image), (side, side))
    assert got.shape == (V, side, side, 3) and _err(got, outs[f"resize {scale}"]) <= TOL


@pytest.mark.parametrize("name", ["conv even", "conv odd"])
def test_stride_two_conv_pads_as_flax_same(name):
    """A 3x3 stride-2 conv pads (0, 1) on an even side and (1, 1) on an odd
    one, as flax's "SAME" does (Conv2d(padding=1) would shift the even
    side's samples by a pixel)."""
    variables, inputs, outs = _jax_pieces()
    x = inputs[name]
    conv = trfe._Conv(4, 6, 3, 2, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(_t(variables[name]["params"]["kernel"].transpose(3, 2, 0, 1)))
    got = conv(_t(x).movedim(-1, 1)).movedim(1, -1)
    assert got.shape == outs[name].shape and _err(got, outs[name]) <= TOL
    assert trfe._Conv.same_pads(16, 3, 2) == (0, 1) and trfe._Conv.same_pads(15, 3, 2) == (1, 1)


@pytest.mark.parametrize("name,cls", [("basic", trfe.BasicBlock), ("bottleneck", trfe.Bottleneck)])
def test_resnet_blocks(name, cls):
    """BasicBlock (8 -> 12) and Bottleneck (8 -> 16) at stride 2 with the
    downsampling skip, on a 9 x 10 input, from the same weights."""
    variables, inputs, outs = _jax_pieces()
    block = _load(cls(8, 12 if name == "basic" else 16, 2, device="cpu"), variables[name]["params"],
                  "_image_feature_extractor")
    got = block(_t(inputs[name]).movedim(-1, 1)).movedim(1, -1)
    assert _err(got, outs[name]) <= TOL


@pytest.mark.parametrize("flags", list(EXTRACTOR_FLAGS))
def test_resnet_feature_extractor(flags):
    """Every output map of the extractor (resnet18 stages (1, 2) with the
    projections; without the max pool, the l2 norm and the image
    normalisation; global pooling with a feature rescale and no mask or
    image entries; resnet50's bottleneck stage 1 unprojected), and the
    channel count it reports."""
    variables, _, outs = _jax_pieces()
    image, fg = _frames()
    ext = _load(trfe.ResNetFeatureExtractor(**EXTRACTOR_FLAGS[flags], device="cpu"), variables[flags]["params"],
                "_image_feature_extractor")
    got = ext(_t(image), masks=_t(fg))
    assert sorted(got) == sorted(outs[flags])
    _tree_close(got, outs[flags])
    j = jrfe.ResNetFeatureExtractor(**EXTRACTOR_FLAGS[flags])
    assert ext.get_feat_dims() == j.get_feat_dims()


def test_torchvision_state_dict_loads_by_name():
    """`params_from_torch_state_dict` puts torchvision-named weights
    (conv1, bn1, layer{s}.{b}.conv{i} / bn{i} / downsample) into the
    extractor's state dict: the result equals JAX's loader's after the
    converter; a shape that differs raises."""
    ext = trfe.ResNetFeatureExtractor(**EXTRACTOR, device="cpu")
    rng = np.random.default_rng(3)
    tv = {"conv1.weight": rng.standard_normal((64, 3, 7, 7)).astype(np.float32),
          "layer2.0.conv1.weight": rng.standard_normal((128, 64, 3, 3)).astype(np.float32),
          "layer2.0.downsample.0.weight": rng.standard_normal((128, 64, 1, 1)).astype(np.float32),
          "layer3.0.conv1.weight": rng.standard_normal((256, 128, 3, 3)).astype(np.float32), "fc.weight": 0}
    for bn, n in (("bn1", 64), ("layer2.0.downsample.1", 128)):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            tv[f"{bn}.{leaf}"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    state = trfe.params_from_torch_state_dict(ext, tv)
    ext.load_state_dict(state, strict=True)
    assert np.array_equal(ext.stem_conv.weight.detach().numpy(), tv["conv1.weight"])
    assert np.array_equal(ext.layer2_block0.downsample_bn.mean.detach().numpy(), tv["layer2.0.downsample.1.running_mean"])
    jm = jrfe.ResNetFeatureExtractor(**EXTRACTOR)
    image, fg = _frames()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(fg))
    jparams = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    jnew = jrfe.params_from_torch_state_dict(jparams, {k: v for k, v in tv.items() if k != "fc.weight"}, "resnet18")
    want = generic_model_state_dict_from_flax({"_image_feature_extractor": _np_tree(jnew)["params"]}, device="cpu")
    for name in ("stem_conv.weight", "stem_bn.var", "layer2_block0.conv1.weight", "layer2_block0.downsample_conv.weight"):
        assert np.array_equal(state[name].numpy(), want["_image_feature_extractor." + name].numpy()), name
    with pytest.raises(ValueError):
        trfe.params_from_torch_state_dict(ext, {"conv1.weight": np.zeros((64, 3, 5, 5), np.float32)})


def test_view_sampler_and_projection():
    """ViewSampler's (V, P, C) samples and masks, and
    project_points_and_sample's cartesian product of point batches and
    cameras; the crc32 sequence ids."""
    _, _, outs = _jax_pieces()
    pts, feats, masks = _sample_inputs()
    _, tc = _cameras()
    tfeats = {k: _t(v) for k, v in feats.items()}
    sampled, smasks = ViewSampler()(_t(pts), None, tc, None, tfeats, _t(masks))
    _tree_close(sampled, outs["sampler"][0])
    assert _err(smasks, outs["sampler"][1]) <= TOL
    pts2 = np.concatenate([pts, pts[:, ::-1] * 0.5])
    got, gmasks = project_points_and_sample(_t(pts2), tfeats, tc, _t(masks))
    _tree_close(got, outs["project"][0])
    assert _err(gmasks, outs["project"][1]) <= TOL
    cams, rep = cameras_points_cartesian_product(tc, _t(pts2))
    assert cams.R.shape == (2 * V, 3, 3) and torch.equal(cams.R[1], tc.R[0]) and rep.shape == (2 * V, 40, 3)
    import zlib

    from pytorch3d_tpu.implicitron.models.view_pooler.view_sampler import handle_seq_id as jhandle

    # JAX's int64 request becomes int32 without x64, too narrow for crc32: the port keeps int64
    assert handle_seq_id(["a", "bc"], device="cpu").tolist() == [zlib.crc32(b"a"), zlib.crc32(b"bc")]
    assert handle_seq_id([3, 4], device="cpu").tolist() == np.asarray(jhandle([3, 4])).tolist()
    assert handle_seq_id(np.array([3, 4]), device="cpu").dtype == torch.int64


@pytest.mark.parametrize("name", list(AGGREGATORS))
def test_aggregators_and_pooler(name):
    """Each aggregator on the sampled features and masks (views masked out
    in places: max takes -inf there, std_avg the mean std), the ViewPooler
    around it, and `sample_per_view` (the view axis kept, the ray-angle
    weights of the angle-weighted identity applied)."""
    _, _, outs = _jax_pieces()
    pts, feats, masks = _sample_inputs()
    _, tc = _cameras()
    tfeats = {k: _t(v) for k, v in feats.items()}
    cls, kw = AGGREGATORS[name]
    sampled, smasks = ViewSampler()(_t(pts), None, tc, None, tfeats, _t(masks))
    agg = getattr(tagg, cls)(**kw)
    _tree_close(agg(sampled, smasks, camera=tc, pts=_t(pts)), outs[name])
    pooler = ViewPooler(feature_aggregator_class_type=cls, feature_aggregator_args=kw)
    _tree_close(pooler(pts=_t(pts), camera=tc, feats=tfeats, masks=_t(masks)), outs[f"pooler {name}"][0])
    per_view, pmasks = pooler.sample_per_view(pts=_t(pts), camera=tc, feats=tfeats, masks=_t(masks))
    _tree_close(per_view, outs[f"pooler {name}"][1][0])
    assert _err(pmasks, outs[f"pooler {name}"][1][1]) <= TOL
    assert pooler.has_aggregation() == ("Identity" not in cls)
    assert agg.get_aggregated_feature_dim(20, V) == getattr(jagg, cls)(**kw).get_aggregated_feature_dim(20, V)


# --------------------------------------------------------------------------- #
# the NeRF function with pooled features, the fused field at D = 327
# --------------------------------------------------------------------------- #


def _pooled_fn_inputs():
    rng = np.random.default_rng(7)
    o = rng.standard_normal((2, 5, 3)).astype(np.float32) * 0.3
    d = rng.standard_normal((2, 5, 3)).astype(np.float32)
    lengths = np.sort(rng.uniform(1.0, 3.0, (2, 5, S)), -1).astype(np.float32)
    w = rng.standard_normal((3, 6)).astype(np.float32)
    cot = rng.standard_normal((2, 5, S, 4)).astype(np.float32)
    return o, d, lengths, w, cot


@functools.lru_cache(maxsize=None)
def _jax_pooled_fn():
    """The NeRF function with a pooled feature of 6 channels (a smooth
    function of the point), its output and VJP, jitted."""
    o, d, lengths, w, cot = _pooled_fn_inputs()
    fn = JNeRFFn(**FN)

    def pool(p, w=w):
        return jnp.tanh(p @ w)

    b = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(d), lengths=jnp.asarray(lengths),
                xys=jnp.asarray(o[..., :2]))
    variables = _fill(jax.eval_shape(lambda k: fn.init(k, ray_bundle=b, fun_viewpool=pool), jax.random.PRNGKey(0)),
                      8)

    def run(v, o, d):
        def f(v, o, d):
            bb = JBundle(origins=o, directions=d, lengths=jnp.asarray(lengths), xys=o[..., :2])
            return jnp.concatenate(fn.apply(v, ray_bundle=bb, fun_viewpool=pool), -1)

        out, vjp = jax.vjp(f, v, o, d)
        return out, vjp(jnp.asarray(cot))

    return _np_tree(variables), _np_tree(_jit(run)(variables, jnp.asarray(o), jnp.asarray(d)))


def test_nerf_function_with_aggregated_pooling():
    """Pooled features (6 channels) concatenated after the harmonic
    embedding before the fused field (#12 / #13's plain versions on the
    CPU): densities and colours within 1e-5, every gradient (the points'
    through the pooled features too) within 1e-4 of its largest entry."""
    variables, (want, (jgrads, jgo, jgd)) = _jax_pooled_fn()
    o, d, lengths, w, cot = _pooled_fn_inputs()
    fn = _load(NeuralRadianceFieldImplicitFunction(**FN, latent_dim=6, device="cpu"), variables["params"],
               "implicit_function_0")
    tw = _t(w)
    to, td = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    got = torch.cat(fn(ImplicitronRayBundle(to, td, _t(lengths), to[..., :2]),
                       fun_viewpool=lambda p: torch.tanh(p @ tw)), -1)
    got.backward(_t(cot))
    assert _err(got, want) <= TOL
    assert _err(to.grad, jgo) <= 1e-4 and _err(td.grad, jgd) <= 1e-4
    ref = generic_model_state_dict_from_flax({"implicit_function_0": jgrads["params"]}, device="cpu")
    for name, p in fn.named_parameters():
        assert _err(p.grad, ref["implicit_function_0." + name]) <= 1e-4, name


def test_plain_fused_field_at_the_wce_input_width():
    """The fused field's plain version (what #12 is held against) at D =
    327, repro_singleseq_nerf_wce's trunk input (63 harmonic + 264 pooled
    features), 2 layers of 64 with the skip at 1, against JAX's
    `fused_nerf_field_reference`, within 1e-5 (that the kernels take it
    beside the NeRF widths is held on the card, test_torch_cuda.py)."""
    rng = np.random.default_rng(9)
    N, D, H, Ddir, Hh = 300, 327, 64, 27, 32

    def dense(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32), (rng.standard_normal(o) * 0.05).astype(np.float32)

    x = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    de = rng.uniform(-1, 1, (N, Ddir)).astype(np.float32)
    (w0, b0), (w1, b1) = dense(D, H), dense(H + D, H)
    wd, bd = dense(H, 1)
    wi, bi = dense(H, H)
    wc1, bc1 = dense(H + Ddir, Hh)
    wc2, bc2 = dense(Hh, 3)
    head = (wd, bd, wi, bi, wc1[:H], wc1[H:], bc1, wc2, bc2)
    want = jax.jit(jfm.fused_nerf_field_reference, static_argnums=5)(
        jnp.asarray(x), jnp.asarray(de), (jnp.asarray(w0), jnp.asarray(w1)), (jnp.asarray(b0), jnp.asarray(b1)),
        tuple(jnp.asarray(h) for h in head), (1,))
    got = tfm.fused_nerf_field_plain(_t(x), _t(de), [_t(w0), _t(w1)], [_t(b0), _t(b1)], [_t(h) for h in head], (1,))
    assert _err(got, want) <= TOL


# --------------------------------------------------------------------------- #
# GenericModel with WCE pooling
# --------------------------------------------------------------------------- #


def _model_draws(key, B, n_fine=S):
    """The JAX GenericModel's training draws from `key` (call inside a jit):
    key -> (rays, render); rays -> (select Gumbel per image, stratify);
    the refine's quantiles uniform(render key, (B, n, n_fine))."""
    k_rays, k_render = jax.random.split(key)
    key_sel, key_strat = jax.random.split(k_rays)
    return {"u_jiggle": jax.random.uniform(key_strat, (B, N_RAYS, S)),
            "u_pdf": jax.random.uniform(k_render, (B, N_RAYS, n_fine)),
            "select": jax.vmap(lambda k: jax.random.gumbel(k, (N_RAYS, SIZE * SIZE), jnp.float32))(
                jax.random.split(key_sel, B))}


def generic_case(cfg, seed, names=None, extra=None):
    """The JAX GenericModel at `cfg` on V frames from seeded variables:
    its evaluation render, its training objective, losses and gradients
    (jitted together, with `extra(model, variables, batch, key)` where
    given), the draws, and the inputs both sides take."""
    jc, tc = _cameras()
    image, fg = _frames(seed)
    key = jax.random.PRNGKey(seed)
    jm = JGenericModel(**cfg)
    kw = {} if names is None else {"sequence_name": names}
    batch = dict(image_rgb=jnp.asarray(image), camera=jc, fg_probability=jnp.asarray(fg), **kw)
    shapes = jax.eval_shape(lambda k: jm.init(k, **batch, evaluation_mode=JMode.TRAINING, key=key),
                            jax.random.PRNGKey(0))
    variables = _fill(shapes, seed + 50)

    def run(v):
        render = jm.apply(v, **batch, evaluation_mode=JMode.EVALUATION, key=key)

        def jloss(v):
            preds = jm.apply(v, **batch, evaluation_mode=JMode.TRAINING, key=key)
            return preds["objective"], {k: x for k, x in preds.items() if k.startswith("loss")}

        more = None if extra is None else extra(jm, v, batch, key)
        return render["images_render"], jax.value_and_grad(jloss, has_aux=True)(v), _model_draws(key, V), more

    want_eval, ((objective, losses), grads), draws, more = _np_tree(_jit(run)(variables))
    return dict(cfg=cfg, variables=_np_tree(variables), tc=tc, image=image, fg=fg, kw=kw,
                draws={k: _t(v) for k, v in draws.items()}, want_eval=want_eval, objective=objective,
                losses=losses, grads=grads, extra=more)


def port_model(case):
    model = GenericModel(**case["cfg"], device="cpu")
    model.load_state_dict(generic_model_state_dict_from_flax(case["variables"], device="cpu"), strict=True)
    return model


def fine_share(got, want):
    err = np.abs(got.detach().numpy().astype(np.float64) - np.asarray(want, np.float64)).max(-1)
    return float((err <= 1e-5).mean()), float(err.max())


def check_evaluation(case, share_gate):
    """Chunked equals unchunked to the bit; against JAX at least
    `share_gate` of the rays within 1e-5."""
    model = port_model(case)
    batch = dict(image_rgb=_t(case["image"]), camera=case["tc"], fg_probability=_t(case["fg"]), **case["kw"])
    with torch.no_grad():
        chunked = model(**batch, evaluation_mode=EvaluationMode.EVALUATION)
        model.chunk_size_grid = 0
        whole = model(**batch, evaluation_mode=EvaluationMode.EVALUATION)
    assert chunked["images_render"].shape == (V, SIZE, SIZE, 3)
    for name in ("images_render", "depths_render", "masks_render"):
        assert torch.equal(chunked[name], whole[name]), name
    share, worst = fine_share(chunked["images_render"], case["want_eval"])
    assert share >= share_gate, (share, worst)
    return share, worst


def check_training(case, loss_tol, grad_tol):
    """With JAX's draws: the coarse loss within 1e-5, the others and the
    objective within `loss_tol`; every parameter's gradient (the ResNet's
    included) within `grad_tol(name)` of its largest entry, or of 1e-3 of
    the largest gradient of any parameter where that is larger."""
    model = port_model(case)
    preds = model(image_rgb=_t(case["image"]), camera=case["tc"], fg_probability=_t(case["fg"]), **case["kw"],
                  evaluation_mode=EvaluationMode.TRAINING, draws=case["draws"])
    preds["objective"].backward()
    assert _err(preds["objective"], case["objective"]) <= loss_tol
    assert sorted(k for k in preds if k.startswith("loss")) == sorted(case["losses"])
    for name, want in case["losses"].items():
        assert _err(preds[name], want) <= (TOL if "prev_stage" in name else loss_tol), name
    ref = generic_model_state_dict_from_flax(case["grads"], device="cpu")
    assert sorted(ref) == sorted(n for n, _ in model.named_parameters())
    worst, floor = {}, 1e-3 * max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for name, p in model.named_parameters():
        worst[name] = _err_floor(p.grad, ref[name], floor)
        assert worst[name] <= grad_tol(name), (name, worst[name])
    return worst


SOURCES, TARGET = [0, 2], 1  # a render of view 1's camera pooled from views 0 and 2 only


def _jax_source_views_render(jm, variables, batch, key):
    """The JAX pieces composed by hand into what the port's `source_views`
    does (the JAX GenericModel pools from the rendered cameras only): the
    evaluation rays of camera TARGET, the extractor on the SOURCES' masked
    images, the ViewPooler with the SOURCES' cameras at the rays' points,
    the sequence's code, and the renderer over the whole grid."""

    def render(m):
        pick = jnp.asarray(SOURCES)
        src_camera = jax.tree_util.tree_map(lambda x: x[pick], batch["camera"])
        target = jax.tree_util.tree_map(lambda x: x[TARGET:TARGET + 1], batch["camera"])
        image, fg, _ = m._preprocess_input(batch["image_rgb"][pick], batch["fg_probability"][pick], None)
        k_rays, k_render = jax.random.split(key)
        bundle = m._raysampler(target, JMode.EVALUATION, mask=None, key=k_rays)
        feats = {k: f for k, f in m._image_feature_extractor(image, masks=fg).items() if k != "global_code"}

        def fun_viewpool(pts):
            pooled = m._view_pooler(pts=pts.reshape(1, -1, 3), camera=src_camera, feats=feats, masks=None)
            agg = jnp.concatenate([pooled[k] for k in sorted(pooled)], axis=-1)
            return agg.reshape(pts.shape[:-1] + (agg.shape[-1],))

        code = m._global_encoder(sequence_name=[batch["sequence_name"][TARGET]], frame_timestamp=None)
        return m._renderer(bundle, implicit_functions=m._implicit_functions, evaluation_mode=JMode.EVALUATION,
                           key=k_render, fun_viewpool=fun_viewpool, camera=target, global_code=code).features

    return jm.apply(variables, method=render)


@pytest.fixture(scope="module")
def wce():
    return generic_case(WCE, 11, names=["seq_a", "seq_b", "seq_a"], extra=_jax_source_views_render)


def test_wce_generic_model_evaluation_chunked_and_against_jax(wce):
    """repro_*_nerf_wce's model at tiny widths: the full 32^2 grid of 3
    views in chunks of 256 rays equals the unchunked render to the bit (the
    same pooled features reach every chunk); against JAX every ray within
    1e-5 (measured: the port's max 2e-7; JAX's eager and jitted renders
    are equal)."""
    share, worst = check_evaluation(wce, 1.0)
    assert worst <= 1e-5


def test_wce_generic_model_training_objective_and_gradients(wce):
    """With JAX's draws: the objective and the fine loss within 1e-4 (the
    fine depths move by rounding / pdf); the coarse function's, the code's
    and the ResNet's gradients within 1e-4 of their largest entries, the
    fine function's within 2e-3."""
    check_training(wce, 1e-4, lambda n: 2e-3 if n.startswith("implicit_function_1") else 1e-4)


def test_wce_source_views_against_jax_pieces(wce):
    """`source_views` (pooling from other views than the rendered cameras,
    as every served request does): camera 1's 32^2 render pooled from views
    0 and 2 against the JAX pieces composed by hand
    (`_jax_source_views_render`), every ray within 1e-5 (measured: 1.8e-7;
    pooling from all three views instead moves it 1.4e-2, from the two in
    the other order 7.5e-3, in JAX too); and the batch's own views as
    `source_views` give the batch's render to the bit."""
    from pytorch3d_tpu_torch.renderer.camera_utils import join_cameras_as_batch

    model = port_model(wce)
    image, fg, tc = _t(wce["image"]), _t(wce["fg"]), wce["tc"]
    names = wce["kw"]["sequence_name"]
    source = dict(image_rgb=image[SOURCES], fg_probability=fg[SOURCES],
                  camera=join_cameras_as_batch([tc[i] for i in SOURCES]))
    with torch.no_grad():
        got = model(camera=tc[TARGET], sequence_name=[names[TARGET]], source_views=source,
                    evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
        own = model(image_rgb=image, camera=tc, fg_probability=fg, sequence_name=names,
                    evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
        same = model(camera=tc, sequence_name=names, evaluation_mode=EvaluationMode.EVALUATION,
                     source_views=dict(image_rgb=image, fg_probability=fg, camera=tc))["images_render"]
    assert got.shape == (1, SIZE, SIZE, 3)
    share, worst = fine_share(got, wce["extra"])
    assert share == 1.0 and worst <= 1e-5, (share, worst)
    assert torch.equal(same, own)


def test_wce_trunk_input_width(wce):
    """The trunk's input is the harmonic embedding (21), the code (4) and
    the angle-weighted mean and std of the 20 pooled channels (40): the
    kernels' D, which at repro_multiseq_nerf_wce's widths is 455."""
    model = port_model(wce)
    assert model.implicit_function_0.xyz_encoder.layer0.kernel.shape == (65, 32)
    ext = trfe.ResNetFeatureExtractor(stages=(1, 2, 3, 4), proj_dim=16, device="meta")
    pooled = tagg.AngleWeightedReductionFeatureAggregator().get_aggregated_feature_dim(ext.get_feat_dims(), 10)
    assert 63 + 256 + pooled == 455


# --------------------------------------------------------------------------- #
# render_flyaround
# --------------------------------------------------------------------------- #


FLY = dict(render_image_width=8, render_image_height=8, num_passes=1, chunk_size_grid=32,
           raysampler_args=dict(n_pts_per_ray_training=4, n_pts_per_ray_evaluation=4,
                                n_rays_per_image_sampled_from_mask=8, scene_extent=3.0),
           implicit_function_args=dict(n_hidden_neurons_xyz=8, n_hidden_neurons_dir=4, n_layers_xyz=2,
                                       append_xyz=(1,)))


class _Frames:
    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


def test_render_flyaround_frames_against_jax(tmp_path, monkeypatch):
    """render_flyaround of a model without pooling (the JAX package's own
    test's): the 3 frames it writes against JAX's, each within 5e-5 (the
    two packages' trajectory cameras differ by float32 rounding, 1.4e-7 in
    R and 7e-7 in T, which moves the frames by up to 1.1e-5), and the video
    file; then a WCE model from 2 source views (which the JAX
    function cannot render: it hands the model no image): frames of the
    render size, the last within 1e-6 of the model's own render of that
    pose from those views."""
    import os

    from pytorch3d_tpu.implicitron.dataset.frame_data import FrameData as JFrameData
    from pytorch3d_tpu.implicitron.models.visualization import render_flyaround as jfly
    from pytorch3d_tpu_torch.implicitron.dataset.frame_data import FrameData
    from pytorch3d_tpu_torch.implicitron.models.visualization import render_flyaround as tfly

    jc, tc = _cameras()
    image, fg = _frames(2)
    jframes = [JFrameData(image_rgb=jnp.asarray(image[i:i + 1]), fg_probability=jnp.asarray(fg[i:i + 1]),
                          camera=jax.tree_util.tree_map(lambda x, i=i: x[i:i + 1], jc)) for i in range(V)]
    tframes = [FrameData(image_rgb=_t(image[i:i + 1]), fg_probability=_t(fg[i:i + 1]), camera=tc[i])
               for i in range(V)]
    case = generic_case_variables(FLY, 21)
    jm = JGenericModel(**FLY)
    fast = jax.jit(lambda v, camera: jm.apply(v, camera=camera, evaluation_mode=JMode.EVALUATION))

    class JModel:  # JAX's render_flyaround applies the model once a pose: jitted here
        @staticmethod
        def apply(v, camera, evaluation_mode):
            return fast(v, camera)

    written = {"jax": [], "port": []}
    def recorder(side, writer_cls):
        original = writer_cls.write_frame

        def write_frame(self, frame, resize=None):
            written[side].append(np.asarray(frame))
            original(self, frame, resize)

        return write_frame

    monkeypatch.setattr(jfly.VideoWriter, "write_frame", recorder("jax", jfly.VideoWriter))
    jfly.render_flyaround(_Frames(jframes), None, JModel, case["variables"], str(tmp_path / "j.gif"),
                          n_flyaround_poses=3, fps=2)
    model = port_model(case)
    path = tfly.render_flyaround(_Frames(tframes), None, model, str(tmp_path / "t.gif"), n_flyaround_poses=3, fps=2)
    assert os.path.isfile(path) and os.path.getsize(path) > 0
    monkeypatch.setattr(tfly.VideoWriter, "write_frame", recorder("port", tfly.VideoWriter))
    tfly.render_flyaround(_Frames(tframes), None, model, str(tmp_path / "t2.gif"), n_flyaround_poses=3, fps=2)
    assert len(written["port"]) == len(written["jax"]) == 3
    for got, want in zip(written["port"], written["jax"]):
        assert _err(got, want) <= 5e-5

    written["port"].clear()
    wce_model = GenericModel(**WCE_FLY, device="cpu", generator=torch.Generator().manual_seed(22))
    tfly.render_flyaround(_Frames(tframes), None, wce_model, str(tmp_path / "w.gif"), n_flyaround_poses=2, fps=2,
                          n_source_views=2)
    assert [f.shape for f in written["port"]] == [(SIZE, SIZE, 3)] * 2
    traj = tfly.generate_eval_video_cameras(tfly.join_cameras_as_batch([f.camera for f in tframes]), n_eval_cams=2)
    src = [tframes[0], tframes[2]]
    with torch.no_grad():
        own = wce_model(camera=traj[1], evaluation_mode=EvaluationMode.EVALUATION, source_views=dict(
            image_rgb=torch.cat([f.image_rgb for f in src]), fg_probability=torch.cat([f.fg_probability for f in src]),
            camera=tfly.join_cameras_as_batch([f.camera for f in src])))["images_render"][0]
    assert _err(own, written["port"][1]) <= 1e-6  # measured: an ulp (1.2e-7) between the two calls


WCE_FLY = dict(WCE, chunk_size_grid=512, global_encoder_class_type=None, global_encoder_args=None)


def generic_case_variables(cfg, seed):
    """Seeded flax-layout variables for the JAX GenericModel at cfg."""
    jc, _ = _cameras()
    image, fg = _frames(seed)
    jm = JGenericModel(**cfg)
    shapes = jax.eval_shape(lambda k: jm.init(k, image_rgb=jnp.asarray(image), camera=jc,
                                              fg_probability=jnp.asarray(fg), evaluation_mode=JMode.TRAINING),
                            jax.random.PRNGKey(0))
    return dict(cfg=cfg, variables=_np_tree(_fill(shapes, seed)))


if __name__ == "__main__":
    # The fine pass's spread: JAX's eager evaluation render against its
    # jitted one, and the port's against the jitted one, at WCE.
    case = generic_case(WCE, 11, names=["seq_a", "seq_b", "seq_a"])
    jc, _ = _cameras()
    image, fg = _frames(11)
    eager = JGenericModel(**WCE).apply(case["variables"], image_rgb=jnp.asarray(image), camera=jc,
                                       fg_probability=jnp.asarray(fg), sequence_name=["seq_a", "seq_b", "seq_a"],
                                       evaluation_mode=JMode.EVALUATION, key=jax.random.PRNGKey(11))
    err = np.abs(np.asarray(eager["images_render"], np.float64) - case["want_eval"]).max(-1)
    print(f"JAX eager against jitted: share within 1e-5 {float((err <= 1e-5).mean()):.6f}, max {err.max():.3e}")
    print("port against JAX jitted: share within 1e-5 and max", check_evaluation(case, 0.0))
