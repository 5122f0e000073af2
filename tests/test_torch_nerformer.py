"""The port's decoding functions and NeRFormer against the JAX package's,
on the CPU: `ElementwiseDecoder`, Implicitron's `MLPWithInputSkips` (with
the affine skip) and `MLPDecoder`, `TransformerEncoderLayer`,
`TransformerWithInputSkips` with and without the pool axis, the NeRFormer
function on per-view features, and `GenericModel` with
repro_singleseq_nerformer's layout (angle-weighted identity pooling kept
per view) at tiny widths: a transformer of 16 hidden with 4 heads, 2
layers, the skip at 1, the width halved each layer.

Inputs, weights (flax-layout numpy from a seed) and tolerances as in
tests/test_torch_implicitron_pooling.py, whose helpers this file shares;
the JAX side is jitted once per module fixture.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.implicitron.models.implicit_function import decoding_functions as jdec
from pytorch3d_tpu.implicitron.models.implicit_function.neural_radiance_field import (
    NeRFormerImplicitFunction as JNeRFormer,
)
from pytorch3d_tpu.implicitron.models.renderer.base import ImplicitronRayBundle as JBundle
from pytorch3d_tpu_torch.convert import generic_model_state_dict_from_flax
from pytorch3d_tpu_torch.implicitron.models.implicit_function import (
    ElementwiseDecoder,
    MLPDecoder,
    MLPWithInputSkips,
    NeRFormerImplicitFunction,
)
from pytorch3d_tpu_torch.implicitron.models.implicit_function import decoding_functions as tdec
from pytorch3d_tpu_torch.implicitron.models.renderer import ImplicitronRayBundle
from test_torch_implicitron_pooling import (
    EXTRACTOR,
    N_RAYS,
    SIZE,
    TOL,
    S,
    _err,
    _err_floor,
    _fill,
    _jit,
    _load,
    _np_tree,
    _t,
    check_evaluation,
    check_training,
    generic_case,
)

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

FORMER = dict(n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2, n_hidden_neurons_xyz=16, n_hidden_neurons_dir=16)
NERFORMER = dict(
    render_image_width=SIZE, render_image_height=SIZE, chunk_size_grid=256,
    implicit_function_class_type="NeRFormerImplicitFunction", implicit_function_args=FORMER,
    raysampler_args=dict(scene_extent=2.0, n_pts_per_ray_training=S, n_pts_per_ray_evaluation=S,
                         n_rays_per_image_sampled_from_mask=N_RAYS),
    renderer_args=dict(n_pts_per_ray_fine_training=S, n_pts_per_ray_fine_evaluation=S),
    view_pooler_enabled=True, image_feature_extractor_args=EXTRACTOR,
    view_pooler_args=dict(feature_aggregator_class_type="AngleWeightedIdentityFeatureAggregator"),
)
MLP_CASES = {
    "plain": dict(n_layers=3, input_dim=10, output_dim=5, skip_dim=10, hidden_dim=12, input_skips=(2,),
                  last_activation="softplus", last_layer_bias_init=0.5),
    "affine skip": dict(n_layers=3, input_dim=10, output_dim=4, skip_dim=7, hidden_dim=12, input_skips=(1,),
                        skip_affine_trans=True, last_activation="identity", use_xavier_init=False),
}


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, 6, 10)).astype(np.float32),
            "z": rng.standard_normal((4, 6, 7)).astype(np.float32),
            "seq": rng.standard_normal((5, 3, 16)).astype(np.float32),
            "pool": rng.standard_normal((3, 2, 4, 6, 11)).astype(np.float32),
            "cot": rng.standard_normal((2, 4, 6, 9)).astype(np.float32)}


def _fn_inputs(seed=4):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((2, 5, 3)).astype(np.float32) * 0.3
    d = rng.standard_normal((2, 5, 3)).astype(np.float32)
    lengths = np.sort(rng.uniform(1.0, 3.0, (2, 5, S)), -1).astype(np.float32)
    w = rng.standard_normal((3, 3, 5)).astype(np.float32)
    cot = rng.standard_normal((2, 5, S, 4)).astype(np.float32)
    return o, d, lengths, w, cot


def _modules():
    return {
        "plain": jdec.MLPWithInputSkips(**MLP_CASES["plain"]),
        "affine skip": jdec.MLPWithInputSkips(**MLP_CASES["affine skip"]),
        "decoder": jdec.MLPDecoder(input_dim=10, network_args=dict(n_layers=2, output_dim=3, hidden_dim=8,
                                                                   input_skips=(1,), skip_dim=10)),
        "encoder layer": jdec.TransformerEncoderLayer(d_model=16, d_model_out=8, n_heads=4, dim_feedforward=20),
        "transformer": jdec.TransformerWithInputSkips(n_layers=2, output_dim=9, hidden_dim=16, input_skips=(1,),
                                                     n_heads=4, dim_down_factor=2.0),
    }


@functools.lru_cache(maxsize=None)
def _jax_side():
    """Every JAX piece's variables, outputs and (transformer) VJPs, and the
    NeRFormer function's, in one jit."""
    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    mods = _modules()
    args = {"plain": (inp["x"],), "affine skip": (inp["x"], inp["z"]), "decoder": (inp["x"],),
            "encoder layer": (inp["seq"],), "transformer": (inp["pool"], inp["pool"], True)}
    key = jax.random.PRNGKey(0)
    variables = {n: _fill(jax.eval_shape(lambda k, m=m, a=a: m.init(k, *a), key), 30 + i)
                 for i, (n, (m, a)) in enumerate(zip(mods, zip(mods.values(), args.values())))}
    o, d, lengths, w, cot = _fn_inputs()
    fn = JNeRFormer(**FORMER)

    def pool(p, w=w):  # per-view features (V, ..., 5), a smooth function of the point
        return jnp.tanh(jnp.einsum("...i,vij->v...j", p, jnp.asarray(w)))

    pool.per_view = True
    b = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(d), lengths=jnp.asarray(lengths),
                xys=jnp.asarray(o[..., :2]))
    variables["nerformer"] = _fill(jax.eval_shape(lambda k: fn.init(k, ray_bundle=b, fun_viewpool=pool), key), 40)

    def run(variables, inp, o, d):
        out = {}
        for name in ("plain", "affine skip", "decoder", "encoder layer"):
            a = {"plain": (inp["x"],), "affine skip": (inp["x"], inp["z"]), "decoder": (inp["x"],),
                 "encoder layer": (inp["seq"],)}[name]
            out[name] = mods[name].apply(variables[name], *a)
        tr = mods["transformer"]
        y, vjp = jax.vjp(lambda v, x: tr.apply(v, x, x, pool_axis=True), variables["transformer"], inp["pool"])
        out["transformer"] = (y, *vjp(inp["cot"]))
        out["transformer no pool"] = tr.apply(variables["transformer"], inp["pool"][0], inp["pool"][0])

        def f(v, o, d):
            bb = JBundle(origins=o, directions=d, lengths=jnp.asarray(lengths), xys=o[..., :2])
            return jnp.concatenate(fn.apply(v, ray_bundle=bb, fun_viewpool=pool), -1)

        y, vjp = jax.vjp(f, variables["nerformer"], o, d)
        out["nerformer"] = (y, *vjp(jnp.asarray(cot)))
        return out

    outs = _jit(run)(variables, inp, jnp.asarray(o), jnp.asarray(d))
    return _np_tree(variables), _np_tree(outs)


@pytest.mark.parametrize("operation", ["relu", "softplus", "sigmoid", "identity"])
def test_elementwise_decoder(operation):
    """operation(x * 2 - 0.5), equal to JAX's (which needs no weights, so
    this runs its eager apply); an unknown operation raises on the call."""
    x = np.random.default_rng(1).standard_normal((7, 3)).astype(np.float32)
    want = jdec.ElementwiseDecoder(scale=2.0, shift=-0.5, operation=operation).apply({}, jnp.asarray(x))
    got = ElementwiseDecoder(scale=2.0, shift=-0.5, operation=operation)(_t(x))
    assert _err(got, want) <= 1e-6
    with pytest.raises(ValueError):
        ElementwiseDecoder(operation="tanh")(_t(x))


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_implicitron_mlp_with_input_skips(case):
    """Implicitron's MLP: a concatenated skip with a softplus last layer and
    a constant last bias; an affine skip ((y - mu) * softplus(log std) from
    z) with an identity last layer and lecun init; within 1e-5."""
    variables, outs = _jax_side()
    inp = _inputs()
    mlp = _load(MLPWithInputSkips(**MLP_CASES[case], device="cpu"), variables[case]["params"], "implicit_function_0")
    got = mlp(_t(inp["x"]), _t(inp["z"]) if case == "affine skip" else None)
    assert _err(got, outs[case]) <= TOL
    if case == "plain":
        fresh = MLPWithInputSkips(**MLP_CASES[case], device="cpu", generator=torch.Generator().manual_seed(0))
        assert torch.all(fresh.layer2.bias == 0.5) and torch.all(fresh.layer0.bias == 0)


def test_mlp_decoder():
    """MLPDecoder's `network` (2 layers of 8, the skip at 1) within 1e-5."""
    variables, outs = _jax_side()
    inp = _inputs()
    dec = MLPDecoder(input_dim=10, network_args=dict(n_layers=2, output_dim=3, hidden_dim=8, input_skips=(1,),
                                                     skip_dim=10), device="cpu")
    _load(dec, variables["decoder"]["params"], "implicit_function_0")
    assert _err(dec(_t(inp["x"])), outs["decoder"]) <= TOL


def test_transformer_encoder_layer():
    """Attention (4 heads of 4, flax's layout) and the truncated residual
    narrowing 16 to 8, post-norm at eps 1e-6, within 1e-5."""
    variables, outs = _jax_side()
    layer = _load(tdec.TransformerEncoderLayer(16, 8, 4, 20, device="cpu"), variables["encoder layer"]["params"],
                  "implicit_function_0")
    got = layer(_t(_inputs()["seq"]))
    assert got.shape == (5, 3, 8) and _err(got, outs["encoder layer"]) <= TOL


def test_transformer_with_input_skips():
    """The trunk on (3 views, 2 x 4 rays, 6 points, 11): attention over the
    views then the points per layer (widths 16 -> 8 -> 4), the skip at 1,
    the softmax pool over the views; the output within 1e-5, every
    gradient within 1e-4 of its largest entry (the attention's key biases,
    whose gradient is zero up to rounding, of 1e-3 of the largest
    parameter gradient: measured 2.1e-5 there); without the pool axis (one
    view) within 1e-5."""
    variables, outs = _jax_side()
    inp = _inputs()
    tr = _load(tdec.TransformerWithInputSkips(2, 11, 9, 11, 16, (1,), 4, 2.0, device="cpu"),
               variables["transformer"]["params"], "implicit_function_0")
    x = _t(inp["pool"]).requires_grad_(True)
    y = tr(x, x, pool_axis=True)
    y.backward(_t(inp["cot"]))
    want, jgrads, jx = outs["transformer"]
    assert y.shape == (2, 4, 6, 9) and _err(y, want) <= TOL
    assert _err(x.grad, jx) <= 1e-4
    ref = generic_model_state_dict_from_flax({"implicit_function_0": jgrads["params"]}, device="cpu")
    floor = 1e-3 * max(float(v.abs().max()) for v in ref.values())
    for name, p in tr.named_parameters():
        assert _err_floor(p.grad, ref["implicit_function_0." + name], floor) <= 1e-4, name
    with torch.no_grad():
        assert _err(tr(_t(inp["pool"][0]), _t(inp["pool"][0])), outs["transformer no pool"]) <= TOL


def test_nerformer_function_on_per_view_features():
    """NeRFormer (16 hidden, 2 layers, the skip at 1, factor 2) on 3 views'
    features of 5 channels: densities and colours within 1e-5, every
    gradient within 1e-4 of its largest entry (or of 1e-3 of the largest
    gradient: the key biases'); it asks for features without
    aggregation."""
    variables, outs = _jax_side()
    o, d, lengths, w, cot = _fn_inputs()
    fn = _load(NeRFormerImplicitFunction(**FORMER, latent_dim=5, device="cpu"), variables["nerformer"]["params"],
               "implicit_function_0")
    tw = _t(w)

    def pool(p):
        return torch.tanh(torch.einsum("...i,vij->v...j", p, tw))

    pool.per_view = True
    to, td = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    got = torch.cat(fn(ImplicitronRayBundle(to, td, _t(lengths), to[..., :2]), fun_viewpool=pool), -1)
    got.backward(_t(cot))
    want, jgrads, jgo, jgd = outs["nerformer"]
    assert _err(got, want) <= TOL
    assert _err(to.grad, jgo) <= 1e-4 and _err(td.grad, jgd) <= 1e-4
    ref = generic_model_state_dict_from_flax({"implicit_function_0": jgrads["params"]}, device="cpu")
    floor = 1e-3 * max(float(v.abs().max()) for v in ref.values())
    for name, p in fn.named_parameters():
        assert _err_floor(p.grad, ref["implicit_function_0." + name], floor) <= 1e-4, name
    assert NeRFormerImplicitFunction.requires_pooling_without_aggregation()
    assert fn.xyz_encoder.dims == [16, 8, 4]


@pytest.fixture(scope="module")
def nerformer():
    return generic_case(NERFORMER, 12)


def test_nerformer_generic_model_evaluation_chunked_and_against_jax(nerformer):
    """repro_singleseq_nerformer's model at tiny widths: the 32^2 grid of 3
    views in chunks of 256 rays equals the unchunked render to the bit;
    against JAX every ray within 1e-5."""
    share, worst = check_evaluation(nerformer, 1.0)
    assert worst <= 1e-5


def test_nerformer_generic_model_training_objective_and_gradients(nerformer):
    """With JAX's draws: the objective and the fine loss within 1e-4, the
    coarse function's and the ResNet's gradients within 1e-4 of their
    largest entries, the fine function's within 2e-3 (its depths move by
    rounding / pdf)."""
    check_training(nerformer, 1e-4, lambda n: 2e-3 if n.startswith("implicit_function_1") else 1e-4)
