"""The port's voxel grids and `VoxelGridImplicitFunction` against the JAX
package's, on the CPU: the interpolators at the grid's edges and outside
it under both paddings and both `align_corners`, `interpolate_tensor` in
every mode with and without antialias, the three grids and
`VoxelGridModule`, the resolution change, the crop and the scaffold, the
function on its legacy and its full surface, and GenericModel around it:
`apply_epoch_callbacks` across a resolution change and a crop, then the
training objective and every gradient against `jax.grad`.

Sizes are tiny (8^3-16^3 grids, 6 components, 32 rays x 16 points).  The
grid values are seeded numpy arrays in the flax layout, handed to JAX as
they are and to the port through `convert.generic_model_state_dict_from_
flax`.  JAX contracts the small axes with one-hot weight matrices, the
port gathers the corners: the same float32 blend in another order.
Tolerance: 1e-6 of the values' magnitude unless a test states another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.implicitron.models import GenericModel as JGenericModel
from pytorch3d_tpu.implicitron.models.implicit_function import voxel_grid as jvg
from pytorch3d_tpu.implicitron.models.implicit_function.voxel_grid_implicit_function import (
    VoxelGridImplicitFunction as JVoxelFn,
)
from pytorch3d_tpu.implicitron.models.renderer.base import EvaluationMode as JMode
from pytorch3d_tpu.implicitron.models.renderer.base import ImplicitronRayBundle as JBundle
from pytorch3d_tpu_torch.convert import generic_model_state_dict_from_flax
from pytorch3d_tpu_torch.implicitron.models import GenericModel
from pytorch3d_tpu_torch.implicitron.models.implicit_function import VoxelGridImplicitFunction, VoxelGridModule
from pytorch3d_tpu_torch.implicitron.models.implicit_function import utils as futils
from pytorch3d_tpu_torch.implicitron.models.implicit_function import voxel_grid as tvg
from pytorch3d_tpu_torch.implicitron.models.renderer import EvaluationMode, ImplicitronRayBundle
from pytorch3d_tpu_torch.implicitron.models.utils import load_state_dict_resized
from test_torch_implicitron_models import _cameras, _err, _frames, _jit, _t

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TOL = 1e-6
N_RAYS, S = 32, 16
H = W = 8
EXTENTS = (3.0, 3.0, 3.0)


def _edge_points(rng, n_dims, n=40):
    """(1, P, n_dims): random interior points, points exactly on the
    boundary (+-1), and points outside it (+-1.25)."""
    pts = rng.uniform(-1, 1, (n, n_dims))
    pts[:6] = rng.choice([-1.0, 1.0], (6, n_dims))
    pts[6:12, 0] = 1.25 * rng.choice([-1.0, 1.0], 6)
    pts[12:16] = rng.choice([-1.0, 1.0, -1.25, 1.25], (4, n_dims))
    return pts[None].astype(np.float32)


INTERP_SOURCES = {"line": (8,), "plane": (7, 9), "volume": (6, 7, 8)}
INTERP_CASES = [(p, ac, mode) for p in ("zeros", "border") for ac in (True, False) for mode in ("bilinear", "nearest")]
RESIZE_CASES = [("nearest", False), ("nearest-exact", False), ("area", False), ("linear", False), ("linear", True),
                ("bicubic", False), ("bicubic", True)]
RESIZE_SIZES = [((9, 4, 5), True), ((3, 13, 7), False)]  # up and down on each axis, both align_corners
GRIDS = [
    ("FullResolutionVoxelGrid", dict(n_features=3)),
    ("CPFactorizedVoxelGrid", dict(n_features=4, n_components=6)),
    ("VMFactorizedVoxelGrid", dict(n_features=5, n_components=6)),
    ("VMFactorizedVoxelGrid", dict(distribution_of_components=(1, 2, 3), basis_matrix=False, padding="border",
                                   align_corners=False)),
]
PLACEMENT = {"extents": np.array([2.0, 3.0, 2.5], np.float32), "translation": np.array([0.1, -0.2, 0.3], np.float32)}


def _module_args(class_type, args):
    return dict(voxel_grid_class_type=class_type, voxel_grid_args=dict(args, resolution_changes={
        0: [8, 8, 8], 2: [12, 10, 16]}), **{k: tuple(v.tolist()) for k, v in PLACEMENT.items()})


@pytest.fixture(scope="module")
def inputs():
    """Seeded inputs of the interpolator, resize and grid cases, and JAX's
    results for them, computed in one jit."""
    rng = np.random.default_rng(0)
    interp = [{name: (_edge_points(rng, len(sizes)), rng.standard_normal((1, 3, *sizes)).astype(np.float32))
               for name, sizes in INTERP_SOURCES.items()} for _ in INTERP_CASES]
    x = rng.standard_normal((1, 2, 6, 9, 5)).astype(np.float32)
    grids = [(_grid_values(rng, jvg.VoxelGridModule(**_module_args(*g)).voxel_grid),
              rng.uniform(-1.8, 1.8, (2, 30, 3)).astype(np.float32)) for g in GRIDS]

    def jrun(interp, x, grids):
        out_interp = [{name: getattr(jvg, f"interpolate_{name}")(pts, src, align_corners=ac, padding_mode=p, mode=m)
                       for name, (pts, src) in case.items()} for (p, ac, m), case in zip(INTERP_CASES, interp)]
        out_resize = [[jvg.interpolate_tensor(x, size, mode=m, align_corners=ac, antialias=aa)
                       for size, ac in RESIZE_SIZES] for m, aa in RESIZE_CASES]
        out_grids = []
        for g, (values, pts) in zip(GRIDS, grids):
            jmod = jvg.VoxelGridModule(**_module_args(*g))
            out_grids.append((jmod.apply({"params": values, "buffers": PLACEMENT}, pts),
                              jvg.apply_resolution_change(jmod, values, 2)[0]))
        return out_interp, out_resize, out_grids

    want = jax.tree_util.tree_map(np.asarray, _jit(jrun)(interp, x, grids))
    return dict(interp=interp, x=x, grids=grids, want=want)


@pytest.mark.parametrize("case", range(len(INTERP_CASES)), ids=["-".join(map(str, c)) for c in INTERP_CASES])
def test_interpolators_at_edges_and_outside(inputs, case):
    """interpolate_line / plane / volume against JAX's (one-hot weights for
    the line and plane, grid_sample for the volume) under both paddings,
    both align_corners, bilinear and nearest, on 6- to 9-long axes with
    points on the boundary and outside it; through the re-exports of
    implicit_function.utils."""
    padding, ac, mode = INTERP_CASES[case]
    for name, (pts, src) in inputs["interp"][case].items():
        got = getattr(futils, f"interpolate_{name}")(_t(pts), _t(src), align_corners=ac, padding_mode=padding,
                                                     mode=mode)
        assert _err(got, inputs["want"][0][case][name]) <= TOL, name


@pytest.mark.parametrize("case", range(len(RESIZE_CASES)), ids=[f"{m}-{a}" for m, a in RESIZE_CASES])
def test_interpolate_tensor_modes(inputs, case):
    """`interpolate_tensor` up and down on three axes, with and without
    align_corners, against JAX's resize matrices."""
    mode, antialias = RESIZE_CASES[case]
    for (size, ac), want in zip(RESIZE_SIZES, inputs["want"][1][case]):
        got = tvg.interpolate_tensor(_t(inputs["x"]), size, mode=mode, align_corners=ac, antialias=antialias)
        assert _err(got, want) <= TOL, (size, ac)


def _grid_values(rng, grid, epoch=0):
    return {k: rng.standard_normal((1, *s)).astype(np.float32) for k, s in grid.get_shapes(epoch).items()}


@pytest.mark.parametrize("case", range(len(GRIDS)), ids=[f"{c}-{i}" for i, (c, _) in enumerate(GRIDS)])
def test_grids_module_resolution_change_and_crop(inputs, case):
    """Each grid through `VoxelGridModule` at world points (placed by
    extents and translation), then `apply_resolution_change` to the next
    epoch's resolution and `crop_values` to a box and back to the grid's
    resolution, against JAX: values and placement within 1e-6."""
    module_args = _module_args(*GRIDS[case])
    values, pts = inputs["grids"][case]
    want_points, want_values = inputs["want"][2][case]
    tmod = VoxelGridModule(**module_args, device="cpu")
    load_state_dict_resized(tmod, {k: _t(v) for k, v in {**values, **PLACEMENT}.items()})
    assert _err(tmod(_t(pts)), want_points) <= TOL
    assert tvg.VoxelGridModule.get_output_dim(module_args) == jvg.VoxelGridModule.get_output_dim(module_args)

    tnew, changed = tvg.apply_resolution_change(tmod, {k: _t(v) for k, v in values.items()}, 2)
    assert changed and sorted(want_values) == sorted(tnew)
    for k in want_values:
        assert _err(tnew[k], want_values[k]) <= TOL, k
    same, changed = tvg.apply_resolution_change(tmod, tnew, 3)
    assert not changed and same is tnew
    lo, hi = np.array([-0.5, -0.9, -0.2], np.float32), np.array([0.7, 0.4, 1.1], np.float32)
    jv, jb = jvg.crop_values(jvg.VoxelGridModule(**module_args), want_values, PLACEMENT, lo, hi)
    tv, tb = tvg.crop_values(tmod, tnew, {k: _t(v) for k, v in PLACEMENT.items()}, _t(lo), _t(hi))
    for k in jv:
        assert tv[k].shape == jv[k].shape and _err(tv[k], jv[k]) <= TOL, k
    for k in PLACEMENT:
        assert torch.equal(tb[k], _t(jb[k])), k


def _bundle(seed, B=2, R=N_RAYS, n_pts=S):
    """A ray bundle into the 3-wide box: origins on a sphere of radius 2.5,
    directions at the centre with a spread, depths 0.8-4.2 (some points
    outside the grid)."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((B, R, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.uniform(-0.6, 0.6, o.shape)
    lengths = np.sort(rng.uniform(0.8, 4.2, (B, R, n_pts)), axis=-1)
    xys = rng.uniform(-1, 1, (B, R, 2))
    arrays = [a.astype(np.float32) for a in (o, d, lengths, xys)]
    return JBundle(*map(jnp.asarray, arrays)), ImplicitronRayBundle(*map(_t, arrays))


LEGACY = dict(grid_type="cp", resolution=(10, 9, 8), n_components=6, n_features_color=5, n_hidden_color=16,
              scene_extent=1.5)
# TensoRF's layout at test size: VM density without a basis and a softplus(x - 10) decoder, VM colour through a
# basis, harmonics on both colour inputs, a 2-layer sigmoid MLP; 8^3 growing to 12^3 at epoch 2, the scaffold at
# epoch 1, the crop at epoch 2
FULL = dict(
    voxel_grid_density_args=dict(voxel_grid_class_type="VMFactorizedVoxelGrid", extents=EXTENTS,
                                 voxel_grid_args=dict(n_components=6, basis_matrix=False,
                                                      resolution_changes={0: [8, 8, 8], 2: [12, 12, 12]})),
    voxel_grid_color_args=dict(voxel_grid_class_type="VMFactorizedVoxelGrid", extents=EXTENTS,
                               voxel_grid_args=dict(n_components=6, n_features=4,
                                                    resolution_changes={0: [8, 8, 8], 2: [12, 12, 12]})),
    decoder_density_args=dict(shift=-10.0, operation="softplus"), density_activation="identity",
    harmonic_embedder_xyz_color_args=dict(n_harmonic_functions=2, append_input=True),
    decoder_color_args=dict(network_args=dict(n_layers=2, hidden_dim=16, output_dim=3, input_skips=(),
                                              last_activation="sigmoid")),
    scaffold_calculating_epochs=(1,), scaffold_resolution=(8, 8, 8), volume_cropping_epochs=(2,),
)


def _fill(shapes, rng, placement):
    """flax variables of `shapes` (jax.eval_shape of init): params N(0,
    0.5); buffers: the grids' extents and translation, the scaffold ones,
    scaffold_ready 0."""
    def param(path, s):
        return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)

    def buffer(path, s):
        name = path[-1].key
        if name in placement:
            return np.array(placement[name], np.float32)
        return np.ones(s.shape, np.float32) if name == "voxel_grid" else np.zeros(s.shape, np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, shapes["params"]),
            "buffers": jax.tree_util.tree_map_with_path(buffer, shapes["buffers"])}


def _box_density(params, lo=2, hi=5):
    """VM density grid values that are positive inside the voxel box
    [lo, hi]^3 of an 8^3 grid and 0 outside it (density softplus(-10)
    there, under the scaffold's threshold), so the scaffold and its crop
    find that box."""
    rng = np.random.default_rng(3)
    for name, v in params.items():
        if name.startswith(("vector", "matrix")):
            inside = rng.uniform(1.0, 2.0, v.shape).astype(np.float32)
            mask = np.zeros(v.shape, bool)
            mask[(slice(None), slice(None)) + (slice(lo, hi + 1),) * (v.ndim - 2)] = True
            params[name] = np.where(mask, inside, 0.0).astype(np.float32)


def _function_variables(cfg, seed, placement, box=False):
    fn = JVoxelFn(**cfg)
    jb, _ = _bundle(0)
    shapes = jax.eval_shape(lambda: fn.init(jax.random.PRNGKey(0), jb))
    variables = _fill(shapes, np.random.default_rng(seed), placement)
    if box:
        _box_density(variables["params"]["voxel_grid_density"])
    return fn, variables


def _port_function(cfg, variables):
    fn = VoxelGridImplicitFunction(**cfg, device="cpu")
    state = generic_model_state_dict_from_flax({k: {"implicit_function_0": v} for k, v in variables.items()},
                                               device="cpu")
    fn.load_state_dict({k[len("implicit_function_0."):]: v for k, v in state.items()}, strict=True)
    return fn


def test_voxel_grid_implicit_function():
    """Densities and colours at a bundle's points against the JAX module's,
    on the legacy surface (CP grids, the 1 - exp(-softplus) density, the
    legacy colour head) and on the full one (TensoRF's layout; its
    scaffold, crop and resolution change are held in the GenericModel test
    below), and the epoch schedules.  Within 4e-6 of the values'
    magnitude: the density's raw feature sums 6 products up to ~15, whose
    ulps are 1e-6 (measured 1.2e-6)."""
    cases = [(LEGACY, {"extents": (3.0,) * 3, "translation": (0.0,) * 3}, False),
             (FULL, {"extents": EXTENTS, "translation": (0.0,) * 3}, True)]
    made = [_function_variables(cfg, 4, placement, box) for cfg, placement, box in cases]
    jb, tb = _bundle(5)
    want = jax.tree_util.tree_map(np.asarray, _jit(lambda vs, b: [jfn.apply(v, b) for (jfn, _), v in zip(made, vs)])(
        [v for _, v in made], jb))
    for (cfg, _, _), (jfn, variables), w in zip(cases, made, want):
        fn = _port_function(cfg, variables)
        assert fn.subscribe_to_epochs() == jfn.subscribe_to_epochs()
        for g, x in zip(fn(ray_bundle=tb), w):
            assert _err(g, x) <= 4e-6


def _jax_epoch_states(jm, variables, epochs):
    out = []
    for e in epochs:
        variables, changed = jm.apply_epoch_callbacks(variables, e)
        out.append((variables, changed))
    return out


MODEL = dict(
    render_image_width=W, render_image_height=H, num_passes=1, chunk_size_grid=24,
    raysampler_args=dict(scene_extent=3.0, n_pts_per_ray_training=S, n_pts_per_ray_evaluation=S,
                         n_rays_per_image_sampled_from_mask=N_RAYS),
    implicit_function_class_type="VoxelGridImplicitFunction", implicit_function_args=FULL,
)


def _draws(key, B):
    """The JAX GenericModel's draws from `key` in training (call inside a
    jit): key -> (rays, render); rays -> (select, stratify)."""
    k_rays, _ = jax.random.split(key)
    key_sel, key_strat = jax.random.split(k_rays)
    return {"u_jiggle": jax.random.uniform(key_strat, (B, N_RAYS, S)),
            "select": jax.vmap(lambda k: jax.random.gumbel(k, (N_RAYS, H * W), jnp.float32))(
                jax.random.split(key_sel, B))}


def test_generic_model_epochs_objective_and_gradients():
    """GenericModel around TensoRF's layout: `apply_epoch_callbacks` at
    epochs 1 (the scaffold) and 2 (12^3, the crop) equal JAX's (every
    tensor within 1e-6; both report the changes); then at the cropped,
    scaffolded state, with JAX's draws, the training objective within 1e-5
    and every gradient within 1e-5 of its largest entry (grid gradients
    are sums of corner weights in another order), and the evaluation
    render in chunks equal to the unchunked one."""
    jc, tc = _cameras()
    image, fg, _ = _frames()
    jm = JGenericModel(**MODEL)
    _, fn_variables = _function_variables(FULL, 6, {"extents": EXTENTS, "translation": (0.0,) * 3}, box=True)
    variables = {k: {"implicit_function_0": v} for k, v in fn_variables.items()}
    key = jax.random.PRNGKey(12)
    batch = dict(image_rgb=jnp.asarray(image), camera=jc, fg_probability=jnp.asarray(fg))
    states = _jax_epoch_states(jm, variables, (1, 2))
    final = states[-1][0]

    def jrun(v):
        def jloss(params):
            preds = jm.apply({**v, "params": params}, **batch, evaluation_mode=JMode.TRAINING, key=key)
            return preds["objective"], preds["loss_rgb_mse"]

        return jax.value_and_grad(jloss, has_aux=True)(v["params"]), _draws(key, 2)

    ((objective, mse), grads), draws = jax.tree_util.tree_map(np.asarray, _jit(jrun)(final))

    model = GenericModel(**MODEL, device="cpu")
    model.load_state_dict(generic_model_state_dict_from_flax(variables, device="cpu"), strict=True)
    assert model.epoch_subscriptions() == (1, 2)
    for epoch, (want_state, want_changed) in zip((1, 2), states):
        state, changed = model.apply_epoch_callbacks(model.state_dict(), epoch)
        assert changed == want_changed
        want = generic_model_state_dict_from_flax(want_state, device="cpu")
        assert sorted(state) == sorted(want)
        for k in want:
            # the crop box's corners are jnp.linspace points, which XLA computes with fused multiply-adds: the
            # placement moves by an ulp of the extents (translation 0 against 1.2e-7)
            assert state[k].shape == want[k].shape, (epoch, k)
            assert float((state[k] - want[k]).abs().max()) <= TOL * max(float(want[k].abs().max()), 1.0), (epoch, k)
        load_state_dict_resized(model, state)
    assert model.implicit_function_0.voxel_grid_color.matrix_components_xy.shape == (1, 2, 12, 12)

    preds = model(image_rgb=_t(image), camera=tc, fg_probability=_t(fg), evaluation_mode=EvaluationMode.TRAINING,
                  draws={k: _t(v) for k, v in draws.items()})
    preds["objective"].backward()
    assert _err(preds["objective"], objective) <= 1e-5 and _err(preds["loss_rgb_mse"], mse) <= 1e-5
    ref = generic_model_state_dict_from_flax({"params": grads}, device="cpu")
    assert sorted(ref) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        assert _err(p.grad, ref[name]) <= 1e-5, name
    batch_t = dict(image_rgb=_t(image), camera=tc, fg_probability=_t(fg))
    with torch.no_grad():
        chunked = model(**batch_t, evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
        model.chunk_size_grid = 0
        whole = model(**batch_t, evaluation_mode=EvaluationMode.EVALUATION)["images_render"]
    assert torch.equal(chunked, whole)
