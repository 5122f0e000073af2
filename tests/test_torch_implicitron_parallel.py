"""`make_sharded_generic_train_step` (pytorch3d_tpu_torch/parallel/
implicitron.py) against one process: 2 gloo ranks spawned on the CPU
(`tests/torch_parallel_ranks.Ranks`) take 3 Adam steps of a tiny
GenericModel, each rank drawing its own rays from `rank_seed(seed, rank)`;
one process takes the same steps by summing each rank's gradient, halving
it, and stepping.  The losses and the final weights agree within 1e-6 of
their magnitude (measured: the losses equal, the weights within 2e-9, the
ranks running torch on one thread, this process on two).  A (1, 1) mesh
without a process group is the plain step with rank 0's draws, and it
takes the JAX package's sharded step on a one-device mesh: the same loss
and the same weights after each Adam step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from pytorch3d_tpu.implicitron.models import GenericModel as JGenericModel
from pytorch3d_tpu.parallel.implicitron import make_sharded_generic_train_step as jax_sharded_step
from pytorch3d_tpu_torch.convert import fov_perspective_cameras_from_numpy, generic_model_state_dict_from_flax
from pytorch3d_tpu_torch.implicitron.models import GenericModel
from pytorch3d_tpu_torch.parallel import get_device_mesh, make_sharded_generic_train_step, rank_seed
from test_torch_implicitron_models import FAST_XLA, MODEL, _cameras, _draws_t, _frames, _model_draws, _port_model, _t, _variables
from torch_parallel_ranks import Ranks, generic_model_steps

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

H = W = 8
CONFIG = dict(
    render_image_width=W, render_image_height=H,
    implicit_function_args=dict(n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32,
                                n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,)),
    raysampler_args=dict(scene_extent=2.0, n_pts_per_ray_training=8, n_rays_per_image_sampled_from_mask=16),
    renderer_args=dict(n_pts_per_ray_fine_training=8),
)


def _spec():
    rng = np.random.default_rng(0)
    R = np.stack([np.eye(3), np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])]).astype(np.float32)
    T = np.array([[0.0, 0.0, 2.5], [0.1, -0.05, 2.5]], np.float32)
    ones = np.ones(2, np.float32)
    yy, xx = np.mgrid[:H, :W]
    fg = (np.exp(-((yy - 3.5) ** 2 + (xx - 3.5) ** 2) / 6.0)[None, ..., None] * np.ones((2, 1, 1, 1)))
    return dict(config=CONFIG, seed=7, lr=5e-4, steps=3, cameras=(R, T, 0.5 * ones, 5.0 * ones, ones, 50.0 * ones),
                image_rgb=rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32), fg_probability=fg.astype(np.float32))


def _single_process(spec, world):
    """The steps in one process: each rank's gradient (its own draws)
    summed, divided by the world size, one Adam step."""
    model = GenericModel(**spec["config"], device="cpu", generator=torch.Generator().manual_seed(spec["seed"]))
    opt = torch.optim.Adam(model.parameters(), lr=spec["lr"])
    batch = {"camera": fov_perspective_cameras_from_numpy(*spec["cameras"], device="cpu"),
             **{k: torch.tensor(spec[k]) for k in ("image_rgb", "fg_probability")}}
    losses = []
    for s in range(spec["steps"]):
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for r in range(world):
            objective = model(**batch, generator=torch.Generator().manual_seed(rank_seed(s, r)))["objective"]
            objective.backward()
            total = total + objective.detach()
        for p in model.parameters():
            p.grad.div_(world)
        opt.step()
        losses.append(float(total / world))
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}, model, batch


@pytest.fixture(scope="module")
def two_ranks():
    spec = _spec()
    ranks = Ranks(generic_model_steps, 2, "gloo", (spec,))
    want = _single_process(spec, 2)
    return ranks.results(), want


def test_two_ranks_match_one_process(two_ranks):
    results, (losses, state, _, _) = two_ranks
    for got_losses, got_state in results:
        assert np.allclose(got_losses, losses, rtol=1e-6, atol=0), (got_losses, losses)
        for k, v in state.items():
            assert np.abs(got_state[k] - v).max() <= 1e-6 * max(np.abs(v).max(), 1e-30), k
    assert np.array_equal(results[0][1]["implicit_function_0.xyz_encoder.layer0.kernel"],
                          results[1][1]["implicit_function_0.xyz_encoder.layer0.kernel"])
    assert losses[-1] < losses[0] * 1.5 and np.isfinite(losses).all()


def test_mesh_of_one_rank_is_the_plain_step():
    spec = dict(_spec(), steps=2)
    losses, state, _, _ = _single_process(spec, 1)
    model = GenericModel(**spec["config"], device="cpu", generator=torch.Generator().manual_seed(spec["seed"]))
    step = make_sharded_generic_train_step(model, torch.optim.Adam(model.parameters(), lr=spec["lr"]),
                                           get_device_mesh((1, 1)))
    batch = {"camera": fov_perspective_cameras_from_numpy(*spec["cameras"], device="cpu"),
             **{k: torch.tensor(spec[k]) for k in ("image_rgb", "fg_probability")}}
    got = [float(step(batch, s)) for s in range(2)]
    assert got == losses
    assert all(torch.equal(v, torch.tensor(state[k])) for k, v in model.state_dict().items())


def test_one_device_mesh_matches_the_jax_sharded_step():
    """The JAX package's `make_sharded_generic_train_step` on a one-device
    mesh (optax.adam) against the port's on a (1, 1) mesh (torch Adam), at
    lr 5e-4 from the same weights, for two steps: the port gets each JAX
    step's draws, those of fold_in(key, 0), through
    `static_model_kwargs={"draws": ...}`.  The losses within 1e-5 of their
    magnitude (measured: 0 and 8.6e-8), the weights after each Adam step
    within 1e-5 of each tensor's largest |value| (measured: 2.3e-7 and
    4.5e-7).  A third step moves one trunk bias 0.18 lr from JAX's: Adam
    divides that entry's near-zero gradient by the root of its second
    moment, which turns the fine pass's gradient rounding (held to 2e-3 in
    test_torch_implicitron_models.py) into a step of the order of lr."""
    lr = 5e-4
    jc, tc = _cameras()
    image, fg, _ = _frames()
    variables = _variables(9)
    opt = optax.adam(lr)
    jstep = jax_sharded_step(JGenericModel(**MODEL), opt, Mesh(np.array(jax.devices()[:1]), ("rays",)))
    batch = dict(image_rgb=jnp.asarray(image), camera=jc, fg_probability=jnp.asarray(fg))
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    state = opt.init(params)
    keys = [jax.random.PRNGKey(20 + s) for s in range(2)]
    run = jstep.lower(params, state, batch, keys[0]).compile(compiler_options=FAST_XLA)
    draws = jax.jit(lambda ks: [_model_draws(jax.random.fold_in(k, 0), 2) for k in ks])(keys)

    model = _port_model(variables, **MODEL)
    torch_opt = torch.optim.Adam(model.parameters(), lr=lr)
    batch_t = dict(image_rgb=_t(image), camera=tc, fg_probability=_t(fg))
    for s, key in enumerate(keys):
        params, state, want = run(params, state, batch, key)
        step = make_sharded_generic_train_step(model, torch_opt, get_device_mesh((1, 1)),
                                               static_model_kwargs={"draws": _draws_t(draws[s])})
        loss = float(step(batch_t, s))
        assert abs(loss - float(want)) <= 1e-5 * abs(float(want)), (s, loss, float(want))
        ref = generic_model_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
        assert sorted(ref) == sorted(model.state_dict())
        for name, p in model.state_dict().items():
            assert float((p - ref[name]).abs().max()) <= 1e-5 * float(ref[name].abs().max()), (s, name)
