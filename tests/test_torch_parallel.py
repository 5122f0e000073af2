"""The port's parallel package against the JAX package's, on the CPU.

JAX runs on tests/conftest.py's 8-device virtual CPU mesh; the port runs in
gloo process groups of 2 and 4 ranks spawned on the CPU
(`tests/torch_parallel_ranks.Ranks`, a free localhost port each, both
groups running while this process computes JAX's results).
JAX is computed once in this process and handed to the ranks as numpy; the
ranks run `tests/torch_parallel_ranks.py`, which imports no JAX.

- `get_device_mesh` shapes and its error, in one process and in the ranks;
- `local_shard_indices` and `PerProcessLoader` against JAX's with explicit
  process indices and counts;
- `rasterize_fragments_shard_map` on 2 and 4 ranks against JAX's on the
  8-device mesh (tests/test_parallel.py's TestShardMapRaster sizes), the
  same on every rank: ids equal; values within 1e-6 of the eager oracle
  that JAX's eager 8-device result equals bit for bit, and within 1e-4 of
  the jitted 8-device result (XLA's fusion moves the bits at slivers);
- `sharded_silhouette_loss_and_grad` the same way (loss rtol 1e-5,
  gradient atol 1e-6, as tests/test_parallel.py holds JAX's 8-device
  result to its 1-device one);
- one sharded NeRF step on a (2, 2) mesh of 4 ranks against JAX's
  `make_nerf_train_step(mesh=get_device_mesh((2, 4)))` at
  tests/test_parallel.py's small model, on the converted weights and JAX's
  draws (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, as that test
  holds JAX's sharded step to its single-device one), with every rank's
  parameters equal after the step.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import pytorch3d_tpu.parallel as jpar
from pytorch3d_tpu.models import RadianceFieldRenderer as JRenderer
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JCameras
from pytorch3d_tpu.renderer import MeshRasterizer as JRasterizer
from pytorch3d_tpu.renderer import RasterizationSettings as JSettings
from pytorch3d_tpu.renderer import look_at_view_transform as j_look_at
from pytorch3d_tpu.renderer.mesh.rasterize_meshes import interpolate_fragments as j_interpolate_fragments
from pytorch3d_tpu.renderer.mesh.rasterize_meshes import rasterize_topk_xla
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import parallel as tpar
from pytorch3d_tpu_torch.convert import nerf_state_dict_from_flax
from torch_parallel_ranks import Ranks, raster_and_nerf

SIZE = (64, 64)
NERF = dict(
    image_width=16, image_height=16, n_pts_per_ray=8, n_pts_per_ray_fine=8, n_rays_per_image=64,
    min_depth=0.5, max_depth=4.0, n_hidden_neurons_xyz=16, n_hidden_neurons_dir=8, n_layers_xyz=2,
    append_xyz=(1,),
)
LR = 1e-3


def _raster_inputs():
    """ico_sphere(2) at 64^2 in NDC (TestShardMapRaster's faces)."""
    R, T = j_look_at(dist=2.7, elev=15.0, azim=40.0)
    tm = JRasterizer(JCameras.create(R=R, T=T), JSettings(image_size=SIZE[0])).transform(j_ico_sphere(2))
    fv = tm.verts_padded()[0][tm.faces_padded()[0]]
    valid = tm.faces_padded()[0, :, 0] >= 0
    return fv, valid, {"fv": np.asarray(fv), "valid": np.asarray(valid), "size": SIZE}


def _jax_raster(fv, valid):
    """JAX's sharded results on the (1, 8) mesh, and its eager oracle."""
    mesh8 = jpar.get_device_mesh((1, 8))
    # Jitted: eager, the 8-device shard_map takes ~50 s here.  Jitted, XLA
    # fuses the fragments' arithmetic into bits up to 2.5e-5 off the eager
    # ones at sliver faces; the eager unsharded oracle, which the eager
    # 8-device result equals bit for bit (tests/test_parallel.py), costs 2 s.
    frags = jax.jit(lambda f: jpar.rasterize_fragments_shard_map(
        f, valid, SIZE, mesh8, axis="rays", blur_radius=1e-4, faces_per_pixel=4))(fv)
    idx = rasterize_topk_xla(fv, valid, SIZE, blur_radius=1e-4, faces_per_pixel=4)
    eager = [idx, *j_interpolate_fragments(fv, idx, SIZE)]
    loss, grad = jax.jit(lambda f: jpar.sharded_silhouette_loss_and_grad(f, valid, SIZE, mesh8))(fv)
    return ([np.asarray(f) for f in frags], [np.asarray(f) for f in eager]), (float(loss), np.asarray(grad))


def _nerf_inputs():
    """tests/test_parallel.py's _setup(dp=2): JAX's model, inputs and
    weights, and the port's inputs for the same step."""
    model = JRenderer(**NERF)
    R, T = j_look_at(dist=2.7, azim=jnp.linspace(0.0, 90.0, 2))
    cams = JCameras.create(R=R, T=T)
    image = jnp.broadcast_to(jnp.asarray([0.2, 0.5, 0.8]), (2, 16, 16, 3))
    params = jax.jit(lambda k: model.init(k, cams, image=image, key=jax.random.PRNGKey(0)))(jax.random.PRNGKey(1))
    state = nerf_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    key = jax.random.PRNGKey(7)
    # The renderer's training draws from `key` (nerf_renderer.py:106-145,
    # raysampling.py:367-383).
    k_rays, _, k_fine = jax.random.split(key, 3)
    key_xy, key_strat = jax.random.split(k_rays)
    draws = {
        "xy": jax.random.uniform(key_xy, (2, 64, 2), jnp.float32),
        "jiggle": jax.random.uniform(key_strat, (2, 64, 8), jnp.float32),
        "pdf": jax.random.uniform(k_fine, (2, 64, 8), jnp.float32),
    }
    ones = np.ones(2, np.float32)
    port = {
        "config": NERF, "shape": (2, 2), "lr": LR, "image": np.asarray(image),
        "state": {k: v.numpy() for k, v in state.items()},
        "cameras": (np.asarray(R), np.asarray(T), ones * 1.0, ones * 100.0, ones, ones * 60.0),
        "draws": {k: np.asarray(v) for k, v in draws.items()},
    }
    return (model, params, cams, image, key), port


def _jax_nerf(model, params, cams, image, key):
    """One JAX step on the (2, 4) mesh: its loss and new weights."""
    optimizer = optax.adam(LR)
    step = jpar.make_nerf_train_step(model, optimizer, mesh=jpar.get_device_mesh(shape=(2, 4)))
    new_params, _, metrics = step(params, optimizer.init(params), cams, image, key)
    want = nerf_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new_params), device="cpu")
    return float(metrics["loss"]), {k: v.numpy() for k, v in want.items()}


@functools.lru_cache(maxsize=None)
def _runs():
    """The 2- and 4-rank groups' results and JAX's.  Each group starts as
    soon as its inputs exist and runs while this process computes JAX's
    results, the rasterizer's in a thread beside the NeRF step's."""
    fv, valid, raster_in = _raster_inputs()
    groups = {2: Ranks(raster_and_nerf, 2, "gloo", (raster_in, None))}
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:  # XLA compiles without the GIL
            raster = pool.submit(_jax_raster, fv, valid)
            nerf_jax, nerf_in = _nerf_inputs()
            groups[4] = Ranks(raster_and_nerf, 4, "gloo", (raster_in, nerf_in))
            nerf = _jax_nerf(*nerf_jax)
            frags, silhouette = raster.result()
        ranks = {w: g.results() for w, g in groups.items()}
    finally:
        for g in groups.values():
            g.stop()
    return ranks, frags, silhouette, nerf


def test_mesh_in_one_process():
    mesh = tpar.get_device_mesh()
    assert mesh.shape == {"dp": 1, "rays": 1}
    assert (mesh.coordinate("rays"), mesh.group("rays")) == (0, None)
    with pytest.raises(ValueError):
        tpar.get_device_mesh((1, 2))


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_in_spawned_ranks(world):
    outs = _runs()[0][world]
    assert [o["mesh"] for o in outs] == [({"dp": 1, "rays": world}, 0, r) for r in range(world)]
    assert all(o["bad shape raises"] for o in outs)
    if world == 4:  # (2, 2): ranks fill the rays axis first, as a numpy reshape of the ranks
        assert [o["nerf mesh"][1:] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_local_shard_indices_match_jax():
    for n in (10, 13, 4):
        for count in (1, 3, 4):
            want = [jpar.local_shard_indices(n, process_index=i, process_count=count) for i in range(count)]
            got = [tpar.local_shard_indices(n, process_index=i, process_count=count) for i in range(count)]
            assert got == want


@pytest.mark.parametrize("shuffle_key", [None, 5])
def test_per_process_loader_matches_jax(shuffle_key):
    ds = list(range(13))
    want = list(jpar.PerProcessLoader(ds, global_batch_size=4, shuffle_key=shuffle_key))
    got = tpar.PerProcessLoader(ds, global_batch_size=4, shuffle_key=shuffle_key)
    assert len(got) == 3
    assert list(got) == want


def test_maybe_initialize_is_a_no_op_without_a_cluster(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert tpar.maybe_initialize_distributed() is False


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_raster_matches_jax(world):
    ranks, (sharded, eager), _, _ = _runs()
    for out in ranks[world]:
        got = out["frags"]
        assert np.array_equal(got[0], sharded[0])
        assert np.array_equal(got[0], eager[0])
        assert (got[0] >= 0).any()
        for g, w, e in zip(got[1:], sharded[1:], eager[1:]):
            np.testing.assert_allclose(g, e, atol=1e-6)
            np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_silhouette_matches_jax(world):
    ranks, _, (want_loss, want_grad), _ = _runs()
    outs = ranks[world]
    for out in outs:
        loss, grad = out["silhouette"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(grad, want_grad, atol=1e-6)
        assert np.array_equal(grad, outs[0]["silhouette"][1])  # one all-reduce: the same bits on every rank
    assert np.abs(want_grad).max() > 0


def test_sharded_nerf_step_matches_jax():
    ranks, _, _, (want_loss, want_params) = _runs()
    outs = ranks[4]
    for metrics, params in (o["nerf"] for o in outs):
        np.testing.assert_allclose(metrics["loss"], want_loss, rtol=1e-5)
        for name, value in params.items():
            np.testing.assert_allclose(value, want_params[name], rtol=1e-4, atol=1e-6, err_msg=name)
            assert np.array_equal(value, outs[0]["nerf"][1][name]), name
