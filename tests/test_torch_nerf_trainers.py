"""The NeRF trainers and the Implicitron tools they use: the port against the
JAX package on the CPU, on the same seeded numpy inputs or the same
converted weights.

Tolerances:
- circle fitting, the evaluation trajectory: within 1e-5 (float32 SVD and
  least squares from two libraries);
- Stats: averages equal; a stats file of either package loads in the other;
- model_io: the same names; a save/load round trip returns equal tensors;
- the video writer: the same GIF bytes;
- the rendered-sphere dataset: face ids equal, RGB within 1e-5 where the
  ids agree (at every pixel here; measured 1.5e-6);
- train_nerf: the loss falls; a resumed run loads the saved weights, Adam
  state and Stats bit for bit and runs only the epochs left;
- test_nerf: per-frame psnr_coarse and psnr_fine within 0.01 dB of the
  JAX render at `training=False`, the coarse image within 1e-5.
"""

import gzip
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu import renderer as jr
from pytorch3d_tpu.implicitron.dataset import rendered_mesh_dataset_map_provider as jprovider
from pytorch3d_tpu.implicitron.tools import circle_fitting as jcircle
from pytorch3d_tpu.implicitron.tools import model_io as jmodel_io
from pytorch3d_tpu.implicitron.tools.eval_video_trajectory import generate_eval_video_cameras as j_trajectory
from pytorch3d_tpu.implicitron.tools.stats import Stats as JStats
from pytorch3d_tpu.implicitron.tools.video_writer import VideoWriter as JVideoWriter
from pytorch3d_tpu.models import RadianceFieldRenderer as JRenderer
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import renderer as tr
from pytorch3d_tpu_torch.convert import nerf_state_dict_from_flax
from pytorch3d_tpu_torch.implicitron.dataset import RenderedMeshDatasetMapProvider
from pytorch3d_tpu_torch.implicitron.tools import circle_fitting, model_io
from pytorch3d_tpu_torch.implicitron.tools.eval_video_trajectory import generate_eval_video_cameras
from pytorch3d_tpu_torch.implicitron.tools.stats import Stats
from pytorch3d_tpu_torch.implicitron.tools.video_writer import VideoWriter
from pytorch3d_tpu_torch.projects.nerf import test_nerf, train_nerf
from pytorch3d_tpu_torch.projects.nerf.dataset import get_nerf_datasets
from pytorch3d_tpu_torch.utils import ico_sphere

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

TINY = ["--image_size", "16", "--hidden", "32", "--layers", "2", "--n_rays", "64", "--n_pts", "8", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _two_threads():
    """Beside other test processes on the machine's cores, torch's full
    thread pool makes these small tensors' ops tens of times slower (the
    train_nerf test took 382 s in a 6-worker run against 6 s alone); two
    threads keep them near their time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _ring(n, seed):
    """n noisy points on a tilted circle of radius 2.7 about (0.1, 0.2, -0.1)."""
    rng = np.random.default_rng(seed)
    a = np.linspace(0, 2 * np.pi, n, endpoint=False) + 0.05 * rng.standard_normal(n)
    pts = np.stack([2.7 * np.cos(a), 0.4 + 0.05 * rng.standard_normal(n), 2.7 * np.sin(a)], -1)
    tilt = np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)], [0, np.sin(0.3), np.cos(0.3)]])
    return (pts @ tilt + [0.1, 0.2, -0.1]).astype(np.float32)


def _jax_circles(pts):
    """JAX's fits of `pts` in one jitted call: the 3D circle without and
    with 7 generated points, the 2D circle of the (x, z) coordinates with
    5, and the rotation to the best-fit xy plane."""
    up = jnp.asarray([0.0, 1.0, 0.0])
    fields3 = ("center", "radius", "normal", "generated_points")
    fits = (jcircle.fit_circle_in_3d(pts, up=up), jcircle.fit_circle_in_3d(pts, n_points=7, up=up))
    c2 = jcircle.fit_circle_in_2d(pts[:, ::2], n_points=5)
    return ([{k: getattr(c, k) for k in fields3} for c in fits],
            {k: getattr(c2, k) for k in ("center", "radius", "generated_points")},
            jcircle.get_rotation_to_best_fit_xy(pts))


def test_circle_fitting_matches_jax():
    pts = _ring(12, 0)
    j3, j2, jrot = jax.jit(_jax_circles)(jnp.asarray(pts))
    for n_points, j in zip((0, 7), j3):
        t = circle_fitting.fit_circle_in_3d(torch.tensor(pts), n_points=n_points, up=torch.tensor([0.0, 1.0, 0.0]))
        for name in ("center", "radius", "normal") + (("generated_points",) if n_points else ()):
            np.testing.assert_allclose(_np(getattr(t, name)), np.asarray(j[name]), rtol=0, atol=1e-5)
    t2 = circle_fitting.fit_circle_in_2d(torch.tensor(pts[:, ::2]), n_points=5)
    for name in ("center", "radius", "generated_points"):
        np.testing.assert_allclose(_np(getattr(t2, name)), np.asarray(j2[name]), rtol=0, atol=1e-5)
    # Eigenvectors are defined up to sign: the rotation's columns are held
    # up to theirs, and both are right-handed.
    jrot = np.asarray(jrot)
    trot = _np(circle_fitting.get_rotation_to_best_fit_xy(torch.tensor(pts)))
    np.testing.assert_allclose(np.abs(trot), np.abs(jrot), rtol=0, atol=1e-5)
    assert np.linalg.det(trot) == pytest.approx(1.0, abs=1e-5)


def test_eval_trajectory_matches_jax():
    # Training cameras looking at the origin from the ring's points.
    eye = _ring(10, 1)
    R, T = jr.look_at_view_transform(eye=jnp.asarray(eye))
    jcams = jr.FoVPerspectiveCameras.create(R=R, T=T)
    tcams = tr.FoVPerspectiveCameras.create(R=torch.tensor(np.asarray(R)), T=torch.tensor(np.asarray(T)), device="cpu")
    j = jax.jit(lambda c: j_trajectory(c, n_eval_cams=9, trajectory_scale=1.2))(jcams)
    t = generate_eval_video_cameras(tcams, n_eval_cams=9, trajectory_scale=1.2)
    np.testing.assert_allclose(_np(t.R), np.asarray(j.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(t.T), np.asarray(j.T), rtol=0, atol=1e-5)


def _fill(stats, seed):
    rng = np.random.default_rng(seed)
    for _ in range(2):
        stats.new_epoch()
        for _ in range(5):
            stats.update({"loss": float(rng.random()), "psnr": float(10 * rng.random())}, stat_set="train")
        stats.update({"loss": float(rng.random())}, stat_set="val")
    return stats


def test_stats_match_jax_and_load_across(tmp_path):
    t = _fill(Stats(log_vars=["loss", "psnr"]), 2)
    j = _fill(JStats(log_vars=["loss", "psnr"]), 2)
    for ss in ("train", "val"):
        for k, m in j.stats[ss].items():
            assert t.stats[ss][k].avg == m.avg
            assert t.stats[ss][k].get_epoch_averages() == m.get_epoch_averages()
    j.save(str(tmp_path / "j.jgz"))
    t.save(str(tmp_path / "t.jgz"))
    with gzip.open(tmp_path / "j.jgz", "rt") as fj, gzip.open(tmp_path / "t.jgz", "rt") as ft:
        assert json.load(fj) == json.load(ft)
    assert Stats.load(str(tmp_path / "j.jgz")).state_dict() == j.state_dict()
    assert JStats.load(str(tmp_path / "t.jgz")).state_dict() == t.state_dict()


def test_model_io_names_match_jax(tmp_path):
    trees = [tmp_path / "jax", tmp_path / "port"]
    for d in trees:
        for e in (0, 3, 12):  # checkpoints as the JAX package writes them: directories
            os.makedirs(d / ("model_epoch_%08d" % e))
            (d / ("model_epoch_%08d_stats.jgz" % e)).write_text("{}")
        (d / "model_epoch_12_tmp").write_text("")
    for fn in ("find_last_checkpoint",):
        got = getattr(model_io, fn)(str(trees[1]), all_checkpoints=True)
        want = getattr(jmodel_io, fn)(str(trees[0]), all_checkpoints=True)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    last_t, last_j = model_io.find_last_checkpoint(str(trees[1])), jmodel_io.find_last_checkpoint(str(trees[0]))
    assert os.path.basename(last_t) == os.path.basename(last_j)
    assert model_io.parse_epoch_from_model_path(last_t) == jmodel_io.parse_epoch_from_model_path(last_j) == 12
    for name in ("get_model_path", "get_optimizer_path", "get_stats_path"):
        assert getattr(model_io, name)(last_t + ".pth") == getattr(jmodel_io, name)(last_t + ".pth")
    assert model_io.get_checkpoint("x", 7) == jmodel_io.get_checkpoint("x", 7)
    model_io.purge_epoch(str(trees[1]), 3)
    jmodel_io.purge_epoch(str(trees[0]), 3)
    assert sorted(os.listdir(trees[1])) == sorted(os.listdir(trees[0]))
    assert model_io.find_last_checkpoint(str(tmp_path / "empty")) is None


def test_model_io_round_trip(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(), torch.nn.Linear(4, 2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(torch.randn(5, 3)).sum().backward()
    opt.step()
    stats = _fill(Stats(log_vars=["loss"]), 3)
    path = model_io.safe_save_model(model.state_dict(), opt.state_dict(), stats, str(tmp_path), 4)
    assert path == model_io.get_checkpoint(str(tmp_path), 4) and not os.path.exists(path + "_tmp")
    m, o, s = model_io.load_model(path)
    assert all(torch.equal(m[k], v) for k, v in model.state_dict().items())
    saved = opt.state_dict()["state"]
    assert all(torch.equal(o["state"][i][k], v) for i in saved for k, v in saved[i].items())
    assert s.state_dict() == stats.state_dict()


def test_video_writer_matches_jax_and_leaves_no_temp_dir(tmp_path, monkeypatch):
    """The GIF route writes the same file as JAX's writer, from float
    tensors and uint8 arrays alike, and makes nothing in the temp dir."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    frames = list(np.random.default_rng(9).random((3, 12, 16, 3)).astype(np.float32))
    frames.append((frames[0] * 255).astype(np.uint8))
    writer = VideoWriter(fps=4, out_path=str(tmp_path / "port.gif"))
    for f in frames:
        writer.write_frame(torch.tensor(f) if f.dtype == np.float32 else f)
    port_gif = writer.get_video()
    assert list(tmp.iterdir()) == []
    jwriter = JVideoWriter(fps=4, out_path=str(tmp_path / "jax.gif"))
    for f in frames:
        jwriter.write_frame(f)
    assert open(port_gif, "rb").read() == open(jwriter.get_video(), "rb").read()


def test_rendered_sphere_dataset_matches_jax(monkeypatch):
    # JAX's provider, jitted (eager, it takes ~12 s), with its sphere built
    # outside the trace (ico_sphere builds on the host).
    sphere = j_ico_sphere(3)
    monkeypatch.setattr(jprovider, "ico_sphere", lambda level: sphere)
    jframes = jax.jit(
        lambda: [(f.image_rgb, f.camera.R, f.camera.T) for f in jprovider.RenderedMeshDatasetMapProvider(
            num_views=4, resolution=32)._build()]
    )()
    tframes = RenderedMeshDatasetMapProvider(num_views=4, resolution=32, device="cpu")._build()
    settings = dict(image_size=32, faces_per_pixel=1)
    jcams = jr.FoVPerspectiveCameras.create(R=jnp.concatenate([f[1] for f in jframes]),
                                            T=jnp.concatenate([f[2] for f in jframes]))
    jids = jax.jit(lambda c: jr.MeshRasterizer(c, jr.RasterizationSettings(**settings))(
        sphere.extend(4)).pix_to_face)(jcams)
    tcams = tr.join_cameras_as_batch([f.camera for f in tframes])
    tids = tr.MeshRasterizer(tcams, tr.RasterizationSettings(**settings))(ico_sphere(3, device="cpu").extend(4)).pix_to_face
    same = _np(tids) == np.asarray(jids)
    assert same.all() and (np.asarray(jids) >= 0).mean() > 0.2
    jimg = np.concatenate([np.asarray(f[0]) for f in jframes])
    timg = np.concatenate([_np(f.image_rgb) for f in tframes])
    assert timg.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(timg[same[..., 0]], jimg[same[..., 0]], rtol=0, atol=1e-5)
    assert [f.frame_number for f in tframes] == list(range(4))
    with pytest.raises(FileNotFoundError):  # data_file loads the mesh (a missing file raises, as in JAX)
        RenderedMeshDatasetMapProvider(data_file="no_such_mesh.obj", device="cpu").get_dataset_map()


def test_train_nerf_loss_falls_and_resumes_exactly(tmp_path):
    args = TINY + ["--exp_dir", str(tmp_path)]
    run = train_nerf.main(args + ["--epochs", "2"])
    losses = run.stats.stats["train"]["loss"].get_epoch_averages()
    assert run.start_epoch == 0 and len(losses) == 2 and losses[1] < losses[0]
    assert [os.path.basename(p) for p in model_io.find_last_checkpoint(str(tmp_path), all_checkpoints=True)] == [
        "model_epoch_00000001"]

    # A run with no epoch left returns what it loaded: the saved state, to the bit.
    saved_model, saved_opt, saved_stats = model_io.load_model(model_io.get_checkpoint(str(tmp_path), 1))
    loaded = train_nerf.main(args + ["--epochs", "2"])
    assert loaded.start_epoch == 2 and loaded.val_psnr == []
    assert all(torch.equal(v, saved_model[k]) for k, v in loaded.model.state_dict().items())
    assert all(torch.equal(v, run.model.state_dict()[k]) for k, v in loaded.model.state_dict().items())
    for i, state in run.optimizer.state_dict()["state"].items():
        for k, v in state.items():
            assert torch.equal(loaded.optimizer.state_dict()["state"][i][k], v)
            assert torch.equal(saved_opt["state"][i][k], v)
    assert loaded.stats.state_dict() == saved_stats.state_dict() == run.stats.state_dict()

    # --epochs 3 resumes at epoch 2 and runs it alone.
    more = train_nerf.main(args + ["--epochs", "3"])
    assert more.start_epoch == 2 and len(more.val_psnr) == 1
    history = more.stats.state_dict()["histories"]["train"]["loss"]
    assert len(history) == 3 and history[:2] == saved_stats.state_dict()["histories"]["train"]["loss"]


def test_test_nerf_evaluation_matches_jax(tmp_path):
    args = test_nerf.parser().parse_args(TINY)
    config = dict(
        image_width=16, image_height=16, n_pts_per_ray=8, n_pts_per_ray_fine=8, n_rays_per_image=64, min_depth=0.5,
        max_depth=6.0, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, n_layers_xyz=2, append_xyz=(1,),
    )
    _, _, test = get_nerf_datasets("rendered_sphere", (16, 16), device="cpu")
    frames = test[:2]
    images = [_np(f.image) for f in frames]
    Rs, Ts = [_np(f.camera.R) for f in frames], [_np(f.camera.T) for f in frames]
    jm = JRenderer(**config)
    # The same cameras (R, T and the defaults: fov 60, znear 1, zfar 100) on both sides.
    jcam = [jr.FoVPerspectiveCameras.create(R=jnp.asarray(R), T=jnp.asarray(T)) for R, T in zip(Rs, Ts)]
    params = jax.jit(lambda c, im: jm.init(jax.random.PRNGKey(1), c, image=im, key=jax.random.PRNGKey(0)))(
        jcam[0], jnp.asarray(images[0]))
    render = jax.jit(lambda p, c, im: jm.apply(p, c, image=im, training=False, key=jax.random.PRNGKey(3)))

    model = test_nerf.build_model(args, torch.device("cpu"))
    state = nerf_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    model.load_state_dict(state)
    stats = test_nerf.evaluate(model, frames)
    for i, (c, im) in enumerate(zip(jcam, images)):
        jout, jmetrics = render(params, c, jnp.asarray(im))
        for k in ("psnr_coarse", "psnr_fine"):
            assert abs(stats.stats["test"][k].history[0][i] - float(jmetrics[k])) <= 0.01, (k, i)
        tout, _ = model(frames[i].camera, image=frames[i].image, training=False)
        np.testing.assert_allclose(_np(tout["rgb_coarse"]), np.asarray(jout["rgb_coarse"]), rtol=0, atol=1e-5)

    # main's evaluation mode on a checkpoint of the same weights.
    model_io.safe_save_model(state, None, None, str(tmp_path), 0)
    averages = test_nerf.main(TINY + ["--exp_dir", str(tmp_path), "--max_frames", "2"])
    assert averages["psnr_fine"] == pytest.approx(stats.stats["test"]["psnr_fine"].avg, abs=1e-6)
    assert set(averages) >= set(test_nerf.EVAL_VARS)
