"""The port's `MeshRasterizerOpenGL` and the entry points of kernels #2
and #3 against the JAX package.

- `MeshRasterizerOpenGL` end to end against JAX's (its CPU route): ids
  equal, zbuf within 1e-5 and bary within 1e-4 (the tolerances of
  tests/test_rasterizer_opengl.py), on a batch of meshes with packed ids,
  with FoV perspective and orthographic cameras; its errors and warnings;
  detached outputs and `dists` None.
- `rasterize_hard_plain` (the plain version of #3) against
  `rasterize_hard_pallas`, and `rasterize_topk` (the plain version of #2)
  against `rasterize_topk_pallas`, both run in interpret mode as
  tests/test_rasterizer_opengl.py:57-80 does.

Cameras with an identity rotation keep both packages' NDC vertices equal
bit for bit, so ids are compared exactly.  Inputs are seeded numpy arrays;
the port runs on the CPU.
"""

import importlib
import warnings

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer.mesh.rasterize_pallas as rmp
from pytorch3d_tpu.renderer import FoVOrthographicCameras as JFoVOrtho
from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JFoVPersp
from pytorch3d_tpu.renderer import MeshRasterizer as JRasterizer
from pytorch3d_tpu.renderer import RasterizationSettings as JSettings
from pytorch3d_tpu.renderer import look_at_view_transform as j_look_at
from pytorch3d_tpu.renderer.mesh.rasterizer import MeshRasterizerOpenGL as JOpenGL
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch.renderer import (
    FoVOrthographicCameras,
    FoVPerspectiveCameras,
    MeshRasterizer,
    MeshRasterizerOpenGL,
    OrthographicCameras,
    PerspectiveCameras,
    RasterizationSettings,
)
from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import (
    rasterize_hard_cuda,
    rasterize_hard_plain,
    rasterize_topk_cuda,
)
from pytorch3d_tpu_torch.structures import Meshes

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")

CPU = torch.device("cpu")
ZBUF_TOL, BARY_TOL = 1e-5, 1e-4


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rmp.pl, "pallas_call", patched)
    yield


def _batch():
    """ico_sphere(2) and a torus with seeded jitter on its vertices, as
    numpy lists."""
    ico, tor = j_ico_sphere(2), j_torus(0.3, 0.8, 12, 24)
    verts = [np.array(m.verts_list()[0]) for m in (ico, tor)]
    faces = [np.array(m.faces_list()[0]) for m in (ico, tor)]
    rng = np.random.RandomState(0)
    verts[1] = (verts[1] + rng.normal(0, 0.01, verts[1].shape)).astype(np.float32)
    return verts, faces


def _cams(ortho, N=2):
    T = np.asarray([[0.1, -0.05, 2.7], [-0.15, 0.1, 3.0]], np.float32)[:N]
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (N, 3, 3)).copy()
    if ortho:
        kw = dict(min_x=-1.3, max_x=1.3, min_y=-1.3, max_y=1.3)
        return JFoVOrtho.create(R=jnp.asarray(R), T=jnp.asarray(T), **kw), FoVOrthographicCameras.create(
            R=R, T=T, device=CPU, **kw)
    return JFoVPersp.create(R=jnp.asarray(R), T=jnp.asarray(T)), FoVPerspectiveCameras.create(R=R, T=T, device=CPU)


@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("size", [64, (48, 80)])
def test_matches_jax(ortho, size):
    verts, faces = _batch()
    j_cams, t_cams = _cams(ortho)
    want = JOpenGL(j_cams, JSettings(image_size=size))(JMeshes.create(verts=verts, faces=faces))
    got = MeshRasterizerOpenGL(t_cams, RasterizationSettings(image_size=size))(
        Meshes.create(verts, faces, device=CPU)
    )
    pix = got.pix_to_face.numpy()
    np.testing.assert_array_equal(pix, np.asarray(want.pix_to_face))
    hit = pix >= 0
    F = max(f.shape[0] for f in faces)
    assert hit.mean() > 0.1 and (pix[1][hit[1]] >= F).all()
    np.testing.assert_allclose(got.zbuf.numpy()[hit], np.asarray(want.zbuf)[hit], atol=ZBUF_TOL, rtol=0)
    np.testing.assert_allclose(got.bary_coords.numpy()[hit], np.asarray(want.bary_coords)[hit], atol=BARY_TOL, rtol=0)
    assert (got.zbuf.numpy()[~hit] == -1).all() and (got.bary_coords.numpy()[~hit] == -1).all()
    assert got.dists is None and want.dists is None


def test_packed_ids_offset_by_faces():
    verts, faces = _batch()
    _, cams = _cams(False)
    frags = MeshRasterizerOpenGL(cams, RasterizationSettings(image_size=48))(Meshes.create(verts, faces, device=CPU))
    F = max(f.shape[0] for f in faces)
    pix = frags.pix_to_face
    assert ((pix[0] >= 0) & (pix[0] < F) | (pix[0] == -1)).all()
    assert ((pix[1] >= F) & (pix[1] < 2 * F) | (pix[1] == -1)).all()
    assert (pix[1] >= F).any()


def test_agrees_with_mesh_rasterizer_and_has_no_gradient():
    verts, faces = _batch()
    _, cams = _cams(False)
    v = [torch.tensor(x, requires_grad=True) for x in verts]
    meshes = Meshes.create(v, [torch.tensor(f) for f in faces], device=CPU)
    rs = RasterizationSettings(image_size=64, faces_per_pixel=1, perspective_correct=True)
    frags = MeshRasterizerOpenGL(cams, rs)(meshes)
    ref = MeshRasterizer(cams, rs)(meshes)
    assert torch.equal(frags.pix_to_face, ref.pix_to_face)
    hit = frags.pix_to_face >= 0
    torch.testing.assert_close(frags.zbuf[hit], ref.zbuf[hit].detach(), atol=ZBUF_TOL, rtol=0)
    assert not frags.zbuf.requires_grad and not frags.bary_coords.requires_grad


def test_checks():
    _, cams = _cams(False, N=1)
    mesh = Meshes.create([torch.tensor(_batch()[0][0])], [torch.tensor(_batch()[1][0])], device=CPU)
    with pytest.raises(ValueError, match="Cameras must be specified"):
        MeshRasterizerOpenGL(None)(mesh)
    for cls in (PerspectiveCameras, OrthographicCameras):
        with pytest.raises(ValueError, match="OpenGL compatible"):
            MeshRasterizerOpenGL(cls.create(T=[[0.0, 0.0, 3.0]], device=CPU))(mesh)
    with pytest.raises(NotImplementedError, match="z-clipping"):
        MeshRasterizerOpenGL(cams, RasterizationSettings(z_clip_value=0.1))(mesh)
    with pytest.raises(ValueError, match="perspective-correct"):
        MeshRasterizerOpenGL(cams, RasterizationSettings(perspective_correct=False))(mesh)
    for settings, text in ((dict(faces_per_pixel=2), "one face per pixel"), (dict(cull_backfaces=True), "backfaces"),
                           (dict(cull_to_frustum=True), "frustum")):
        with pytest.warns(UserWarning, match=text):
            frags = MeshRasterizerOpenGL(cams, RasterizationSettings(image_size=32, **settings))(mesh)
        assert frags.pix_to_face.shape == (1, 32, 32, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        MeshRasterizerOpenGL(cams, RasterizationSettings(image_size=32))(mesh)


def test_cuda_entry_points_run_their_plain_versions_on_the_cpu():
    verts, faces = _batch()
    fv = torch.tensor(verts[0][faces[0]])[None]
    fv[..., 2] += 2.7
    valid = torch.ones(fv.shape[:2], dtype=torch.bool)
    for a, b in zip(rasterize_hard_cuda(fv, valid, (32, 40)), rasterize_hard_plain(fv, valid, (32, 40))):
        assert torch.equal(a, b)
    assert torch.equal(rasterize_topk_cuda(fv[0], valid[0], (32, 40), 1e-4, 3),
                       trm.rasterize_topk(fv[0], valid[0], (32, 40), 1e-4, 3))
    assert rasterize_hard_cuda.launches == 0 and rasterize_topk_cuda.launches == 0


def _sphere_faces(image_size, azim=20.0):
    R, T = j_look_at(dist=2.7, elev=15.0, azim=azim)
    m = JRasterizer(JFoVPersp.create(R=R, T=T), JSettings(image_size=image_size)).transform(j_ico_sphere(2))
    fv = np.asarray(m.verts_padded()[0][m.faces_padded()[0]])
    return fv, np.ones(fv.shape[0], bool)


@pytest.mark.parametrize("image_size", [(64, 64), (96, 160)])
def test_hard_plain_against_pallas(interpret_pallas, image_size):
    fv, valid = _sphere_faces(image_size)
    pix, zb, ba = rmp.rasterize_hard_pallas(jnp.asarray(fv), jnp.asarray(valid), image_size)
    t_pix, t_zb, t_ba = rasterize_hard_plain(torch.tensor(fv)[None], torch.tensor(valid)[None], image_size)
    np.testing.assert_array_equal(t_pix[0].numpy(), np.asarray(pix))
    hit = np.asarray(pix) >= 0
    np.testing.assert_allclose(t_zb[0].numpy()[hit], np.asarray(zb)[hit], atol=ZBUF_TOL, rtol=0)
    np.testing.assert_allclose(t_ba[0].numpy()[hit], np.asarray(ba)[hit], atol=BARY_TOL, rtol=0)
    assert (t_zb[0].numpy()[~hit] == -1).all() and (t_ba[0].numpy()[~hit] == -1).all()


@pytest.mark.parametrize("K,blur,persp", [(1, 0.0, False), (4, 1e-4, True)])
def test_topk_plain_against_pallas(interpret_pallas, K, blur, persp):
    size = (64, 80)
    fv, valid = _sphere_faces(size, azim=35.0)
    want = np.asarray(rmp.rasterize_topk_pallas(jnp.asarray(fv), jnp.asarray(valid), size, blur, K, persp))
    got = trm.rasterize_topk(torch.tensor(fv), torch.tensor(valid), size, blur, K, persp).numpy()
    # a z tie within float rounding may pick the other face (bench.py:_row_ok)
    assert (got == want).mean() >= 0.999
    assert (want >= 0).mean() > 0.1


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_mesh_bounds_count_the_function_work():
    """The bounds of #1, #2 and #3 count the pixel centres inside each kept
    face's blur-grown box (brute force here), not the kernel's tile tests."""
    cs = _chip_smoke()
    fv_np, valid_np = _sphere_faces((24, 40))
    fv, valid = torch.tensor(fv_np)[None], torch.tensor(valid_np)[None]
    valid[0, :7] = False
    size, blur = (24, 40), 1e-3
    pxy = trm.pixel_centers_ndc(*size, CPU)
    ok = trm._face_culls(fv, valid, False)[0]
    grow = blur ** 0.5
    x, y = fv[0, :, :, 0], fv[0, :, :, 1]
    inside = ((pxy[None, ..., 0] >= x.amin(-1)[:, None, None] - grow) & (pxy[None, ..., 0] <= x.amax(-1)[:, None, None] + grow)
              & (pxy[None, ..., 1] >= y.amin(-1)[:, None, None] - grow) & (pxy[None, ..., 1] <= y.amax(-1)[:, None, None] + grow))
    want = float(inside[ok].sum())
    assert want > 0
    assert cs.face_box_tests(fv, valid, size, blur) == want
    bound, by, tests = cs.topk_bound(fv, valid, size, blur, 4)
    assert tests == want and bound == pytest.approx(1e3 * max(
        (fv.shape[1] * 36 + size[0] * size[1] * 4 * 4) / cs.PEAK_BYTES_PER_S,
        want * cs.fine_ops_per_candidate(True, True) / cs.PEAK_FP32_OPS_PER_S))
    bound, by, tests = cs.hard_bound(fv, valid, size)
    assert tests == cs.face_box_tests(fv, valid, size, 0.0) <= want
