"""The port's mesh rasterizer against the JAX package.

- The plain path (`rasterize_topk` + `interpolate_fragments`) against the
  JAX XLA oracle (`rasterize_topk_xla` + `interpolate_fragments`) and
  against the JAX Pallas kernel run in interpret mode.
- The CSR binning of the CUDA path is conservative: walking each tile's
  face list reproduces the unbinned plain path bit for bit.
- Gradients of the headline loss (bench.py:117-119) through the plain path
  against `jax.grad`.

Faces come from the same JAX camera transform of an icosphere, handed to
the port as numpy arrays; the port runs on the CPU.
"""

import importlib
import itertools

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer.mesh.rasterize_pallas as rmp
from pytorch3d_tpu.renderer import (
    FoVPerspectiveCameras as JCameras,
    MeshRasterizer as JRasterizer,
    RasterizationSettings as JSettings,
    look_at_view_transform as j_look_at,
)
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc
from pytorch3d_tpu_torch.structures import Meshes

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

# The packages' mesh/__init__ re-exports the function under the module's name.
jrm = importlib.import_module("pytorch3d_tpu.renderer.mesh.rasterize_meshes")
trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")

CPU = torch.device("cpu")


def _jax_mesh_ndc(mesh, image_size, elev=15.0, azim=20.0):
    R, T = j_look_at(dist=2.7, elev=elev, azim=azim)
    cams = JCameras.create(R=R, T=T)
    return JRasterizer(cams, JSettings(image_size=image_size)).transform(mesh)


def _faces(level=2, image_size=64):
    """(F, 3, 3) NDC face verts of an icosphere and an all-true valid mask."""
    m = _jax_mesh_ndc(j_ico_sphere(level), image_size)
    fv = np.asarray(m.verts_padded()[0][m.faces_padded()[0]])
    return fv, np.ones(fv.shape[0], bool)


def _agree(ids_t, ids_j, zt, zj, bt, bj, dt, dj, atol):
    """ids equal on >= 99.9 % of slots (a z tie within float rounding may
    pick the other face); zbuf, bary and dists within atol where they agree."""
    ids_t, ids_j = np.asarray(ids_t), np.asarray(ids_j)
    same = ids_t == ids_j
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(np.asarray(zt)[same], np.asarray(zj)[same], atol=atol)
    np.testing.assert_allclose(np.asarray(bt)[same], np.asarray(bj)[same], atol=atol)
    np.testing.assert_allclose(np.asarray(dt)[same], np.asarray(dj)[same], atol=atol)


def _plain(fv, valid, size, blur, K, persp, clip, cull):
    fvt = torch.tensor(fv)
    idx = trm.rasterize_topk(fvt, torch.tensor(valid), size, blur, K, persp, clip, cull)
    z, b, d = trm.interpolate_fragments(fvt, idx, size, persp, clip)
    return idx.numpy(), z.numpy(), b.numpy(), d.numpy()


# A subset of tests/test_grad_matrix.py's grid: K x blur x four of the
# (perspective_correct, clip_barycentric_coords, cull_backfaces) corners.
_GRID = [
    (K, blur) + flags
    for K, blur, flags in itertools.product(
        (1, 4), (0.0, 1e-4),
        ((False, False, False), (True, True, False), (True, False, True), (False, True, True)),
    )
]


@pytest.mark.parametrize("K,blur,persp,clip,cull", _GRID)
def test_plain_matches_jax_xla(K, blur, persp, clip, cull):
    fv, valid = _faces()
    size = (64, 64)
    idx_j = jrm.rasterize_topk_xla(
        jnp.asarray(fv), jnp.asarray(valid), size, blur, K,
        perspective_correct=persp, clip_barycentric_coords=clip, cull_backfaces=cull,
    )
    zj, bj, dj = jrm.interpolate_fragments(jnp.asarray(fv), idx_j, size, persp, clip)
    idx_t, zt, bt, dt = _plain(fv, valid, size, blur, K, persp, clip, cull)
    # The same float32 ops in the same order on both sides: atol 1e-5.
    _agree(idx_t, idx_j, zt, zj, bt, bj, dt, dj, atol=1e-5)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rmp.pl, "pallas_call", patched)


@pytest.mark.parametrize("K,blur,persp,clip", [(1, 0.0, False, False), (4, 1e-4, True, True)])
def test_plain_matches_jax_pallas_interpret(interpret_pallas, K, blur, persp, clip):
    fv, valid = _faces(image_size=128)
    size = (128, 128)
    idx_j, zj, bj, dj = rmp.rasterize_fragments_pallas(
        jnp.asarray(fv), jnp.asarray(valid), size, blur, K, persp, clip
    )
    idx_t, zt, bt, dt = _plain(fv, valid, size, blur, K, persp, clip, False)
    # The TPU kernel scales edge functions by 1/(area + eps) where the plain
    # path divides: a few ulp, atol 1e-5 on values (bary of O(1), z of O(3)).
    _agree(idx_t, idx_j, zt, zj, bt, bj, dt, dj, atol=1e-5)


def _batch_faces(image_size):
    """(2, F, 3, 3) face verts of ico2 and a small torus (different face
    counts, so the second image has padding) and their valid mask."""
    mesh = Meshes.create(
        [np.asarray(j_ico_sphere(2).verts_padded()[0]), np.asarray(j_torus(0.4, 1.2, 8, 16).verts_padded()[0])],
        [np.asarray(j_ico_sphere(2).faces_padded()[0]), np.asarray(j_torus(0.4, 1.2, 8, 16).faces_padded()[0])],
        device=CPU,
    )
    from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, MeshRasterizer, look_at_view_transform

    R, T = look_at_view_transform(2.7, 15.0, 20.0, device=CPU)
    ndc = MeshRasterizer(FoVPerspectiveCameras.create(R=R, T=T, device=CPU)).transform(mesh)
    N, F = len(ndc), ndc.max_faces
    fv = ndc.verts_packed()[ndc.faces_packed()].reshape(N, F, 3, 3)
    return fv, ndc.faces_packed_mask().reshape(N, F)


@pytest.mark.parametrize(
    "size,blur,K,cull",
    [((64, 64), 0.0, 1, False), ((64, 64), 1e-4, 4, False), ((48, 64), 4e-3, 4, True), ((64, 40), 1e-4, 8, False)],
)
def test_binning_is_conservative(size, blur, K, cull):
    fv, valid = _batch_faces(size)
    H, W = size
    ok = trm._face_culls(fv, valid, cull)
    tile_faces, tile_start, n_ty, n_tx = trc.bin_faces(fv, ok, size, blur)
    assert tile_start.shape == (fv.shape[0] * n_ty * n_tx + 1,)
    assert len(tile_faces) < int(ok.sum()) * n_ty * n_tx  # the bins do prune
    pxy = trm.pixel_centers_ndc(H, W, CPU)
    TH, TW = trc.TILE
    for n in range(fv.shape[0]):
        full = trm.rasterize_topk(fv[n], valid[n], size, blur, K, True, True, cull)
        for ty, tx in itertools.product(range(n_ty), range(n_tx)):
            i = (n * n_ty + ty) * n_tx + tx
            faces = tile_faces[tile_start[i] : tile_start[i + 1]].long()
            assert (faces[1:] > faces[:-1]).all()  # ascending ids: the kernel's tie order
            rows, cols = slice(ty * TH, (ty + 1) * TH), slice(tx * TW, (tx + 1) * TW)
            local = trm.rasterize_topk_at_pixels(
                fv[n][faces], valid[n][faces], pxy[rows, cols], blur, K, True, True, cull
            )
            walked = torch.where(local >= 0, faces[local.clamp(min=0)], -1) if len(faces) else local
            # Same candidates, same order: bit for bit.
            assert torch.equal(walked, full[rows, cols]), (n, ty, tx)


def test_cpu_wrapper_runs_plain_version():
    fv, valid = _batch_faces((32, 32))
    before = trc.rasterize_fragments_cuda.launches
    got = trc.rasterize_fragments_cuda(fv, valid, (32, 32), 1e-4, 4, True, True, False)
    want = trc.rasterize_fragments_plain(fv, valid, (32, 32), 1e-4, 4, True, True, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert trc.rasterize_fragments_cuda.launches == before


def test_headline_loss_gradients_match_jax():
    mesh_j = _jax_mesh_ndc(j_ico_sphere(2), 64, elev=20.0, azim=30.0)
    verts = np.asarray(mesh_j.verts_padded())
    faces = np.asarray(mesh_j.faces_padded())
    kw = dict(image_size=64, blur_radius=1e-4, faces_per_pixel=4)

    def loss_j(v):  # bench.py:117-119
        _, zbuf, _, dists = jrm.rasterize_meshes(mesh_j.update_padded(v), bin_size=0, **kw)
        return jnp.sum(jax.nn.sigmoid(-dists / 1e-4)) * 1e-6 + jnp.sum(zbuf) * 1e-6

    vt = torch.from_numpy(verts).requires_grad_(True)
    _, zbuf, _, dists = trm.rasterize_meshes(Meshes.create(vt, faces, device=CPU), bin_size=0, **kw)
    lt = torch.sum(torch.sigmoid(-dists / 1e-4)) * 1e-6 + torch.sum(zbuf) * 1e-6
    lt.backward()
    lj, gj = jax.value_and_grad(loss_j)(jnp.asarray(verts))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    # Sums of float32 per-pixel terms in another order: rtol 1e-4, atol 1e-6.
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-6)


def test_z_clip_value_not_ported_yet():
    """z_clip_value is ported now (the name is kept): a face with one vertex
    before the plane is clipped, its ids map back to face 0 and every
    covered depth lies beyond the plane (tests/test_torch_clip.py holds
    it against the JAX package)."""
    verts = torch.tensor([[[-0.8, -0.8, 0.05], [0.8, -0.8, 1.0], [0.0, 0.8, 1.0]]])
    mesh = Meshes.create(verts, torch.tensor([[[0, 1, 2]]]), device=CPU)
    pix, zbuf, _, _ = trm.rasterize_meshes(mesh, image_size=16, faces_per_pixel=2, z_clip_value=0.1, bin_size=0)
    filled = pix >= 0
    assert filled.any() and int(pix.max()) == 0
    assert float(zbuf[filled].min()) >= 0.1 - 1e-6
