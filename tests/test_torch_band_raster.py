"""The row-band entry of the fine mesh rasterizer, on the CPU.

`rasterize_fragments_band_cuda` (the counterpart of the JAX package's
`rasterize_fragments_pallas_band`) rasterizes rows [row0, row0 + rows) of an
image.  On the card it launches the fine kernel and its backward over a
binning of that band, whose 16x16 tiles start at pixel row row0; on the CPU
it runs `rasterize_fragments_band_plain`.  Here:

- the plain band equals those rows of the port's full plain fragments, and
  its gradient those rows' share of the full gradient, at band heights 16,
  24 (off the tile grid) and 120;
- it matches the JAX package's band entry run in interpret mode, band by
  band, at `tests/test_parallel.py`'s `TestShardMapRasterPallas` size, and
  that package's XLA oracle bit for bit;
- the band binning's tiles equal the full binning's where the band starts
  on the tile grid, and everywhere they hold every face that covers a
  pixel of the tile, which is what makes the kernel's band equal the full
  image's rows; faces crossing z = 0 under perspective correction
  included;
- the grad plain version over a band sums, over the bands, to the full
  image's gradient.

Inputs are numpy arrays (an icosphere through the JAX package's camera),
handed to both packages; the port runs on the CPU.
"""

import functools

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
from pytorch3d_tpu.renderer.mesh.rasterize_meshes import interpolate_fragments as j_interpolate_fragments
from pytorch3d_tpu.renderer.mesh.rasterize_meshes import rasterize_topk_xla
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc
from pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes import _face_culls, rasterize_grad_plain

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

BLUR = 1e-4
K = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Beside other test processes on the machine's cores, torch's full
    thread pool makes the plain band ~20x slower (43 s for a band height
    in a 6-worker run); two threads keep it near its time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _faces_np(size):
    """ico_sphere(2) in NDC through the JAX package's camera (as
    TestShardMapRasterPallas makes it), as numpy."""
    R, T = j_look_at(dist=2.7, elev=15.0, azim=40.0)
    rast = JRasterizer(JCameras.create(R=R, T=T, aspect_ratio=size[1] / size[0]), JSettings(image_size=size))
    tm = rast.transform(j_ico_sphere(2))
    fv = tm.verts_padded()[0][tm.faces_padded()[0]]
    valid = tm.faces_padded()[0, :, 0] >= 0
    return np.asarray(fv), np.asarray(valid)


def _faces(size):
    fv, valid = _faces_np(size)
    return torch.tensor(fv)[None], torch.tensor(valid)[None]


@pytest.mark.parametrize("rows", [16, 24, 120])
def test_plain_band_equals_the_full_image_rows(rows):
    """Every band of `rows` rows (the last one shorter where rows does not
    divide H) equals those rows of the full plain fragments bit for bit, and
    its gradient of a seeded loss is those rows' share: the bands' gradients
    sum to the full image's."""
    size = (240, 96)
    fv, valid = _faces(size)
    fv = fv.requires_grad_(True)
    full = trc.rasterize_fragments_plain(fv, valid, size, BLUR, K)
    rng = np.random.default_rng(rows)
    weights = [torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32) for t in full[1:]]
    (want,) = torch.autograd.grad(sum((t * w).sum() for t, w in zip(full[1:], weights)), fv)
    total = torch.zeros_like(want)
    for row0 in range(0, size[0], rows):
        h = min(rows, size[0] - row0)
        band = trc.rasterize_fragments_band_cuda(fv, valid, row0, h, size, BLUR, K)
        for got, ref in zip(band, full):
            assert got.shape == (1, h, *ref.shape[2:])
            assert torch.equal(got, ref[:, row0 : row0 + h])
        loss = sum((t * w[:, row0 : row0 + h]).sum() for t, w in zip(band[1:], weights))
        total += torch.autograd.grad(loss, fv)[0]
    # The bands' sums per face run in another order than the full image's:
    # rounding of sums of ~1e2 terms of up to ~1e2.
    scale = float(want.abs().max())
    assert scale > 0
    assert float((total - want).abs().max()) <= 1e-5 * scale


def test_band_outside_the_image_raises():
    fv, valid = _faces((64, 64))
    for row0, rows in ((-1, 8), (0, 0), (60, 8)):
        with pytest.raises(ValueError):
            trc.rasterize_fragments_band_cuda(fv, valid, row0, rows, (64, 64), BLUR, K)


@pytest.fixture
def _interpret_pallas(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, as
    tests/test_parallel.py's TestShardMapRasterPallas runs them."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rmp.pl, "pallas_call", patched)


def test_bands_match_the_jax_band_entry(_interpret_pallas):
    """ico_sphere(2) at 128^2, K=4, blur 1e-4 in 4 bands of 32 rows (JAX's
    tile height here, so its band is one tile row): ids equal to the Pallas
    band's, and the values equal bit for bit to those rows of the JAX
    package's XLA oracle (`rasterize_topk_xla` + `interpolate_fragments`),
    whose arithmetic the port's follows.  The Pallas kernel multiplies by
    reciprocals where both divide: measured up to 4.8e-5 off them in bary
    and 3.2e-5 in zbuf at sliver faces, and 6e-9 in dists; held within
    1e-4."""
    size = (128, 128)
    fv_np, valid_np = _faces_np(size)
    assert rmp._tile_for(K, fv_np.shape[0], size[0])[0] == 32
    fv_j, valid_j = jnp.asarray(fv_np), jnp.asarray(valid_np)

    # One tile row a band; the tile lists' capacity is every face, so none
    # is dropped.
    pallas_band = jax.jit(lambda fv, ok, ty0: rmp.rasterize_fragments_pallas_band(
        fv, ok, ty0, size, BLUR, K, False, False, False, fv_np.shape[0], 1))
    # The oracle eager: jitted, XLA fuses its arithmetic into other bits.
    idx_x = rasterize_topk_xla(fv_j, valid_j, size, blur_radius=BLUR, faces_per_pixel=K)
    want_full = [np.asarray(a) for a in (idx_x, *j_interpolate_fragments(fv_j, idx_x, size))]
    fv, valid = _faces(size)
    for band in range(4):
        rows = slice(32 * band, 32 * band + 32)
        want = [np.asarray(a) for a in pallas_band(fv_j, valid_j, jnp.int32(band))]
        got = [t[0].numpy() for t in trc.rasterize_fragments_band_cuda(fv, valid, 32 * band, 32, size, BLUR, K)]
        assert np.array_equal(got[0], want[0])
        assert (got[0] >= 0).any()
        for g, w, o in zip(got, want, want_full):
            assert np.array_equal(g, o[rows])
            np.testing.assert_allclose(g, w, atol=1e-4)


def _tile_lists(bins):
    tile_faces, tile_start, n_ty, n_tx = bins
    return [tile_faces[tile_start[t] : tile_start[t + 1]].tolist() for t in range(n_ty * n_tx)]


@pytest.mark.parametrize("row0,rows", [(0, 48), (32, 64), (96, 32)])
def test_band_binning_on_the_tile_grid_equals_the_full_binning(row0, rows):
    size = (128, 112)
    fv, valid = _faces(size)
    ok = _face_culls(fv, valid, False)
    full = trc.bin_faces(fv, ok, size, BLUR)
    band = trc.bin_faces(fv, ok, size, BLUR, (row0, rows))
    assert band[2:] == (rows // 16, full[3])
    full_lists, band_lists = _tile_lists(full), _tile_lists(band)
    n_tx = full[3]
    for ty in range(rows // 16):
        for tx in range(n_tx):
            assert band_lists[ty * n_tx + tx] == full_lists[(row0 // 16 + ty) * n_tx + tx]


def _missing(idx, bins):
    """The filled slots of a band's ids (rows, W, K) whose face is not in
    the list of its pixel's band tile; and the count of filled slots."""
    lists = _tile_lists(bins)
    n_tx = bins[3]
    filled = (idx >= 0).nonzero().tolist()
    return [(r, c, k) for r, c, k in filled if int(idx[r, c, k]) not in lists[(r // 16) * n_tx + c // 16]], len(filled)


@pytest.mark.parametrize("row0,rows", [(8, 40), (37, 51), (100, 28)])
def test_band_tiles_hold_every_covering_face(row0, rows):
    """Off the tile grid: each slot the plain band fills names a face in
    the list of its pixel's band tile, and every list ascends."""
    size = (128, 112)
    fv, valid = _faces(size)
    bins = trc.bin_faces(fv, _face_culls(fv, valid, False), size, BLUR, (row0, rows))
    idx = trc.rasterize_fragments_band_plain(fv, valid, row0, rows, size, BLUR, K)[0][0]
    missing, filled = _missing(idx, bins)
    assert filled and not missing
    assert all(a == sorted(a) for a in _tile_lists(bins))


@functools.lru_cache(maxsize=None)
def _strip_np(size):
    """A seeded strip of 8 large faces on a floor below a camera at the
    origin, each with one or two vertices behind it (z < 0), in NDC through
    the JAX package's camera, as numpy."""
    rng = np.random.default_rng(0)
    x = np.linspace(-2.0, 2.0, 5)
    verts = np.concatenate([np.stack([x, np.full(5, -0.6), np.full(5, z)], -1) for z in (2.0, -2.0)])
    verts = (verts + rng.uniform(-0.2, 0.2, verts.shape)).astype(np.float32)
    faces = np.array([(i, 5 + i, 6 + i) for i in range(4)] + [(i, i + 1, 6 + i) for i in range(4)], np.int32)
    cam = JCameras.create(R=jnp.eye(3)[None], T=jnp.zeros((1, 3)), aspect_ratio=size[1] / size[0])
    m = JRasterizer(cam, JSettings(image_size=size)).transform(JMeshes.create([jnp.asarray(verts)], [jnp.asarray(faces)]))
    return np.asarray(m.verts_padded()[0][m.faces_padded()[0]])


@pytest.mark.parametrize("row0,rows", [(0, 96), (40, 56), (67, 29)])
def test_band_tiles_hold_faces_crossing_z0(row0, rows):
    """Under perspective correction a face with a vertex behind the camera
    covers pixels far outside its bounding box, which the kernel tests
    (its pixel box is the whole image).  The binning lists such a face in
    every tile, so each slot the plain band fills names a face of its
    tile's list, on the tile grid and off it: the kernel's band equals the
    full image's rows and its plain version there too.  Binned by the
    bounding box alone, slots are missing from their tiles."""
    size = (96, 80)
    fv = torch.tensor(_strip_np(size))[None]
    valid = torch.ones(fv.shape[:2], dtype=torch.bool)
    assert (fv[..., 2].amin(-1) < 0).all()
    ok = _face_culls(fv, valid, False)
    idx = trc.rasterize_fragments_band_plain(fv, valid, row0, rows, size, BLUR, K, True)[0][0]
    missing, filled = _missing(idx, trc.bin_faces(fv, ok, size, BLUR, (row0, rows), perspective_correct=True))
    assert filled and not missing
    by_box, _ = _missing(idx, trc.bin_faces(fv, ok, size, BLUR, (row0, rows)))
    assert by_box


def test_grad_plain_over_bands_sums_to_the_full_gradient():
    """`rasterize_grad_plain(..., row0=)` on each band's ids and cotangents
    adds up to the full image's gradient (float64)."""
    size = (96, 64)
    fv, valid = _faces(size)
    fv = fv.double()
    idx = trc.rasterize_fragments_plain(fv, valid, size, BLUR, K)[0]
    rng = np.random.default_rng(0)
    cots = [torch.tensor(rng.standard_normal(s)) for s in (idx.shape, (*idx.shape, 3), idx.shape)]
    want = rasterize_grad_plain(fv, idx, *cots, size)
    got = sum(
        rasterize_grad_plain(fv, idx[:, r : r + 24], *(c[:, r : r + 24] for c in cots), size, row0=r)
        for r in range(0, size[0], 24)
    )
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
