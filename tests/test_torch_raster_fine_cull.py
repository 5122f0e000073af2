"""The fine mesh rasterizer's pixel-box cull, on the CPU.

The CUDA kernel (csrc/rasterize_fine.cu) tests a (pixel, face) pair only
where the pixel lies in the face's pixel box, which
`chip_smoke.face_pixel_boxes` makes in torch: the pixels whose centre lies
in the face's bounding box grown by sqrt(blur_radius) and half a pixel, or
the whole image for a face with a vertex behind the camera under
perspective correction.  Here:

- every (pixel, face) the plain version covers, at slots 0..K-1, lies in
  its face's pixel box, over blurs, perspective correction, clipping,
  backface culling, a non-square image and a mesh whose faces cross
  z = 0;
- such a face does cover pixels outside its bounding box under
  perspective correction, and only then: why its box is the whole image;
- each box is the brute-force set of pixel centres in the grown box, and
  lies in the tiles the binning gives the face;
- `chip_smoke.fine_tests` counts the pairs the kernel tests as a brute
  force over the binning does;
- the CPU wrappers still equal the plain version and match the JAX
  package's `_fine_kernel` run in interpret mode.

Inputs are numpy arrays (an icosphere, and a seeded strip of large faces
around the camera) through the JAX package's camera, handed to both
packages; the port runs on the CPU.
"""

import functools
import importlib
import importlib.util
import pathlib

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
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _strip_np(n=4, seed=0):
    """A seeded strip of 2n large faces on a floor below the camera, each
    with one or two vertices behind it (z < 0): n with two, n with one."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-2.0, 2.0, n + 1)
    front = np.stack([x, np.full(n + 1, -0.6), np.full(n + 1, 2.0)], -1)
    back = np.stack([x, np.full(n + 1, -0.6), np.full(n + 1, -2.0)], -1)
    verts = np.concatenate([front, back]) + rng.uniform(-0.2, 0.2, (2 * n + 2, 3))
    faces = [(i, n + 1 + i, n + 2 + i) for i in range(n)] + [(i, i + 1, n + 2 + i) for i in range(n)]
    return verts.astype(np.float32), np.array(faces, np.int32)


@functools.lru_cache(maxsize=None)
def _faces_np(mesh, size):
    if mesh == "strip":  # the camera at the origin, looking along +z
        cams = [JCameras.create(R=jnp.eye(3)[None], T=jnp.zeros((1, 3)), aspect_ratio=size[1] / size[0])]
        verts, faces = _strip_np()
        meshes = JMeshes.create([jnp.asarray(verts)], [jnp.asarray(faces)])
    else:
        cams = [JCameras.create(R=R, T=T, aspect_ratio=size[1] / size[0])
                for R, T in (j_look_at(dist=2.7, elev=15.0, azim=a) for a in (20.0, 75.0))]
        meshes = j_ico_sphere(2)
    out = []
    for cam in cams:
        m = JRasterizer(cam, JSettings(image_size=size)).transform(meshes)
        out.append(np.asarray(m.verts_padded()[0][m.faces_padded()[0]]))
    return np.stack(out)


def _faces(mesh, size):
    """(N, F, 3, 3) NDC face verts and an all-true valid mask."""
    fv = torch.from_numpy(_faces_np(mesh, size).copy())
    return fv, torch.ones(fv.shape[:2], dtype=torch.bool)


def _outside(ids, boxes):
    """Per covered slot of `ids` (N, H, W, K), whether its pixel lies
    outside its face's box in `boxes` (N * F, 4); and the slots' faces."""
    N = ids.shape[0]
    n, r, c, _ = torch.nonzero(ids >= 0, as_tuple=True)
    f = ids[ids >= 0].long()
    b = boxes.view(N, -1, 4)[n, f].long()
    inside = (r >= b[:, 0]) & (r <= b[:, 1]) & (c >= b[:, 2]) & (c <= b[:, 3])
    return ~inside, f


_CASES = [
    # mesh, size, blur, K, persp, clip, cull
    ("ico", (48, 48), 0.0, 1, True, False, False),
    ("ico", (48, 48), 1e-4, 4, True, True, False),
    ("ico", (48, 48), 4e-3, 8, True, True, False),
    ("ico", (48, 48), 1e-4, 4, False, False, True),
    ("ico", (40, 64), 1e-4, 4, True, True, False),
    ("strip", (48, 48), 1e-4, 4, True, True, False),
    ("strip", (40, 64), 4e-3, 4, False, False, False),
]


@pytest.mark.parametrize("mesh,size,blur,K,persp,clip,cull", _CASES)
def test_covered_pairs_lie_in_their_pixel_boxes(mesh, size, blur, K, persp, clip, cull):
    fv, valid = _faces(mesh, size)
    ids = trc.rasterize_fragments_plain(fv, valid, size, blur, K, persp, clip, cull)[0]
    outside, _ = _outside(ids, _chip_smoke().face_pixel_boxes(fv, size, blur, persp))
    assert outside.numel() > 0 and not outside.any(), int(outside.sum())


def test_faces_crossing_z0_cover_pixels_outside_their_bounding_box():
    size, blur = (48, 48), 1e-4
    fv, valid = _faces("strip", size)
    zmin = fv[..., 2].amin(-1)[0]
    assert (zmin < 0).all() and (fv[..., 2].amax(-1) >= 0).all()  # every face crosses z = 0
    bounding = _chip_smoke().face_pixel_boxes(fv, size, blur, False)  # without the whole-image rule
    for persp in (True, False):
        ids = trc.rasterize_fragments_plain(fv, valid, size, blur, 4, persp, False)[0]
        outside, faces = _outside(ids, bounding)
        if persp:
            # The visible part of a face with two vertices behind the camera
            # runs from its front vertex out of its bounding box.
            behind = (fv[0, :, :, 2] < 0).sum(-1)
            assert outside.sum() > 0 and (behind[faces[outside]] == 2).all()
        else:
            assert not outside.any()


@pytest.mark.parametrize("mesh,size,blur,persp", [
    ("ico", (48, 48), 0.0, False), ("ico", (40, 64), 1e-4, True), ("ico", (64, 40), 4e-3, True),
    ("strip", (48, 48), 1e-4, True), ("strip", (48, 48), 1e-4, False),
])
def test_pixel_boxes_are_the_pixel_centres_in_the_grown_box(mesh, size, blur, persp):
    fv, _ = _faces(mesh, size)
    H, W = size
    boxes = _chip_smoke().face_pixel_boxes(fv, size, blur, persp).view(*fv.shape[:2], 4)
    assert boxes.dtype == torch.int32 and boxes.is_contiguous()
    xmin, xmax, ymin, ymax = trc.face_boxes(fv, size, blur)
    ys, xs = trm.pixel_grid_ndc(H, W, torch.device("cpu"))
    cols = (xs >= xmin[..., None]) & (xs <= xmax[..., None])  # (N, F, W)
    rows = (ys >= ymin[..., None]) & (ys <= ymax[..., None])  # (N, F, H)
    whole = (fv[..., 2].amin(-1) < 0) & persp
    for inside, n_pix, lo, hi in ((rows, H, boxes[..., 0], boxes[..., 1]), (cols, W, boxes[..., 2], boxes[..., 3])):
        index = torch.arange(n_pix)
        first = torch.where(inside, index, n_pix).amin(-1)
        last = torch.where(inside, index, -1).amax(-1)
        hit = inside.any(-1)
        first, last = torch.where(whole, 0, first), torch.where(whole, n_pix - 1, last)
        assert torch.equal(lo[hit | whole], first[hit | whole].int())
        assert torch.equal(hi[hit | whole], last[hit | whole].int())
        assert (lo[~hit & ~whole] > hi[~hit & ~whole]).all()  # empty
    assert whole.any() == (mesh == "strip" and persp)


@pytest.mark.parametrize("size,blur", [((48, 48), 1e-4), ((40, 64), 4e-3)])
def test_pixel_boxes_lie_in_the_tiles_of_the_binning(size, blur):
    fv, _ = _faces("ico", size)
    boxes = _chip_smoke().face_pixel_boxes(fv, size, blur, True).view(*fv.shape[:2], 4)
    (ty0, ny), (tx0, nx) = trc.box_tiles(*trc.face_boxes(fv, size, blur), size)
    TH, TW = trc.TILE
    empty = (boxes[..., 0] > boxes[..., 1]) | (boxes[..., 2] > boxes[..., 3])
    assert (~empty).sum() > 0
    assert (boxes[..., 0] >= ty0 * TH)[~empty].all() and (boxes[..., 1] < (ty0 + ny) * TH)[~empty].all()
    assert (boxes[..., 2] >= tx0 * TW)[~empty].all() and (boxes[..., 3] < (tx0 + nx) * TW)[~empty].all()


def test_chip_smoke_counts_the_tests_the_kernel_makes():
    cs = _chip_smoke()
    source = (pathlib.Path(trc.__file__).resolve().parents[2] / "csrc" / "rasterize_fine.cu").read_text()
    assert f"kRectH = {cs.FINE_RECT[0]};" in source and f"kRectW = {cs.FINE_RECT[1]};" in source
    size, blur = (40, 64), 1e-4
    fv, valid = _faces("ico", size)
    N, F = valid.shape
    H, W = size
    bins = trc.bin_faces(fv, trm._face_culls(fv, valid, False), size, blur)
    boxes = _chip_smoke().face_pixel_boxes(fv, size, blur, True)
    made, walked = cs.fine_tests(bins, boxes, N, F, size)
    tile_faces, tile_start, n_ty, n_tx = bins
    TH, TW = trc.TILE
    RH, RW = cs.FINE_RECT
    b = boxes.view(N, F, 4)
    want_made = want_walked = 0
    for t in range(N * n_ty * n_tx):
        n, ty, tx = t // (n_ty * n_tx), (t // n_tx) % n_ty, t % n_tx
        r = torch.arange(ty * TH, min((ty + 1) * TH, H))[:, None]
        c = torch.arange(tx * TW, min((tx + 1) * TW, W))[None, :]
        for f in tile_faces[tile_start[t]:tile_start[t + 1]].tolist():
            r0, r1, c0, c1 = b[n, f].tolist()
            want_made += int(((r >= r0) & (r <= r1) & (c >= c0) & (c <= c1)).sum())
            for wr in range(ty * TH, (ty + 1) * TH, RH):
                for wc in range(tx * TW, (tx + 1) * TW, RW):
                    meets = r0 <= r1 and c0 <= c1 and r0 < wr + RH and r1 >= wr and c0 < wc + RW and c1 >= wc
                    want_walked += 32 * meets
    assert (made, walked) == (want_made, want_walked)
    assert made < cs.tile_candidates(tile_start, N, n_ty, n_tx, size) and made <= walked


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rmp.pl, "pallas_call", patched)


@pytest.mark.parametrize("blur,K,persp,clip", [(1e-4, 4, True, True), (0.0, 1, False, False)])
def test_cpu_wrappers_match_plain_and_jax_fine_kernel(interpret_pallas, blur, K, persp, clip):
    size = (32, 32)  # interpret mode runs the TPU kernel's grid step by step
    fv, valid = _faces("ico", size)
    fv, valid = fv[:1], valid[:1]
    before = (trc.rasterize_fragments_cuda.launches, trc.rasterize_topk_cuda.launches)
    got = trc.rasterize_fragments_cuda(fv, valid, size, blur, K, persp, clip)
    ids = trc.rasterize_topk_cuda(fv[0], valid[0], size, blur, K, persp, clip)
    assert (trc.rasterize_fragments_cuda.launches, trc.rasterize_topk_cuda.launches) == before
    plain = trc.rasterize_fragments_plain(fv, valid, size, blur, K, persp, clip)
    assert all(torch.equal(g, w) for g, w in zip(got, plain)) and torch.equal(ids, plain[0][0])
    fvj, validj = jnp.asarray(fv[0].numpy()), jnp.asarray(valid[0].numpy())
    want = rmp.rasterize_fragments_pallas(fvj, validj, size, blur, K, persp, clip)
    want_ids = rmp.rasterize_topk_pallas(fvj, validj, size, blur, K, persp, clip)
    assert np.array_equal(np.asarray(want[0]), np.asarray(want_ids))  # one body, two builds
    # The TPU kernel scales edge functions by 1/(area + eps) where the plain
    # path divides: ids equal on >= 99.9 % of slots (a z tie within float
    # rounding may pick the other face), values within 1e-5 where they agree.
    same = got[0][0].numpy() == np.asarray(want[0])
    assert same.mean() >= 0.999, same.mean()
    for g, w in zip(got[1:], want[1:]):
        g, w = g[0].numpy(), np.asarray(w)
        m = same if g.ndim == same.ndim else same[..., None].repeat(3, -1)
        np.testing.assert_allclose(g[m], w[m], atol=1e-5, rtol=0)
