"""The hard mesh rasterizer's pixel-box cull, on the CPU.

The CUDA kernel (csrc/rasterize_hard.cu, #3) tests a (pixel, face) pair
only where the pixel lies in the face's pixel box, which
`chip_smoke.face_pixel_boxes` makes in torch at blur 0 without
perspective correction: the pixels whose centre lies in the face's
bounding box grown by half a pixel.  Its inside test is on the
screen-space barycentrics, so no face should need a wider box.  Here,
on seeded meshes, on `chip_smoke.hard_cull_edge_faces`' adversarial
faces (a grown box's edge on a pixel centre, edges through pixel centres,
duplicates at one z, zero-area and sub-pixel faces, faces over several tiles or across
warp-rectangle and tile borders, faces from outside the image, vertices
behind the camera or far off the image) and on a strip of faces crossing
z = 0:

- `rasterize_hard_plain` restricted to the pixel boxes gives its ids, z
  and bary unrestricted, bit for bit;
- every (pixel, face) pair that the plain selection finds covering lies
  in the face's pixel box, faces crossing z = 0 included;
- `chip_smoke.hard_bound` counts the pixel centres in the kept faces'
  boxes, and `chip_smoke.hard_tests` the pairs the kernel tests, as brute
  forces do;
- the CPU wrapper still equals the plain version and matches the JAX
  package's `_hard_kernel` run in interpret mode.

Inputs are made in torch on the CPU from numpy seeds (the port's camera)
and handed to the JAX package as numpy arrays.
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
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc
from pytorch3d_tpu_torch.utils import ico_sphere

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _faces(case, size):
    """(N, F, 3, 3) NDC face verts and an (N, F) valid mask."""
    cs = _chip_smoke()
    if case == "ico":
        mesh = ico_sphere(2, device=CPU)
        parts = [cs.face_inputs(mesh, cs.camera(a, CPU, aspect_ratio=size[1] / size[0]), size) for a in (20.0, 75.0)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    if case == "edges":
        return cs.hard_cull_edge_batch(CPU, size)
    return cs.crossing_strip_faces(CPU, size)


def _pixel_z(fv, valid, size):
    """(N, H, W, F) z of each face at each pixel centre, +inf where the
    plain selection finds it not covering: `rasterize_topk`'s candidates
    at blur 0, K = 1, without perspective correction."""
    pxy = trm.pixel_centers_ndc(*size, CPU)
    return torch.stack([
        trm._face_pixel_candidates(f, trm._face_culls(f, m, False), pxy, 0.0, False, False)
        for f, m in zip(fv, valid)
    ])


def _in_boxes(fv, size):
    """(N, H, W, F) whether each pixel lies in each face's pixel box."""
    H, W = size
    b = _chip_smoke().face_pixel_boxes(fv, size, 0.0, False).view(*fv.shape[:2], 1, 1, 4).long()
    r = torch.arange(H)[:, None, None]
    c = torch.arange(W)[None, :, None]
    return ((r >= b[..., 0].transpose(1, 3)) & (r <= b[..., 1].transpose(1, 3))
            & (c >= b[..., 2].transpose(1, 3)) & (c <= b[..., 3].transpose(1, 3)))


def _select(z):
    """(N, H, W) the face of smallest z, the lowest id among equal ones
    (argmin returns the first), -1 where none covers."""
    best = z.min(-1)
    return torch.where(torch.isinf(best.values), -1, z.argmin(-1))


_CASES = [
    ("ico", (48, 48)),
    ("ico", (40, 64)),
    ("edges", (40, 56)),
    ("edges", (48, 48)),
    ("strip", (48, 48)),
    ("strip", (40, 64)),
]


@pytest.mark.parametrize("case,size", _CASES)
def test_plain_restricted_to_the_pixel_boxes_equals_the_plain_version(case, size):
    fv, valid = _faces(case, size)
    z = _pixel_z(fv, valid, size)
    ids = _select(z)
    want = trc.rasterize_hard_plain(fv, valid, size)
    assert torch.equal(ids, want[0][..., 0].long())  # the selection here is the plain version's
    restricted = _select(torch.where(_in_boxes(fv, size), z, torch.inf))
    got = [restricted[..., None]]
    for f, i in zip(fv, restricted):
        zb, bary, _ = trm.interpolate_fragments(f, i[..., None], size, perspective_correct=True)
        got.append((zb, bary))
    got = [got[0], torch.stack([g[0] for g in got[1:]]), torch.stack([g[1] for g in got[1:]])]
    assert torch.equal(got[0], want[0].long())
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (restricted >= 0).sum() > 0


@pytest.mark.parametrize("case,size", _CASES)
def test_every_covering_pair_lies_in_its_pixel_box(case, size):
    fv, valid = _faces(case, size)
    covers = torch.isfinite(_pixel_z(fv, valid, size))
    outside = covers & ~_in_boxes(fv, size)
    assert covers.sum() > 0 and not outside.any(), int(outside.sum())


def test_faces_crossing_z0_need_no_wider_box():
    size = (48, 48)
    fv, valid = _faces("strip", size)
    assert (fv[..., 2].amin(-1) < 0).all() and (fv[..., 2].amax(-1) >= 0).all()  # every face crosses z = 0
    covers = torch.isfinite(_pixel_z(fv, valid, size))
    assert covers.sum() > 0
    # Under perspective correction the fine rasterizer's selection covers
    # pixels outside these faces' bounding boxes; the hard one's does not.
    ids = trc.rasterize_fragments_plain(fv, valid, size, 0.0, 1, True, False)[0]
    n, r, c, _ = torch.nonzero(ids >= 0, as_tuple=True)
    b = _chip_smoke().face_pixel_boxes(fv, size, 0.0, False).view(*fv.shape[:2], 4)[n, ids[ids >= 0].long()]
    assert (~((r >= b[:, 0]) & (r <= b[:, 1]) & (c >= b[:, 2]) & (c <= b[:, 3]))).any()
    assert not (covers & ~_in_boxes(fv, size)).any()


def test_edge_cases_hit_the_box_edges():
    cs = _chip_smoke()
    size = (40, 56)
    fv, valid = _faces("edges", size)
    H, W = size
    ys, xs = trm.pixel_grid_ndc(H, W, CPU)
    xmin, xmax, ymin, ymax = trc.face_boxes(fv, size, 0.0)
    for lo, hi, centres in ((xmin, xmax, xs), (ymin, ymax, ys)):
        assert torch.isin(lo, centres).sum() >= 2 and torch.isin(hi, centres).sum() >= 2
    area = trm.edge_function(fv[..., 0, :2], fv[..., 1, :2], fv[..., 2, :2])
    assert (area.abs() <= 1e-8).any() and (area > 0).any() and (area < 0).any()  # both windings
    assert (fv[..., 2] < 0).any() and (fv[..., :2].abs() > 100).any()
    boxes = cs.face_pixel_boxes(fv, size, 0.0, False)
    assert ((boxes[:, 0] > boxes[:, 1]) | (boxes[:, 2] > boxes[:, 3])).any()  # boxes holding no centre


def test_chip_smoke_counts_the_hard_kernels_work():
    cs = _chip_smoke()
    size = (40, 56)
    fv, valid = _faces("edges", size)
    N, F = valid.shape
    H, W = size
    ok = trm._face_culls(fv, valid, False)
    pxy = trm.pixel_centers_ndc(H, W, CPU)
    x, y = fv[..., 0], fv[..., 1]
    px, py = pxy[..., 0].reshape(-1), pxy[..., 1].reshape(-1)
    inside = ((px >= x.amin(-1)[..., None]) & (px <= x.amax(-1)[..., None])
              & (py >= y.amin(-1)[..., None]) & (py <= y.amax(-1)[..., None]))  # (N, F, H*W)
    tests = float(inside[ok].sum())
    bound, by, got = cs.hard_bound(fv, valid, size)
    assert got == tests > 0
    assert bound == pytest.approx(1e3 * max((N * F * 36 + N * H * W * 20) / cs.PEAK_BYTES_PER_S,
                                            tests * cs.HARD_OPS_PER_CANDIDATE / cs.PEAK_FP32_OPS_PER_S))
    # The pairs the kernel tests: per (tile, face) pair of its binning, the
    # tile's pixels in the face's pixel box, by brute force.
    made, walked = cs.hard_tests(fv, valid, size)
    tile_faces, tile_start, n_ty, n_tx = trc.bin_faces(fv, ok, size, 0.0)
    b = cs.face_pixel_boxes(fv, size, 0.0, False).view(N, F, 4)
    TH, TW = trc.TILE
    want = 0
    for t in range(N * n_ty * n_tx):
        n, ty, tx = t // (n_ty * n_tx), (t // n_tx) % n_ty, t % n_tx
        r = torch.arange(ty * TH, min((ty + 1) * TH, H))[:, None]
        c = torch.arange(tx * TW, min((tx + 1) * TW, W))[None, :]
        for f in tile_faces[tile_start[t]:tile_start[t + 1]].tolist():
            r0, r1, c0, c1 = b[n, f].tolist()
            want += int(((r >= r0) & (r <= r1) & (c >= c0) & (c <= c1)).sum())
    assert made == want and tests <= made <= walked
    assert made < cs.tile_candidates(tile_start, N, n_ty, n_tx, size)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rmp.pl, "pallas_call", patched)


@pytest.mark.parametrize("image", [0, 1])
def test_cpu_wrapper_matches_plain_and_jax_hard_kernel(interpret_pallas, image):
    # The TPU kernel selects by the perspective-corrected z, the plain
    # version (the JAX package's CPU route) by the screen-space z: the two
    # agree on a mesh in front of the camera, not on faces crossing z = 0.
    size = (32, 32)  # interpret mode runs the TPU kernel's grid step by step
    fv, valid = _faces("ico", size)
    fv, valid = fv[image:image + 1], valid[image:image + 1]
    before = trc.rasterize_hard_cuda.launches
    got = trc.rasterize_hard_cuda(fv, valid, size)
    assert trc.rasterize_hard_cuda.launches == before
    for g, w in zip(got, trc.rasterize_hard_plain(fv, valid, size)):
        assert torch.equal(g, w)
    pix, zb, ba = (np.asarray(t).reshape(*size, -1)
                   for t in rmp.rasterize_hard_pallas(jnp.asarray(fv[0].numpy()), jnp.asarray(valid[0].numpy()), size))
    # The TPU kernel scales edge functions by a reciprocal where the plain
    # path divides: ids equal on >= 99.9 % of pixels, values within 1e-5
    # (z) and 1e-4 (bary) where they agree, as test_torch_opengl.py holds
    # the plain version.
    ids = got[0][0].numpy()
    same = ids == pix
    assert same.mean() >= 0.999 and (ids >= 0).any()
    hit = (same & (ids >= 0))[..., 0]
    np.testing.assert_allclose(got[1][0].numpy()[hit], zb[hit], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2][0, ..., 0, :].numpy()[hit], ba[hit], atol=1e-4, rtol=0)
