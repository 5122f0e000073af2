"""The points rasterizer's pixel-box cull, on the CPU.

The CUDA kernel (csrc/rasterize_points.cu, #5 and its select-only build
#6) tests a point only in the warps whose 4x8 pixel rectangle meets the
point's pixel box, which `chip_smoke.point_pixel_boxes` makes in torch: on
each axis the pixel centres whose own test fl(c - v)^2 < r * r passes.
Here,
on `chip_smoke.cull_edge_points`' adversarial inputs (centre +- r exactly
on a pixel centre, radius 0 and negative, discs over whole tiles, centres
on warp-rectangle and tile borders, off-image centres, images whose sides
are not multiples of the tile):

- every (pixel, point) the plain version covers lies in its point's pixel
  box and in one of the tiles the binning gives the point;
- each box is the brute-force run of centres passing the axis test;
- `chip_smoke.points_tests` counts the lanes the kernel walks as a brute
  force over the binning does;
- the CPU wrappers still equal the plain version, JAX's XLA selection and
  the JAX package's `_fine_kernel`, run in interpret mode (each where its
  rules are the plain version's: see the test).

Inputs are numpy arrays from a seed; the port runs on the CPU.
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

import pytorch3d_tpu.renderer.points.rasterize_points_pallas as rpp
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc
from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as tpc

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

jrp = importlib.import_module("pytorch3d_tpu.renderer.points.rasterize_points")
trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")
trp = importlib.import_module("pytorch3d_tpu_torch.renderer.points.rasterize_points")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batch(size):
    return _chip_smoke().cull_edge_batch(torch.device("cpu"), size)


_SIZES = [(40, 56), (48, 48), (37, 70)]


@pytest.mark.parametrize("size,K", [((40, 56), 8), ((48, 48), 1), ((37, 70), 16)])
def test_covered_pairs_lie_in_their_pixel_boxes_and_tiles(size, K):
    pts, rad, valid = _batch(size)
    N, P = valid.shape
    ids = trp.rasterize_points_plain(pts, rad, valid, size, K)[0]
    n, r, c, _ = torch.nonzero(ids >= 0, as_tuple=True)
    p = ids[ids >= 0]
    assert p.numel() > 100
    b = _chip_smoke().point_pixel_boxes(pts, rad, size).view(N, P, 4)[n, p].long()
    assert ((r >= b[:, 0]) & (r <= b[:, 1]) & (c >= b[:, 2]) & (c <= b[:, 3])).all()
    tile_points, tile_start, n_ty, n_tx = tpc.bin_points(pts, rad, valid, size)
    TH, TW = trc.TILE
    tile_of_pair = torch.repeat_interleave(torch.arange(tile_start.numel() - 1), tile_start.diff().long())
    binned = tile_of_pair * P + tile_points.long()
    tile = (n * n_ty + r // TH) * n_tx + c // TW
    assert torch.isin(tile * P + p, binned).all()


@pytest.mark.parametrize("size", _SIZES)
def test_pixel_boxes_are_the_centres_passing_each_axis_test(size):
    pts, rad, valid = _batch(size)
    H, W = size
    boxes = _chip_smoke().point_pixel_boxes(pts, rad, size).view(-1, 4)
    assert boxes.dtype == torch.int32
    ys, xs = trm.pixel_grid_ndc(H, W, torch.device("cpu"))
    r2 = (rad * rad).reshape(-1, 1)
    for centres, v, lo, hi in ((ys, pts[..., 1], boxes[:, 0], boxes[:, 1]), (xs, pts[..., 0], boxes[:, 2], boxes[:, 3])):
        d = centres[None, :] - v.reshape(-1, 1)
        passes = d * d < r2  # (N * P, n): a run on each row
        index = torch.arange(centres.numel())
        hit = passes.any(-1)
        assert torch.equal(lo[hit].long(), torch.where(passes, index, centres.numel()).amin(-1)[hit])
        assert torch.equal(hi[hit].long(), torch.where(passes, index, -1).amax(-1)[hit])
        assert (lo[~hit] > hi[~hit]).all()  # empty where no centre passes
        assert (passes.sum(-1) == (hi - lo + 1).clamp(min=0)).all()  # one run
    # The edge cases reach both kinds of box: empty ones, and ones wider
    # than two tiles.
    assert (boxes[:, 0] > boxes[:, 1]).any() and (boxes[:, 3] - boxes[:, 2] >= 32).any()


def test_exact_ends_fail_the_strict_test():
    # A point on a pixel centre with x - r exactly on another column's
    # centre: the plain version leaves that column out, and so does its box.
    size = (40, 56)
    pts, rad, valid = _chip_smoke().cull_edge_points(size, 0, 40)
    ys, xs = (t.numpy() for t in trm.pixel_grid_ndc(*size, torch.device("cpu")))
    on_col = np.isin(pts[:, 0], xs) & np.isin(pts[:, 1], ys)
    ends = 0
    boxes = _chip_smoke().point_pixel_boxes(torch.from_numpy(pts)[None], torch.from_numpy(rad)[None], size)
    for i in np.nonzero(on_col & (rad != 0))[0]:
        d = xs - pts[i, 0]
        end = np.nonzero(d * d == rad[i] * rad[i])[0]
        for c in end:
            ends += 1
            assert not boxes[i, 2] <= c <= boxes[i, 3]
    assert ends >= 20


def test_chip_smoke_counts_the_lanes_the_points_kernel_walks():
    cs = _chip_smoke()
    source = (pathlib.Path(tpc.__file__).resolve().parents[2] / "csrc" / "rasterize_points.cu").read_text()
    assert f"kRectH = {cs.FINE_RECT[0]};" in source and f"kRectW = {cs.FINE_RECT[1]};" in source
    size = (37, 70)
    pts, rad, valid = _batch(size)
    N, P = valid.shape
    H, W = size
    bins = tpc.bin_points(pts, rad, valid, size)
    made, walked = cs.points_tests(pts, rad, bins, size)
    tile_points, tile_start, n_ty, n_tx = bins
    TH, TW = trc.TILE
    RH, RW = cs.FINE_RECT
    b = cs.point_pixel_boxes(pts, rad, size).view(N, P, 4)
    want_made = want_walked = 0
    for t in range(N * n_ty * n_tx):
        n, ty, tx = t // (n_ty * n_tx), (t // n_tx) % n_ty, t % n_tx
        r = torch.arange(ty * TH, min((ty + 1) * TH, H))[:, None]
        c = torch.arange(tx * TW, min((tx + 1) * TW, W))[None, :]
        for p in tile_points[tile_start[t]:tile_start[t + 1]].tolist():
            r0, r1, c0, c1 = b[n, p].tolist()
            want_made += int(((r >= r0) & (r <= r1) & (c >= c0) & (c <= c1)).sum())
            for wr in range(ty * TH, (ty + 1) * TH, RH):
                for wc in range(tx * TW, (tx + 1) * TW, RW):
                    meets = r0 <= r1 and c0 <= c1 and r0 < wr + RH and r1 >= wr and c0 < wc + RW and c1 >= wc
                    want_walked += 32 * meets
    assert (made, walked) == (want_made, want_walked)
    assert 0 < made <= walked < cs.tile_candidates(tile_start, N, n_ty, n_tx, size)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rpp.pl, "pallas_call", patched)


@pytest.mark.parametrize("K", [1, 5])
def test_cpu_wrappers_match_plain_and_jax_fine_kernel(interpret_pallas, K):
    size = (24, 40)  # interpret mode runs the TPU kernel's grid step by step
    pts, rad, valid = _chip_smoke().cull_edge_points(size, 2, 12)
    p, r, v = torch.from_numpy(pts), torch.from_numpy(rad), torch.from_numpy(valid)
    before = (tpc.rasterize_points_cuda.launches, tpc.select_points_cuda.launches)
    got = tpc.rasterize_points_cuda(p[None], r[None], v[None], size, K)
    ids = tpc.select_points_cuda(p, r, v, size, K)
    assert (tpc.rasterize_points_cuda.launches, tpc.select_points_cuda.launches) == before
    plain = trp.rasterize_points_plain(p[None], r[None], v[None], size, K)
    assert all(torch.equal(g, w) for g, w in zip(got, plain)) and torch.equal(ids, plain[0][0])

    # Exact ends put d2 on r * r, where the two packages' pixel centres and
    # sums may differ by an ulp: they stay with the plain version alone.
    ys, xs = (t.numpy() for t in trm.pixel_grid_ndc(*size, torch.device("cpu")))
    keep = ~(np.isin(pts[:, 0], xs) & np.isin(pts[:, 1], ys))
    pts, rad, valid = pts[keep], rad[keep], valid[keep]
    assert (rad < 0).any() and (rad == 0).any()

    def port(pts, rad):
        t = (torch.from_numpy(a)[None] for a in (pts, rad, valid))
        return [o[0].numpy() for o in tpc.rasterize_points_cuda(*t, size, K)]

    # JAX's XLA selection takes the same inputs, negative radii and ties in
    # z among them.
    got = port(pts, rad)
    assert (got[0] >= 0).sum() > 50
    want_ids = jrp.rasterize_points_topk_xla(jnp.asarray(pts), jnp.asarray(rad), jnp.asarray(valid), size, K)
    np.testing.assert_array_equal(got[0], np.asarray(want_ids))
    # The Pallas `_fine_kernel` (rasterize_points_pallas.py:285, pallas_call
    # :497) orders equal z by its binning's list order, not by id, and its
    # binning (`_tile_axis_masks`, :38-70) drops a negative radius: it gets
    # |r| and z made distinct by a seeded jitter.
    pts = pts.copy()
    pts[:, 2] += np.random.default_rng(3).uniform(0.0, 0.2, len(pts)).astype(np.float32)
    rad = np.abs(rad)
    got = port(pts, rad)
    want = rpp.rasterize_points_fragments_pallas(jnp.asarray(pts), jnp.asarray(rad), jnp.asarray(valid), size, K)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-6, rtol=0)
