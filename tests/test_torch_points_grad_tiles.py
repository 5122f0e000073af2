"""The points rasterizer backward's tile decomposition, on the CPU.

The CUDA backward (csrc/rasterize_points_grad.cu, #7) sums each filled
slot's partials per (tile, point) pair of the forward's binning into a row
of a (pairs, 3) table, kListChunk list positions a pass, then adds each
point's rows in ascending tile order through a point-major CSR of the rows
(`face_pair_rows`, shared with the mesh backward).  Here, on seeded clouds
(radii per point, some points behind the camera or not valid, images whose
sides are not multiples of the tile):

- that CSR, built in torch, equals a brute-force transpose of `bin_points`'
  tile lists;
- every point id of the forward's idx lies in its tile's list (so no row
  of the kernel's gradient turns NaN on the autograd path);
- per-tile rows (the plain backward with the cotangents of one tile at a
  time, each list cut into passes of a few positions as the kernel cuts
  long lists) added per point in the CSR's order give the plain backward;
- `rasterize_points_grad_cuda` on CPU tensors, taking the binning, equals
  the plain backward and the VJP through the JAX package's `_grad_kernel`
  in interpret mode;
- chip_smoke.py's points-bench binning has lists that pass 1 sums in at
  least two passes, of the list length the kernel's source cuts at.

Inputs are numpy arrays from a seed, handed to both packages; the port
runs on the CPU.
"""

import functools
import importlib
import importlib.util
import pathlib
import re

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer.points.rasterize_points_pallas as rpp
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc
from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as tpc

trp = importlib.import_module("pytorch3d_tpu_torch.renderer.points.rasterize_points")

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _clouds(seed, N, P, rlo, rhi):
    """(N, P, 3) points in [-1.1, 1.1]^2 with z from -0.2 up, (N, P) radii
    in [rlo, rhi] and a valid mask with holes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.1, 1.1, (N, P, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) * 2.0 - 0.2
    rad = rng.uniform(rlo, rhi, (N, P)).astype(np.float32)
    valid = np.arange(P)[None] % 9 != (np.arange(N)[:, None] + 1)
    return torch.from_numpy(pts), torch.from_numpy(rad), torch.from_numpy(valid)


def _cotangents(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))


def _tile_of_pair(tile_start):
    counts = tile_start.diff().long()
    return torch.repeat_interleave(torch.arange(counts.numel()), counts)


_SETTINGS = [
    # seed, N, P, radius range, size, K
    (0, 2, 400, (0.02, 0.08), (40, 56), 4),
    (1, 3, 250, (0.05, 0.2), (48, 48), 8),
    (2, 1, 600, (0.01, 0.04), (37, 70), 2),
]


def _setting(seed, N, P, radius, size, K):
    pts, rad, valid = _clouds(seed, N, P, *radius)
    idx = trp.rasterize_points_plain(pts, rad, valid, size, K)[0].int()
    return pts, rad, valid, idx, tpc.bin_points(pts, rad, valid, size)


@pytest.mark.parametrize("seed,N,P,radius,size,K", _SETTINGS)
def test_pair_rows_are_the_transpose_of_the_tile_lists(seed, N, P, radius, size, K):
    pts, rad, valid, _, (tile_points, tile_start, n_ty, n_tx) = _setting(seed, N, P, radius, size, K)
    pair_rows, point_start = trc.face_pair_rows(tile_points, tile_start, N, P)
    owner = (_tile_of_pair(tile_start) // (n_ty * n_tx)) * P + tile_points.long()
    assert point_start.dtype == torch.int32 and pair_rows.dtype == torch.int32
    assert point_start[0] == 0 and point_start[-1] == tile_points.numel() > 0
    brute = [[] for _ in range(N * P)]
    for q, g in enumerate(owner.tolist()):  # pairs in tile-major order
        brute[g].append(q)
    starts = point_start.tolist()
    assert [pair_rows[starts[g]:starts[g + 1]].tolist() for g in range(N * P)] == brute


@pytest.mark.parametrize("seed,N,P,radius,size,K", _SETTINGS)
def test_forward_ids_lie_in_their_tiles_lists(seed, N, P, radius, size, K):
    pts, rad, valid, idx, (tile_points, tile_start, n_ty, n_tx) = _setting(seed, N, P, radius, size, K)
    H, W = size
    binned = _tile_of_pair(tile_start) * P + tile_points.long()
    rows = torch.arange(H)[:, None] // trc.TILE[0]
    cols = torch.arange(W)[None, :] // trc.TILE[1]
    tile = (torch.arange(N)[:, None, None] * n_ty + rows) * n_tx + cols
    keys = (tile[..., None] * P + idx)[idx >= 0]
    assert keys.numel() > 0 and torch.isin(keys, binned).all()


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("seed,N,P,radius,size,K", _SETTINGS[:2])
def test_tile_rows_added_per_point_give_the_plain_backward(seed, N, P, radius, size, K, chunk):
    pts, rad, valid, idx, (tile_points, tile_start, n_ty, n_tx) = _setting(seed, N, P, radius, size, K)
    H, W = size
    TH, TW = trc.TILE
    gz, gd = _cotangents(idx.shape, seed + 7)
    table = torch.zeros((tile_points.numel(), 3))
    for t in range(N * n_ty * n_tx):  # pass 1: one tile's cotangents at a time
        n, ty, tx = t // (n_ty * n_tx), (t // n_tx) % n_ty, t % n_tx
        mask = torch.zeros((N, H, W, 1), dtype=torch.bool)
        mask[n, ty * TH:(ty + 1) * TH, tx * TW:(tx + 1) * TW] = True
        lo, hi = int(tile_start[t]), int(tile_start[t + 1])
        listed = tile_points[lo:hi].long()
        for c0 in range(lo, max(hi, lo + 1), chunk):  # the kernel's passes over a long list
            first = int(tile_points[c0]) if c0 > lo else -1
            last = int(tile_points[c0 + chunk]) if c0 + chunk < hi else P  # exclusive
            take = mask & (idx >= first) & (idx < last)
            part = trp.rasterize_points_grad_plain(
                pts, idx, torch.where(take, gz, 0.0), torch.where(take, gd, 0.0), size)[n]
            rows = slice(c0, min(c0 + chunk, hi))
            table[rows] = part[tile_points[rows].long()]
            others = torch.ones(P, dtype=torch.bool)
            others[listed] = False
            assert (part[others] == 0).all()  # nothing outside the tile's list
    pair_rows, point_start = trc.face_pair_rows(tile_points, tile_start, N, P)
    got = torch.zeros((N * P, 3))
    for g in range(N * P):  # pass 2: the point's rows in ascending tile order
        for q in pair_rows[point_start[g]:point_start[g + 1]].tolist():
            got[g] += table[q]
    want = trp.rasterize_points_grad_plain(pts, idx, gz, gd, size).reshape(N * P, 3)
    scale = want.abs().max()
    assert scale > 0 and (want != 0).any(-1).sum() > 50
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(scale))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rpp.pl, "pallas_call", patched)


@pytest.mark.parametrize("cotangents", ["both", "dists only"])
def test_cpu_wrapper_matches_plain_and_jax_grad_kernel(interpret_pallas, cotangents):
    size, K = (32, 32), 4  # interpret mode runs the TPU kernel's grid step by step
    pts, rad, valid = _clouds(5, 1, 300, 0.03, 0.1)
    pj, rj, vj = (jnp.asarray(t[0].numpy()) for t in (pts, rad, valid))

    def fragments(p):
        idx, zbuf, dists = rpp.rasterize_points_fragments_pallas(p, rj, vj, size, K)
        return (zbuf, dists), idx

    _, vjp, idx = jax.vjp(fragments, pj, has_aux=True)
    ids = torch.from_numpy(np.array(idx))[None].int()
    gz, gd = _cotangents(ids.shape, 11)
    if cotangents == "dists only":
        gz = None
    before = tpc.rasterize_points_grad_cuda.launches
    bins = tpc.bin_points(pts, rad, valid, size)  # ignored on the CPU
    got = tpc.rasterize_points_grad_cuda(pts, ids, gz, gd, size, bins)
    assert tpc.rasterize_points_grad_cuda.launches == before
    assert torch.equal(got, trp.rasterize_points_grad_plain(pts, ids, gz, gd, size))
    gzj = jnp.zeros(ids.shape[1:], jnp.float32) if gz is None else jnp.asarray(gz[0].numpy())
    (want,) = vjp((gzj, jnp.asarray(gd[0].numpy())))
    # Per-point sums in another order (tests/test_torch_points.py's bound).
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    assert (np.abs(np.asarray(want)) > 0).any(-1).sum() > 50


def test_chip_smoke_long_list_case_takes_several_passes():
    cs = _chip_smoke()
    source = (pathlib.Path(tpc.__file__).resolve().parents[2] / "csrc" / "rasterize_points_grad.cu").read_text()
    assert int(re.search(r"constexpr int kListChunk = (\d+);", source).group(1)) == cs.POINTS_GRAD_LIST_CHUNK
    size = (cs.PTS_IMAGE, cs.PTS_IMAGE)
    pts = cs.bench_points(CPU)
    bins = tpc.bin_points(pts, *cs.uniform_radius(pts, cs.BENCH_RADIUS), size)
    longest, passes = cs.longest_list(bins, cs.POINTS_GRAD_LIST_CHUNK)
    assert passes >= 2 and longest > cs.POINTS_GRAD_LIST_CHUNK, longest
