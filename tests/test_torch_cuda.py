"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere (a CUDA kernel has no CPU
mode; the CPU tests hold the plain versions against the JAX package).  They
import no JAX, so they run on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py -q
"""

import importlib
import importlib.util
import pathlib

import pytest
import torch

from pytorch3d_tpu_torch.ops import knn as tknn
from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, MeshRasterizer, look_at_view_transform
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc
from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as tpc
from pytorch3d_tpu_torch.structures import Meshes, Pointclouds
from pytorch3d_tpu_torch.utils import ico_sphere, torus


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch_faces(device, image_size, aspect_ratio=1.0):
    """(2, F, 3, 3) NDC face verts of ico_sphere(3) and a torus (different
    face counts, so the second image has padding) and their valid mask."""
    ico, tor = ico_sphere(3, device=device), torus(0.4, 1.2, 16, 32, device=device)
    mesh = Meshes.create(
        ico.verts_list() + tor.verts_list(), ico.faces_list() + tor.faces_list(), device=device
    )
    R, T = look_at_view_transform(2.7, 15.0, 20.0, device=device)
    cams = FoVPerspectiveCameras.create(R=R, T=T, aspect_ratio=aspect_ratio, device=device)
    ndc = MeshRasterizer(cams).transform(mesh)
    N, F = len(ndc), ndc.max_faces
    fv = ndc.verts_packed()[ndc.faces_packed()].reshape(N, F, 3, 3).contiguous()
    return fv, ndc.faces_packed_mask().reshape(N, F)


trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")
trp = importlib.import_module("pytorch3d_tpu_torch.renderer.points.rasterize_points")


def _load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_CHIP_SMOKE = _load_chip_smoke()

_GRID = [
    ((128, 128), 1e-4, 8, True, True, False),
    ((128, 128), 0.0, 1, True, False, False),
    ((128, 128), 1e-4, 8, True, True, True),
    ((96, 128), 1e-4, 3, False, False, False),
    ((128, 128), 4e-3, 40, True, True, False),
]


@pytest.mark.parametrize("size,blur,K,persp,clip,cull", _GRID)
def test_fine_kernel_matches_plain(cuda_device, size, blur, K, persp, clip, cull):
    fv, valid = _batch_faces(cuda_device, size, aspect_ratio=size[1] / size[0])
    before = trc.rasterize_fragments_cuda.launches
    got = trc.rasterize_fragments_cuda(fv, valid, size, blur, K, persp, clip, cull)
    torch.cuda.synchronize()
    assert trc.rasterize_fragments_cuda.launches == before + 1
    want = trc.rasterize_fragments_plain(fv, valid, size, blur, K, persp, clip, cull)
    same = got[0].long() == want[0]
    # bench.py:_row_ok's tolerances for a kernel against its oracle, with
    # dists held at 1e-6 (as chip_smoke.py does): with blur 1e-4 most
    # filled slots hold |dist| < 1e-4, so 1e-4 would pass a zero or a wrong
    # sign; the two agree to ~2e-9 on an H100.
    assert same.float().mean() > 0.999, same.float().mean()
    assert (got[1] - want[1]).abs()[same].max() < 5e-3
    assert (got[2] - want[2]).abs()[same[..., None].expand_as(got[2])].max() <= 1e-4
    assert (got[3] - want[3]).abs()[same].max() <= 1e-6


def _cotangents(like_z, like_bary, seed=0):
    gen = torch.Generator(device=like_z.device).manual_seed(seed)
    return tuple(
        torch.randn(t.shape, generator=gen, device=t.device) for t in (like_z, like_bary, like_z)
    )


def _exact_grad(fv, idx, cots, size, persp, clip):
    """The plain version in float64 on the same ids and cotangents."""
    return trm.rasterize_grad_plain(
        fv.double(), idx, *(None if c is None else c.double() for c in cots), size, persp, clip
    )


def _grad_close(got, want, exact):
    # The kernel (per tile, then per face) and index_add_ (plain, atomics on
    # the card) sum per-pixel terms in different orders: within 1e-4 of the
    # largest gradient, as in chip_smoke.py.
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert scale > 0 and err <= 1e-4 * scale, (err, scale)
    # The largest gradient is heavy-tailed (sliver faces), so per face too,
    # against the float64 plain version: chip_smoke.py's gate.
    kernel_share, plain_share = _CHIP_SMOKE.face_agreement(got, want, exact)
    assert kernel_share >= _CHIP_SMOKE.GRAD_FACE_SHARE, (kernel_share, plain_share)


@pytest.mark.parametrize("size,blur,K,persp,clip,cull", _GRID)
def test_grad_kernel_matches_plain(cuda_device, size, blur, K, persp, clip, cull):
    fv, valid = _batch_faces(cuda_device, size, aspect_ratio=size[1] / size[0])
    idx, zbuf, bary, _ = trc.rasterize_fragments_cuda(fv, valid, size, blur, K, persp, clip, cull)
    bins = trc.bin_faces(fv, trm._face_culls(fv, valid, cull), size, blur)  # the forward's binning
    gz, gbary, gdists = _cotangents(zbuf, bary)
    before = trc.rasterize_grad_cuda.launches
    got = trc.rasterize_grad_cuda(fv, idx, gz, gbary, gdists, size, bins, persp, clip)
    torch.cuda.synchronize()
    assert trc.rasterize_grad_cuda.launches == before + 1
    want = trm.rasterize_grad_plain(fv, idx, gz, gbary, gdists, size, persp, clip)
    _grad_close(got, want, _exact_grad(fv, idx, (gz, gbary, gdists), size, persp, clip))
    # A missing cotangent is zero.
    _grad_close(
        trc.rasterize_grad_cuda(fv, idx, None, None, gdists, size, bins, persp, clip),
        trm.rasterize_grad_plain(fv, idx, None, None, gdists, size, persp, clip),
        _exact_grad(fv, idx, (None, None, gdists), size, persp, clip),
    )


def test_backward_through_the_cuda_path_launches_the_grad_kernel(cuda_device):
    fv, valid = _batch_faces(cuda_device, (128, 128))

    def loss(bin_size):  # bench.py:110-119: rasterize_meshes' defaults, no perspective or clip
        verts = fv.clone().requires_grad_(True)
        rasterize = trc.rasterize_fragments_plain if bin_size == 0 else trc.rasterize_fragments_cuda
        idx, zbuf, _, dists = rasterize(verts, valid, (128, 128), 1e-4, 8, False, False, False)
        (torch.sum(torch.sigmoid(-dists / 1e-4)) * 1e-6 + torch.sum(zbuf) * 1e-6).backward()
        return verts.grad, idx, dists.detach()

    fine, grad = trc.rasterize_fragments_cuda.launches, trc.rasterize_grad_cuda.launches
    got, idx, dists = loss(None)
    assert trc.rasterize_fragments_cuda.launches == fine + 1
    assert trc.rasterize_grad_cuda.launches == grad + 1
    # The loss's cotangents: 1e-6 for zbuf, d/d dists of the sigmoid term.
    s = torch.sigmoid(-dists / 1e-4)
    cots = (torch.full_like(dists, 1e-6), None, -(1e-6 / 1e-4) * s * (1.0 - s))
    _grad_close(got, loss(0)[0], _exact_grad(fv, idx, cots, (128, 128), False, False))


@pytest.mark.parametrize("K,norm,lengths", [
    (1, 2, False), (4, 2, True), (16, 2, True), (1, 1, False), (4, 1, True), (16, 1, False),
])
def test_knn_kernel_matches_plain(cuda_device, K, norm, lengths):
    gen = torch.Generator(device=cuda_device).manual_seed(K + 10 * norm)
    p1 = torch.rand((2, 700, 3), generator=gen, device=cuda_device)
    p2 = torch.rand((2, 900, 3), generator=gen, device=cuda_device)
    l2 = torch.tensor([900, 10], device=cuda_device) if lengths else None
    before = tknn.knn_points_cuda.launches
    d, i = tknn.knn_points_cuda(p1, p2, l2, K, norm)
    torch.cuda.synchronize()
    assert tknn.knn_points_cuda.launches == before + 1
    dp, ip = tknn.knn_points_plain(p1, p2, l2, K, norm)
    # The same sums in the same order, the same tie rule: ids equal, dists
    # equal to rounding (both built without FMA contraction).
    assert torch.equal(i, ip)
    assert torch.allclose(d, dp, rtol=1e-6, atol=0.0)
    # Through the public entry: empty slots (K > length2) zero-filled.
    out = tknn.knn_points(p1, p2, lengths2=l2, K=K, norm=norm)
    assert tknn.knn_points_cuda.launches == before + 2
    if lengths:
        assert (out.dists[1, :, 10:] == 0).all() and (out.idx[1, :, 10:] == 0).all()


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("K", [1, 2, 4, 8, 16])
def test_knn_kernel_splits_and_merges_as_one_walk(cuda_device, K, split):
    """One range (S = 1, no merge) or several, with every database point
    repeated one range length on and half the queries on database points:
    the lower id must win each tie, as in the plain version."""
    P1, P2 = 3000, (6000 if split else 100)
    S, L = tknn.kernel_ranges(1, P1, P2, K, cuda_device)
    assert (S > 1) == split
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    p2 = torch.rand((1, P2, 3), generator=gen, device=cuda_device)
    if split:
        p2[:, L:] = p2[:, : P2 - L].clone()
    p1 = torch.rand((1, P1, 3), generator=gen, device=cuda_device)
    p1[:, : P1 // 2] = p2[:, torch.randint(0, P2, (P1 // 2,), generator=gen, device=cuda_device)]
    before = tknn.knn_points_cuda.launches
    d, i = tknn.knn_points_cuda(p1, p2.contiguous(), None, K)
    torch.cuda.synchronize()
    assert tknn.knn_points_cuda.launches == before + 1  # one call, one count, one stage or two
    dp, ip = tknn.knn_points_plain(p1, p2, None, K)
    assert torch.equal(i, ip)
    assert torch.equal(d, dp)


def _grad_inputs(device, size=(128, 128), blur=1e-4, K=8, fv_valid=None):
    fv, valid = _batch_faces(device, size) if fv_valid is None else fv_valid
    idx, zbuf, bary, _ = trc.rasterize_fragments_cuda(fv, valid, size, blur, K, True, True)
    bins = trc.bin_faces(fv, trm._face_culls(fv, valid, False), size, blur)  # the forward's binning
    return fv, idx, _cotangents(zbuf, bary), bins


def test_grad_kernel_gives_the_same_bits_twice(cuda_device):
    fv, idx, cots, bins = _grad_inputs(cuda_device)
    first = trc.rasterize_grad_cuda(fv, idx, *cots, (128, 128), bins, True, True)
    second = trc.rasterize_grad_cuda(fv, idx, *cots, (128, 128), bins, True, True)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def _dense_faces(device, size, level):
    """(1, F, 3, 3) NDC face verts of ico_sphere(level) filling a small image."""
    mesh = ico_sphere(level, device=device)
    R, T = look_at_view_transform(2.7, 20.0, 30.0, device=device)
    ndc = MeshRasterizer(FoVPerspectiveCameras.create(R=R, T=T, device=device)).transform(mesh)
    F = ndc.max_faces
    return ndc.verts_packed()[ndc.faces_packed()].reshape(1, F, 3, 3).contiguous(), torch.ones(
        (1, F), dtype=torch.bool, device=device)


@pytest.mark.parametrize("level,size,blur,K", [(4, (32, 32), 1e-4, 8), (3, (64, 64), 2e-2, 16)])
def test_grad_kernel_sums_tile_lists_longer_than_one_pass(cuda_device, level, size, blur, K):
    """A dense mesh at a small image, and a large blur: tile lists several
    times GRAD_LIST_CHUNK long, which pass 1 sums in several passes."""
    fv, idx, cots, bins = _grad_inputs(cuda_device, size, blur, K, _dense_faces(cuda_device, size, level))
    longest, passes = _CHIP_SMOKE.longest_list(bins)
    assert passes >= 3, longest
    first = trc.rasterize_grad_cuda(fv, idx, *cots, size, bins, True, True)
    second = trc.rasterize_grad_cuda(fv, idx, *cots, size, bins, True, True)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    want = trm.rasterize_grad_plain(fv, idx, *cots, size, True, True)
    _grad_close(first, want, _exact_grad(fv, idx, cots, size, True, True))


def test_grad_kernel_raises_on_a_face_missing_from_its_tile_list(cuda_device):
    fv, idx, cots, bins = _grad_inputs(cuda_device)
    tile_faces, tile_start, n_ty, n_tx = bins
    n, y, x, k = (int(v) for v in (idx >= 0).nonzero()[0])
    tile = (n * n_ty + y // trc.TILE[0]) * n_tx + x // trc.TILE[1]
    lo, hi = int(tile_start[tile]), int(tile_start[tile + 1])
    drop = lo + int((tile_faces[lo:hi] == idx[n, y, x, k]).nonzero()[0])
    faces = torch.cat([tile_faces[:drop], tile_faces[drop + 1:]])
    start = torch.where(torch.arange(tile_start.numel(), device=cuda_device) > tile, tile_start - 1, tile_start)
    with pytest.raises(RuntimeError, match="missing from its tile's list"):
        trc.rasterize_grad_cuda(fv, idx, *cots, (128, 128), (faces, start.int(), n_ty, n_tx), True, True)


@pytest.mark.parametrize("level,size,blur,K", [(5, (64, 64), 1e-4, 8), (4, (128, 128), 2e-2, 16)])
def test_fine_kernel_walks_tile_lists_of_several_staging_chunks(cuda_device, level, size, blur, K):
    """A dense mesh at a small image, and a large blur: tile lists longer
    than the 256 faces a block of the fine kernel stages at once."""
    fv, valid = _dense_faces(cuda_device, size, level)
    bins = trc.bin_faces(fv, trm._face_culls(fv, valid, False), size, blur)
    assert int(bins[1].diff().max()) > 2 * 256
    frac, err, covered = _CHIP_SMOKE.compare_fine(fv, valid, size, blur, K, True, True, False)
    assert _CHIP_SMOKE.row_ok(frac, err) and covered > 0, (frac, err)
    got = trc.rasterize_fragments_cuda(fv, valid, size, blur, K, True, True)
    assert torch.equal(trc.rasterize_topk_cuda(fv[0], valid[0], size, blur, K, True, True), got[0][0])


def test_each_cuda_call_counts_its_launch(cuda_device):
    fv, valid = _batch_faces(cuda_device, (32, 32))
    counters = (trc.rasterize_fragments_cuda, trc.rasterize_grad_cuda, tknn.knn_points_cuda)
    before = [c.launches for c in counters]
    idx, zbuf, bary, dists = trc.rasterize_fragments_cuda(fv, valid, (32, 32), 1e-4, 4)
    trc.rasterize_grad_cuda(fv, idx, zbuf, bary, dists, (32, 32), trc.bin_faces(fv, valid, (32, 32), 1e-4))
    tknn.knn_points_cuda(fv[:, :, 0].contiguous(), fv[:, :, 1].contiguous(), None, 2)
    assert [c.launches for c in counters] == [b + 1 for b in before]


def test_fine_kernel_refuses_what_it_does_not_take(cuda_device):
    fv, valid = _batch_faces(cuda_device, (32, 32))
    with pytest.raises(ValueError):
        trc.rasterize_fragments_cuda(fv, valid, (32, 32), 1e-4, trc.MAX_FACES_PER_PIXEL + 1)
    with pytest.raises(TypeError):
        trc.rasterize_fragments_cuda(fv.double(), valid, (32, 32), 1e-4, 4)
    with pytest.raises(ValueError):
        trc.rasterize_fragments_cuda(fv.transpose(2, 3), valid, (32, 32), 1e-4, 4)  # not contiguous

    idx, zbuf, bary, dists = trc.rasterize_fragments_cuda(fv, valid, (32, 32), 1e-4, 4)
    bins = trc.bin_faces(fv, valid, (32, 32), 1e-4)
    with pytest.raises(TypeError):
        trc.rasterize_grad_cuda(fv.double(), idx, zbuf, bary, dists, (32, 32), bins)
    with pytest.raises(TypeError):
        trc.rasterize_grad_cuda(fv, idx.long(), zbuf, bary, dists, (32, 32), bins)
    with pytest.raises(ValueError):
        trc.rasterize_grad_cuda(fv, idx, zbuf.transpose(1, 2), bary, dists, (32, 32), bins)  # not contiguous
    with pytest.raises(ValueError):
        trc.rasterize_grad_cuda(fv, idx, zbuf, bary, dists, (32, 32), trc.bin_faces(fv, valid, (64, 64), 1e-4))


def test_knn_kernel_refuses_what_it_does_not_take(cuda_device):
    p = torch.rand((1, 64, 3), device=cuda_device)
    with pytest.raises(TypeError):
        tknn.knn_points_cuda(p.double(), p.double(), None, 1)
    with pytest.raises(ValueError):
        tknn.knn_points_cuda(p.transpose(1, 2), p.transpose(1, 2), None, 1)  # not contiguous
    wide = torch.rand((1, 64, tknn.MAX_D + 1), device=cuda_device)
    with pytest.raises(ValueError):
        tknn.knn_points_cuda(wide, wide, None, 1)
    with pytest.raises(ValueError):
        tknn.knn_points_cuda(p, p, None, tknn.MAX_K + 1)
    # knn_points takes the plain version outside the kernel's limits.
    before = tknn.knn_points_cuda.launches
    out = tknn.knn_points(wide, wide, K=tknn.MAX_K + 1)
    assert tknn.knn_points_cuda.launches == before and out.idx.shape == (1, 64, tknn.MAX_K + 1)


def _points(device, P=3000, radius=0.02, seed=0):
    """Two clouds (P and 2P/3 live points, the rest padding) in NDC xy with
    view z, some behind the camera; (N, P) radius and valid mask."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand((2, P, 3), generator=gen, device=device) * 2.4 - 1.2
    pts[..., 2] = pts[..., 2].abs() * 2.0 - 0.2
    rad = torch.full((2, P), float(radius), device=device)
    valid = torch.arange(P, device=device)[None] < torch.tensor([P, 2 * P // 3], device=device)[:, None]
    return pts, rad, valid


_POINTS_GRID = [
    ((128, 128), 0.02, 8),
    ((128, 128), 0.0, 1),
    ((128, 128), 0.3, 50),
    ((96, 128), 0.02, 1),
    ((128, 80), 0.3, 8),
    ((96, 128), 0.0, 50),
]


@pytest.mark.parametrize("size,radius,K", _POINTS_GRID)
def test_points_kernel_matches_plain(cuda_device, size, radius, K):
    pts, rad, valid = _points(cuda_device, radius=radius)
    rad[:, ::3] *= 0.5  # a per-point radius
    before = tpc.rasterize_points_cuda.launches
    got = tpc.rasterize_points_cuda(pts, rad, valid, size, K)
    torch.cuda.synchronize()
    assert tpc.rasterize_points_cuda.launches == before + 1
    want = trp.rasterize_points_plain(pts, rad, valid, size, K)
    # The plain version's arithmetic in its order, the same tie rule: ids
    # equal, zbuf and dists equal to rounding (both without FMA contraction).
    assert torch.equal(got[0].long(), want[0])
    assert (got[1] - want[1]).abs().max() <= 1e-6
    assert (got[2] - want[2]).abs().max() <= 1e-6
    if radius == 0.0:
        assert (got[0] == -1).all()


@pytest.mark.parametrize("size,K", [((120, 200), 8), ((120, 200), 16), ((40, 56), 5), ((37, 70), 1)])
def test_points_kernels_match_plain_at_the_cull_edges(cuda_device, size, K):
    # chip_smoke.cull_edge_points: centre +- r exactly on a pixel centre,
    # radius 0 and < 0, discs over tiles, centres on warp-rectangle and tile
    # borders, off-image centres, ties in z, sides not multiples of 16.
    pts, rad, valid = _CHIP_SMOKE.cull_edge_batch(cuda_device, size)
    before = (tpc.rasterize_points_cuda.launches, tpc.select_points_cuda.launches)
    got = tpc.rasterize_points_cuda(pts, rad, valid, size, K)
    ids = tpc.select_points_cuda(pts[0].contiguous(), rad[0].contiguous(), valid[0].contiguous(), size, K)
    torch.cuda.synchronize()
    assert (tpc.rasterize_points_cuda.launches, tpc.select_points_cuda.launches) == (before[0] + 1, before[1] + 1)
    want = trp.rasterize_points_plain(pts, rad, valid, size, K)
    assert torch.equal(got[0].long(), want[0]) and torch.equal(ids.long(), want[0][0])
    assert (got[1] - want[1]).abs().max() <= 1e-6
    assert (got[2] - want[2]).abs().max() <= 1e-6
    assert (want[0] >= 0).sum() > 1000


def _point_grad_close(got, want, exact):
    # The kernel (per tile, then per point in tile order) and index_add_
    # (plain) sum per-pixel terms in other orders: per point within 1e-5 of
    # its own scale, against the float64 plain version (chip_smoke.py's gate).
    assert torch.isfinite(got).all()
    err = float((got.double() - exact).abs().max())
    assert err <= _CHIP_SMOKE.POINT_GRAD_GATE * float(exact.abs().max()), err
    kernel_share, plain_share = _CHIP_SMOKE.row_agreement(got, want, exact, 3, _CHIP_SMOKE.POINT_GRAD_GATE)
    assert kernel_share >= _CHIP_SMOKE.POINT_GRAD_SHARE, (kernel_share, plain_share)


@pytest.mark.parametrize("size,radius,K", _POINTS_GRID[:3] + _POINTS_GRID[4:5])
def test_points_grad_kernel_matches_plain(cuda_device, size, radius, K):
    pts, rad, valid = _points(cuda_device, radius=radius or 0.05)
    idx, zbuf, _ = tpc.rasterize_points_cuda(pts, rad, valid, size, K)
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    gz, gd = (torch.randn(zbuf.shape, generator=gen, device=cuda_device) for _ in range(2))
    bins = tpc.bin_points(pts, rad, valid, size)
    for cots in ((gz, gd), (None, gd), (gz, None)):
        before = tpc.rasterize_points_grad_cuda.launches
        got = tpc.rasterize_points_grad_cuda(pts, idx, *cots, size, bins)
        torch.cuda.synchronize()
        assert tpc.rasterize_points_grad_cuda.launches == before + 1
        want = trp.rasterize_points_grad_plain(pts, idx, *cots, size)
        exact = trp.rasterize_points_grad_plain(pts.double(), idx, *(None if c is None else c.double() for c in cots), size)
        _point_grad_close(got, want, exact)


def test_backward_through_the_points_path_launches_the_grad_kernel(cuda_device):
    pts, rad, valid = _points(cuda_device, radius=0.05)
    counts = torch.tensor([3000, 2000], device=cuda_device)

    def grad(bin_size):
        p = pts.clone().requires_grad_(True)
        clouds = Pointclouds.create(p, num_points_per_cloud=counts, device=cuda_device)
        idx, zbuf, dists = trp.rasterize_points(clouds, (128, 96), rad, 8, bin_size=bin_size)
        m = idx >= 0
        (torch.where(m, zbuf, 0.0).sum() + torch.where(m, dists, 0.0).sum()).backward()
        return p.grad

    fwd, bwd = tpc.rasterize_points_cuda.launches, tpc.rasterize_points_grad_cuda.launches
    got = grad(None)
    assert (tpc.rasterize_points_cuda.launches, tpc.rasterize_points_grad_cuda.launches) == (fwd + 1, bwd + 1)
    want = grad(0)
    ok, ratio, share = _CHIP_SMOKE.point_grad_gate(got, want)
    assert ok, (ratio, share)


def test_each_points_call_counts_its_launch(cuda_device):
    pts, rad, valid = _points(cuda_device, P=500)
    counters = (tpc.rasterize_points_cuda, tpc.rasterize_points_grad_cuda)
    before = [c.launches for c in counters]
    idx, zbuf, dists = tpc.rasterize_points_cuda(pts, rad, valid, (32, 32), 4)
    tpc.rasterize_points_grad_cuda(pts, idx, zbuf, dists, (32, 32), tpc.bin_points(pts, rad, valid, (32, 32)))
    assert [c.launches for c in counters] == [b + 1 for b in before]


def test_points_kernels_refuse_what_they_do_not_take(cuda_device):
    pts, rad, valid = _points(cuda_device, P=500)
    with pytest.raises(ValueError):
        tpc.rasterize_points_cuda(pts, rad, valid, (32, 32), tpc.MAX_POINTS_PER_PIXEL + 1)
    with pytest.raises(TypeError):
        tpc.rasterize_points_cuda(pts.double(), rad, valid, (32, 32), 4)
    with pytest.raises(ValueError):
        tpc.rasterize_points_cuda(pts.transpose(0, 1).contiguous().transpose(0, 1), rad, valid, (32, 32), 4)
    with pytest.raises(ValueError):
        tpc.rasterize_points_cuda(pts, rad.double(), valid, (32, 32), 4)

    idx, zbuf, dists = tpc.rasterize_points_cuda(pts, rad, valid, (32, 32), 4)
    bins = tpc.bin_points(pts, rad, valid, (32, 32))
    with pytest.raises(TypeError):
        tpc.rasterize_points_grad_cuda(pts.double(), idx, zbuf, dists, (32, 32), bins)
    with pytest.raises(TypeError):
        tpc.rasterize_points_grad_cuda(pts, idx.long(), zbuf, dists, (32, 32), bins)
    with pytest.raises(ValueError):
        tpc.rasterize_points_grad_cuda(pts, idx, zbuf.transpose(1, 2), dists, (32, 32), bins)  # not contiguous
    with pytest.raises(ValueError):
        tpc.rasterize_points_grad_cuda(pts, idx.transpose(1, 2), zbuf, dists, (32, 32), bins)  # not contiguous
    wide = idx.new_full((2, 32, 32, tpc.MAX_POINTS_PER_PIXEL + 1), -1)
    with pytest.raises(ValueError):
        tpc.rasterize_points_grad_cuda(pts, wide, None, wide.float(), (32, 32), bins)


# --------------------------------------------------------------------------- #
# The fused MLP and NeRF field kernels (#10-#13)
# --------------------------------------------------------------------------- #

tfm = importlib.import_module("pytorch3d_tpu_torch.ops.fused_mlp_cuda")


def _mlp_inputs(device, N, D, H, L, skips, Ddir=0, Hh=0, seed=0):
    """Seeded xavier-scaled weights, small random biases and inputs in the
    range of harmonic embeddings; with Ddir, the 9 head tensors too."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(i, o, bias=True):
        lim = (6.0 / (i + o)) ** 0.5
        w = (torch.rand((i, o), generator=gen, device=device) * 2 - 1) * lim
        b = torch.randn((o,), generator=gen, device=device) * 0.05
        return w, b

    x = torch.rand((N, D), generator=gen, device=device) * 2 - 1
    ws, bs = zip(*[dense((D if li == 0 else H) + (D if li in skips else 0), H) for li in range(L)])
    if not Ddir:
        return x, None, list(ws), list(bs), None
    de = torch.rand((N, Ddir), generator=gen, device=device) * 2 - 1
    wd, bd = dense(H, 1)
    wi, bi = dense(H, H)
    wc1, bc1 = dense(H + Ddir, Hh)
    wc2, bc2 = dense(Hh, 3)
    head = (wd, bd, wi, bi, wc1[:H].contiguous(), wc1[H:].contiguous(), bc1, wc2, bc2)
    return x, de, list(ws), list(bs), head


_MLP_GRID = [
    # N, D, H, L, skips, Ddir, Hh
    (1000, 39, 32, 2, (1,), 0, 0),
    (4096 + 13, 39, 256, 8, (5,), 0, 0),
    (65536, 39, 256, 8, (5,), 27, 128),
    (777, 63, 128, 6, (3,), 0, 0),
    (1000, 39, 32, 2, (1,), 27, 16),
    (4096 + 13, 39, 256, 8, (5,), 27, 128),
    (333, 39, 200, 3, (1, 2), 15, 100),
    # the backward's tiling edges: 64-row blocks of the row pass, 8-wide
    # n-tiles and 16-wide k-steps of its products, 128 x 128 weight tiles
    (1, 39, 256, 8, (5,), 27, 128),  # N = 1
    (63, 39, 8, 1, (), 27, 100),  # N = block rows - 1, H = 8, L = 1
    (65, 10, 40, 4, (3,), 15, 24),  # N = block rows + 1, widths not multiples of 16
    (65, 39, 8, 1, (), 0, 0),  # the trunk at H = 8, L = 1
    (4096, 39, 256, 8, (7,), 0, 0),  # a skip at the last layer
    (100, 39, 33, 3, (1,), 15, 17),  # odd widths: the scalar paths of the vector loads and stores
    # the forward's tiling edges: 128-row blocks (two warpgroups of 64),
    # 8-feature k-blocks, 128-wide colour column blocks
    (127, 39, 256, 8, (5,), 27, 128),  # N = block rows - 1
    (129, 39, 256, 8, (5,), 0, 0),  # N = block rows + 1
    (129, 5, 5, 2, (1,), 3, 3),  # widths below 8: one zero-padded k-block
    (300, 39, 64, 2, (1,), 27, 200),  # a colour layer wider than 128: two column blocks
    (200, 200, 256, 2, (1,), 100, 64),  # wide inputs: one consumer warpgroup of 64 rows a block
]


@pytest.mark.parametrize("N,D,H,L,skips,Ddir,Hh", _MLP_GRID)
def test_fused_kernels_match_plain(cuda_device, N, D, H, L, skips, Ddir, Hh):
    # The plain versions' matrix products must run in float32, not TF32.
    assert not torch.backends.cuda.matmul.allow_tf32
    x, de, ws, bs, head = _mlp_inputs(cuda_device, N, D, H, L, skips, Ddir, Hh)
    g = torch.randn((N, 4 if head else H), generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    fwd, bwd = (tfm.nerf_field_cuda, tfm.nerf_field_grad_cuda) if head else (tfm.fused_mlp_cuda, tfm.fused_mlp_grad_cuda)
    before = (fwd.launches, bwd.launches)
    result = _CHIP_SMOKE.compare_fused(x, de, ws, bs, head, skips, g)
    # the serving forward, the saving forward and the backward on what it saved
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 1)
    assert _CHIP_SMOKE.fused_ok(result), result


@pytest.mark.parametrize("N,D,H,L,skips,Ddir,Hh", [_MLP_GRID[1], _MLP_GRID[5], _MLP_GRID[9]])
def test_fused_backward_gives_the_same_bits_twice(cuda_device, N, D, H, L, skips, Ddir, Hh):
    x, de, ws, bs, head = _mlp_inputs(cuda_device, N, D, H, L, skips, Ddir, Hh)
    g = torch.randn((N, 4 if head else H), generator=torch.Generator(device=cuda_device).manual_seed(2),
                    device=cuda_device)
    assert _CHIP_SMOKE.fused_backward_repeats(x, de, ws, bs, head, skips, g)


_FWD_SHAPES = [_MLP_GRID[1], _MLP_GRID[5], _MLP_GRID[9], _MLP_GRID[15], _MLP_GRID[16]]


def _forward_fn(x, de, ws, bs, head, skips):
    if head:
        return lambda save=False: tfm.nerf_field_cuda(x, de, ws, bs, head, skips, save=save)
    return lambda save=False: tfm.fused_mlp_cuda(x, ws, bs, skips, save=save)


@pytest.mark.parametrize("N,D,H,L,skips,Ddir,Hh", _FWD_SHAPES)
def test_fused_forward_serving_and_saving_give_the_same_bits(cuda_device, N, D, H, L, skips, Ddir, Hh):
    """The saving forward (a training step's) differs from serving only in
    its stores: the same `out` bits, and saved layer outputs equal to the
    plain chain's within the forward gate."""
    x, de, ws, bs, head = _mlp_inputs(cuda_device, N, D, H, L, skips, Ddir, Hh)
    fwd = _forward_fn(x, de, ws, bs, head, skips)
    out, saved = fwd(save=True)
    assert torch.equal(fwd(), out)
    _, _, outputs = tfm._trunk_chain(x, ws, bs, skips)
    stored = outputs if head else outputs[:-1]
    for li, want in enumerate(stored):
        got = saved[li * N * H : (li + 1) * N * H].view(N, H)
        assert float((got - want).abs().max()) <= _CHIP_SMOKE.FUSED_FWD_GATE * float(want.abs().max()), li


@pytest.mark.parametrize("N,D,H,L,skips,Ddir,Hh", _FWD_SHAPES)
def test_fused_forward_gives_the_same_bits_twice(cuda_device, N, D, H, L, skips, Ddir, Hh):
    x, de, ws, bs, head = _mlp_inputs(cuda_device, N, D, H, L, skips, Ddir, Hh)
    fwd = _forward_fn(x, de, ws, bs, head, skips)
    assert torch.equal(fwd(), fwd())


@pytest.mark.parametrize("N,D,H,L,skips,Ddir,Hh", [_MLP_GRID[1], _MLP_GRID[5], _MLP_GRID[9]])
def test_fused_backward_on_the_forwards_saved_tensors_passes_the_gates(cuda_device, N, D, H, L, skips, Ddir, Hh):
    """The backward reads what the tensor-core forward saved: with those
    tensors handed in it gives the bits of a launch that ran its own saving
    forward, and that launch passes the kernels' gates."""
    x, de, ws, bs, head = _mlp_inputs(cuda_device, N, D, H, L, skips, Ddir, Hh)
    g = torch.randn((N, 4 if head else H), generator=torch.Generator(device=cuda_device).manual_seed(3),
                    device=cuda_device)
    assert _CHIP_SMOKE.fused_ok(_CHIP_SMOKE.compare_fused(x, de, ws, bs, head, skips, g))
    saved = _forward_fn(x, de, ws, bs, head, skips)(save=True)
    if head:
        given = tfm.nerf_field_grad_cuda(x, de, ws, bs, head, skips, g, saved=saved)
        own = tfm.nerf_field_grad_cuda(x, de, ws, bs, head, skips, g)
    else:
        given = tfm.fused_mlp_grad_cuda(x, ws, bs, skips, g, saved=saved)
        own = tfm.fused_mlp_grad_cuda(x, ws, bs, skips, g)

    def flat(out):
        return [t for part in out for t in (part if isinstance(part, (list, tuple)) else [part]) if t is not None]

    assert all(torch.equal(a, b) for a, b in zip(flat(given), flat(own)))


def test_fused_backward_through_autograd_launches_the_kernels(cuda_device):
    x, de, ws, bs, head = _mlp_inputs(cuda_device, 600, 39, 64, 3, (2,), 27, 32)
    params = [*ws, *bs, *head]
    for p in params:
        p.requires_grad_(True)
    before = (tfm.nerf_field_cuda.launches, tfm.nerf_field_grad_cuda.launches, tfm._backward.forwards_run)
    out = tfm.fused_nerf_field(x, de, ws, bs, head, (2,))
    got = torch.autograd.grad((out ** 2).sum(), params)
    # one forward and one backward launch; the backward read the forward's
    # saved activations and ran no forward of its own
    assert (tfm.nerf_field_cuda.launches, tfm.nerf_field_grad_cuda.launches, tfm._backward.forwards_run) == (
        before[0] + 1, before[1] + 1, before[2])
    want = torch.autograd.grad((tfm.fused_nerf_field_plain(x, de, ws, bs, head, (2,)) ** 2).sum(), params)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_fused_trunk_backward_through_autograd_reads_the_saved_activations(cuda_device):
    x, _, ws, bs, _ = _mlp_inputs(cuda_device, 300, 39, 64, 4, (2,))
    params = [*ws, *bs]
    for p in params:
        p.requires_grad_(True)
    before = (tfm.fused_mlp_cuda.launches, tfm.fused_mlp_grad_cuda.launches, tfm._backward.forwards_run)
    got = torch.autograd.grad((tfm.fused_mlp(x, ws, bs, (2,)) ** 2).sum(), params)
    assert (tfm.fused_mlp_cuda.launches, tfm.fused_mlp_grad_cuda.launches, tfm._backward.forwards_run) == (
        before[0] + 1, before[1] + 1, before[2])
    want = torch.autograd.grad((tfm.fused_mlp_plain(x, ws, bs, (2,)) ** 2).sum(), params)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_fused_kernels_refuse_what_they_do_not_take(cuda_device):
    x, de, ws, bs, head = _mlp_inputs(cuda_device, 100, 39, 32, 2, (1,), 27, 16)
    with pytest.raises(TypeError):
        tfm.fused_mlp_cuda(x.double(), [w.double() for w in ws], [b.double() for b in bs], (1,))
    with pytest.raises(ValueError):
        tfm.fused_mlp_cuda(x.t().contiguous().t(), ws, bs, (1,))  # not contiguous
    with pytest.raises(ValueError):
        tfm.fused_mlp_cuda(x, ws, bs, (0,))  # layer 0 has no hidden input to concatenate to
    wide = _mlp_inputs(cuda_device, 100, 39, tfm.MAX_WIDTH + 1, 2, (1,))
    with pytest.raises(ValueError):
        tfm.fused_mlp_cuda(wide[0], wide[2], wide[3], (1,))
    with pytest.raises(ValueError):
        tfm.nerf_field_cuda(x, de[:50], ws, bs, head, (1,))
    with pytest.raises(ValueError):
        tfm.nerf_field_grad_cuda(x, de, ws, bs, head, (1,), torch.zeros((100, 3), device=cuda_device))


# --------------------------------------------------------------------------- #
# Slice 5: the ids-only fine kernel (#2), the hard kernel (#3), the pulsar
# select (#6) and the pulsar blend backward (#8)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("size,blur,K,persp,clip", [((128, 128), 1e-4, 8, True, True), ((96, 128), 0.0, 1, False, False)])
def test_topk_kernel_matches_fine_kernel_and_plain(cuda_device, size, blur, K, persp, clip):
    fv, valid = _batch_faces(cuda_device, size, aspect_ratio=size[1] / size[0])
    fine = trc.rasterize_fragments_cuda(fv, valid, size, blur, K, persp, clip)[0]
    for n in range(len(fv)):
        before = trc.rasterize_topk_cuda.launches
        got = trc.rasterize_topk_cuda(fv[n], valid[n], size, blur, K, persp, clip)
        torch.cuda.synchronize()
        assert trc.rasterize_topk_cuda.launches == before + 1
        assert torch.equal(got, fine[n])  # the same arithmetic: bit for bit
        want = trm.rasterize_topk(fv[n], valid[n], size, blur, K, persp, clip)
        assert (got.long() == want).float().mean() > 0.999


@pytest.mark.parametrize("size", [(128, 128), (96, 160)])
def test_hard_kernel_matches_plain(cuda_device, size):
    fv, valid = _batch_faces(cuda_device, size, aspect_ratio=size[1] / size[0])
    before = trc.rasterize_hard_cuda.launches
    pix, zbuf, bary = trc.rasterize_hard_cuda(fv, valid, size)
    torch.cuda.synchronize()
    assert trc.rasterize_hard_cuda.launches == before + 1
    w_pix, w_zbuf, w_bary = trc.rasterize_hard_plain(fv, valid, size)
    same = pix.long() == w_pix
    assert same.float().mean() >= _CHIP_SMOKE.HARD_IDS_GATE
    assert (zbuf - w_zbuf).abs()[same].max() <= 1e-5
    assert (bary - w_bary).abs()[same[..., None].expand_as(bary)].max() <= 1e-4
    empty = pix < 0
    assert (zbuf[empty] == -1).all() and (bary[empty[..., None].expand_as(bary)] == -1).all()


def _spheres(device, P=3000, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    pts = torch.cat([torch.rand((P, 2), generator=gen, device=device) * 2.2 - 1.1,
                     torch.rand((P, 1), generator=gen, device=device) * 4.5 - 0.5], -1)
    rad = torch.rand(P, generator=gen, device=device) * 0.05 + 0.01
    return pts, rad, (pts[:, 2] > 0.5) & (pts[:, 2] < 3.5)  # spheres on both sides of the bounds and of z = 0


@pytest.mark.parametrize("size,K", [((128, 128), 5), ((96, 160), 1), ((128, 96), 12)])
def test_select_kernel_matches_plain(cuda_device, size, K):
    pts, rad, valid = _spheres(cuda_device)
    bins = tpc.bin_points_for_pulsar(pts, rad, valid, size)
    before = tpc.select_points_cuda.launches
    got = tpc.select_points_cuda(pts, rad, valid, size, K, bins)
    torch.cuda.synchronize()
    assert tpc.select_points_cuda.launches == before + 1
    assert torch.equal(got.long(), trp.rasterize_points_topk(pts, rad, valid, size, K))
    assert torch.equal(got, tpc._run_kernel(pts[None], rad[None], bins[:4], size, K)[0][0])


def _pulsar_case(device, size, K, seed=0, C=3, gamma=0.1, P=3000):
    from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core

    pts, rad, valid = _spheres(device, P=P, seed=seed)
    P = pts.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    table = torch.cat([pts, rad[:, None], torch.rand((P, 1), generator=gen, device=device) * 0.7 + 0.3,
                       torch.rand((P, C), generator=gen, device=device)], -1).contiguous()
    bins = tpc.bin_points_for_pulsar(pts, rad, valid, size)
    idx = tpc.select_points_cuda(pts, rad, valid, size, K, bins)
    ct = torch.randn((*size, C), generator=gen, device=device)
    bg = torch.ones(C, device=device)
    env = (*_blend_core(table, idx, bg, gamma, 0.5, 3.5, 0.0, *size)[1:3], bg)  # denom, logit_max, bg_col
    return table, idx, bins, ct, env


@pytest.mark.parametrize("size,K,C,gamma", [
    ((128, 128), 5, 3, 0.1),
    ((96, 160), 3, 3, 0.1),
    ((96, 128), 5, 40, 0.1),  # 4 + C partial sums per warp outnumber its 32 lanes
    ((96, 128), 5, 200, 0.1),  # fewer than 64 spheres staged per chunk
    ((96, 128), 5, 3, 1e-4),  # PulsarPointsRenderer's gamma: logits ~1e4
])
def test_pulsar_grad_kernel_matches_plain(cuda_device, size, K, C, gamma):
    table, idx, bins, ct, env = _pulsar_case(cuda_device, size, K, C=C, gamma=gamma)
    before = tpc.pulsar_blend_grads_cuda.launches
    ok, ratio, ratio_plain, _ = _CHIP_SMOKE.compare_pulsar_grad(table, idx, bins, ct, "card test", gamma, (0.5, 3.5))
    assert tpc.pulsar_blend_grads_cuda.launches == before + 1
    assert ok, (ratio, ratio_plain)
    a = tpc.pulsar_blend_grads_cuda(table, idx, ct, *env, size, gamma, 0.5, 3.5, 0.0, bins)
    b = tpc.pulsar_blend_grads_cuda(table, idx, ct, *env, size, gamma, 0.5, 3.5, 0.0, bins)
    assert torch.equal(a, b)  # no atomics: two runs give the same bits


@pytest.mark.parametrize("P,size,K", [(30000, (64, 64), 5), (3000, (128, 128), 12)])
def test_pulsar_grad_kernel_gives_the_same_bits_twice(cuda_device, P, size, K):
    """Also where tile lists run to several passes of the kernel's pass 1
    (128 list positions each)."""
    table, idx, bins, ct, env = _pulsar_case(cuda_device, size, K, P=P)
    if P == 30000:
        assert int(bins[1].diff().max()) > 3 * 128
    a, b = (tpc.pulsar_blend_grads_cuda(table, idx, ct, *env, size, 0.1, 0.5, 3.5, 0.0, bins) for _ in range(2))
    assert bool(torch.isfinite(a).all()) and torch.equal(a.view(torch.int32), b.view(torch.int32))
    ok, ratio, ratio_plain, _ = _CHIP_SMOKE.compare_pulsar_grad(table, idx, bins, ct, "card test", 0.1, (0.5, 3.5))
    assert ok, (ratio, ratio_plain)


def test_pulsar_grad_kernel_flags_a_sphere_missing_from_its_tile_list(cuda_device):
    size = (128, 128)
    table, idx, bins, ct, env = _pulsar_case(cuda_device, size, 5)
    tile_points, tile_start, n_ty, n_tx, _, _ = bins
    y, x, k = (int(v) for v in (idx >= 0).nonzero()[0])
    j = int(idx[y, x, k])
    tile = (y // trc.TILE[0]) * n_tx + x // trc.TILE[1]
    lo, hi = int(tile_start[tile]), int(tile_start[tile + 1])
    drop = lo + int((tile_points[lo:hi] == j).nonzero()[0])
    points = torch.cat([tile_points[:drop], tile_points[drop + 1:]])
    start = torch.where(torch.arange(tile_start.numel(), device=cuda_device) > tile, tile_start - 1, tile_start).int()
    P = table.shape[0]
    rows = torch.sort(points, stable=True).indices.int()  # as bin_points_for_pulsar builds them
    sphere_start = torch.zeros(P + 1, dtype=torch.int64, device=cuda_device)
    sphere_start[1:] = torch.cumsum(torch.bincount(points, minlength=P), 0)
    cut = (points, start, n_ty, n_tx, rows, sphere_start.int())
    got = tpc.pulsar_blend_grads_cuda(table, idx, ct, *env, size, 0.1, 0.5, 3.5, 0.0, cut)
    others = torch.arange(P, device=cuda_device) != j
    assert bool(torch.isnan(got[j]).all()) and bool(torch.isfinite(got[others]).all())
    bad = idx.clone()
    bad[y, x, k] = P  # no such sphere: every row
    assert bool(torch.isnan(tpc.pulsar_blend_grads_cuda(table, bad, ct, *env, size, 0.1, 0.5, 3.5, 0.0, bins)).all())


def test_pulsar_points_renderer_backward_at_its_default_gamma(cuda_device):
    """PulsarPointsRenderer (gamma 1e-4, depths 0.1-100) backward through
    #8 against the same renderer on the card with the plain gradient
    patched in: one forward, so the two differ only in float32 summation
    order.  (Against the CPU the forward itself moves by ~1e-3 at this
    gamma: logits of ~1e4 turn ulp-level projection differences into
    weight changes.)"""
    from unittest import mock

    from pytorch3d_tpu_torch.renderer import (
        FoVOrthographicCameras, PointsRasterizationSettings, PointsRasterizer, PulsarPointsRenderer,
    )
    from pytorch3d_tpu_torch.renderer.points.pulsar import renderer as pulsar_module

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    P = 2000
    pts = (torch.rand((P, 3), generator=gen, device=cuda_device) * 1.6 - 0.8).requires_grad_(True)
    feats = torch.rand((P, 3), generator=gen, device=cuda_device).requires_grad_(True)
    R, T = look_at_view_transform(3.0, 20.0, 30.0, device=cuda_device)
    cams = FoVOrthographicCameras.create(R=R, T=T, znear=0.01, device=cuda_device)
    render = PulsarPointsRenderer(PointsRasterizer(cams, PointsRasterizationSettings(image_size=96, radius=0.03)))
    cloud = Pointclouds.create(pts[None], features=feats[None], device=cuda_device)
    wts = torch.randn((1, 96, 96, 3), generator=gen, device=cuda_device)

    grad = tpc.pulsar_blend_grads_cuda.launches
    img = render(cloud)
    got = torch.autograd.grad((img * wts).sum(), [pts, feats])
    assert tpc.pulsar_blend_grads_cuda.launches == grad + 1
    assert all(bool(torch.isfinite(g).all()) for g in got)
    plain_grads = lambda *args: tpc.pulsar_blend_grads_plain(*args[:11])  # noqa: E731 (drops the binning)
    with mock.patch.object(pulsar_module, "pulsar_blend_grads_cuda", plain_grads):
        img_plain = render(cloud)
        want = torch.autograd.grad((img_plain * wts).sum(), [pts, feats])
    assert torch.equal(img, img_plain)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()  # float32 summation order


def test_pulsar_renderer_backward_launches_the_kernels(cuda_device):
    from pytorch3d_tpu_torch.renderer.points.pulsar import Renderer

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    P = 400
    pos = torch.cat([torch.rand((P, 2), generator=gen, device=cuda_device) * 2 - 1,
                     torch.rand((P, 1), generator=gen, device=cuda_device) * 4 + 2], -1).requires_grad_(True)
    col = torch.rand((P, 3), generator=gen, device=cuda_device).requires_grad_(True)
    rad = (torch.rand(P, generator=gen, device=cuda_device) * 0.3 + 0.1).requires_grad_(True)
    cam = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 2.0], device=cuda_device, requires_grad=True)
    ren = Renderer(96, 64, P)
    sel, grad = tpc.select_points_cuda.launches, tpc.pulsar_blend_grads_cuda.launches
    img = ren(pos, col, rad, cam, 0.1, 10.0, 0.5)
    wts = torch.randn(img.shape, generator=gen, device=cuda_device)
    got = torch.autograd.grad((img * wts).sum(), [pos, col, rad, cam])
    assert (tpc.select_points_cuda.launches, tpc.pulsar_blend_grads_cuda.launches) == (sel + 1, grad + 1)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (pos, col, rad, cam)]
    img_cpu = ren(cpu[0], cpu[1], cpu[2], cpu[3], 0.1, 10.0, 0.5)
    torch.testing.assert_close(img.cpu(), img_cpu, atol=1e-5, rtol=0)
    want = torch.autograd.grad((img_cpu * wts.cpu()).sum(), cpu)
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 1e-3 * w.abs().max()  # the blend gradient's float32 conditioning


def test_mesh_rasterizer_opengl_launches_the_hard_kernel(cuda_device):
    from pytorch3d_tpu_torch.renderer import MeshRasterizerOpenGL, RasterizationSettings

    ico = ico_sphere(2, device=cuda_device)
    R, T = look_at_view_transform(2.7, 15.0, 20.0, device=cuda_device)
    cams = FoVPerspectiveCameras.create(R=R, T=T, device=cuda_device)
    before = trc.rasterize_hard_cuda.launches
    frags = MeshRasterizerOpenGL(cams, RasterizationSettings(image_size=64))(ico.extend(2))
    assert trc.rasterize_hard_cuda.launches == before + 1
    with _CHIP_SMOKE.plain_gl():
        plain = MeshRasterizerOpenGL(cams, RasterizationSettings(image_size=64))(ico.extend(2))
    assert (frags.pix_to_face == plain.pix_to_face).float().mean() >= _CHIP_SMOKE.HARD_IDS_GATE
    assert frags.dists is None and frags.pix_to_face[1].max() >= ico.faces_packed().shape[0]


def test_slice5_kernels_refuse_what_they_do_not_take(cuda_device):
    fv, valid = _batch_faces(cuda_device, (32, 32))
    with pytest.raises(ValueError):
        trc.rasterize_topk_cuda(fv[0], valid[0], (32, 32), 0.0, trc.MAX_FACES_PER_PIXEL + 1)
    with pytest.raises(ValueError):
        trc.rasterize_topk_cuda(fv, valid, (32, 32))  # a batch: one image's faces only
    with pytest.raises(TypeError):
        trc.rasterize_hard_cuda(fv.double(), valid, (32, 32))
    pts, rad, valid_p = _spheres(cuda_device, P=200)
    with pytest.raises(ValueError):
        tpc.select_points_cuda(pts, rad, valid_p, (32, 32), tpc.MAX_POINTS_PER_PIXEL + 1)
    table, idx, bins, ct, env = _pulsar_case(cuda_device, (32, 32), 5)
    with pytest.raises(ValueError):
        tpc.pulsar_blend_grads_cuda(table, idx, ct, *env, (32, 32), 0.1, 0.5, 3.5, 0.0, None)
    with pytest.raises(TypeError):
        tpc.pulsar_blend_grads_cuda(table.double(), idx, ct, *env, (32, 32), 0.1, 0.5, 3.5, 0.0, bins)
