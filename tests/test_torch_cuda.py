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
    # fp32 atomics (kernel) and index_add_ (plain, atomics on the card too)
    # sum per-pixel terms in orders that change from run to run: within 1e-4
    # of the largest gradient, as in chip_smoke.py.
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
    gz, gbary, gdists = _cotangents(zbuf, bary)
    before = trc.rasterize_grad_cuda.launches
    got = trc.rasterize_grad_cuda(fv, idx, gz, gbary, gdists, size, persp, clip)
    torch.cuda.synchronize()
    assert trc.rasterize_grad_cuda.launches == before + 1
    want = trm.rasterize_grad_plain(fv, idx, gz, gbary, gdists, size, persp, clip)
    _grad_close(got, want, _exact_grad(fv, idx, (gz, gbary, gdists), size, persp, clip))
    # A missing cotangent is zero.
    _grad_close(
        trc.rasterize_grad_cuda(fv, idx, None, None, gdists, size, persp, clip),
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


def test_each_cuda_call_counts_its_launch(cuda_device):
    fv, valid = _batch_faces(cuda_device, (32, 32))
    counters = (trc.rasterize_fragments_cuda, trc.rasterize_grad_cuda, tknn.knn_points_cuda)
    before = [c.launches for c in counters]
    idx, zbuf, bary, dists = trc.rasterize_fragments_cuda(fv, valid, (32, 32), 1e-4, 4)
    trc.rasterize_grad_cuda(fv, idx, zbuf, bary, dists, (32, 32))
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
    with pytest.raises(TypeError):
        trc.rasterize_grad_cuda(fv.double(), idx, zbuf, bary, dists, (32, 32))
    with pytest.raises(TypeError):
        trc.rasterize_grad_cuda(fv, idx.long(), zbuf, bary, dists, (32, 32))
    with pytest.raises(ValueError):
        trc.rasterize_grad_cuda(fv, idx, zbuf.transpose(1, 2), bary, dists, (32, 32))  # not contiguous


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


def _point_grad_close(got, want, exact):
    # fp32 atomics (kernel) and index_add_ (plain) sum per-pixel terms in
    # orders that change from run to run: per point within 1e-5 of its own
    # scale, against the float64 plain version (chip_smoke.py's gate).
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
    for cots in ((gz, gd), (None, gd), (gz, None)):
        before = tpc.rasterize_points_grad_cuda.launches
        got = tpc.rasterize_points_grad_cuda(pts, idx, *cots, size)
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
    tpc.rasterize_points_grad_cuda(pts, idx, zbuf, dists, (32, 32))
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
    with pytest.raises(TypeError):
        tpc.rasterize_points_grad_cuda(pts.double(), idx, zbuf, dists, (32, 32))
    with pytest.raises(TypeError):
        tpc.rasterize_points_grad_cuda(pts, idx.long(), zbuf, dists, (32, 32))
    with pytest.raises(ValueError):
        tpc.rasterize_points_grad_cuda(pts, idx, zbuf.transpose(1, 2), dists, (32, 32))  # not contiguous
    with pytest.raises(ValueError):
        tpc.rasterize_points_grad_cuda(pts, idx.transpose(1, 2), zbuf, dists, (32, 32))  # not contiguous
    wide = idx.new_full((2, 32, 32, tpc.MAX_POINTS_PER_PIXEL + 1), -1)
    with pytest.raises(ValueError):
        tpc.rasterize_points_grad_cuda(pts, wide, None, wide.float(), (32, 32))
