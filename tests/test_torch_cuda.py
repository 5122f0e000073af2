"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere (a CUDA kernel has no CPU
mode; the CPU tests hold the plain versions against the JAX package).  They
import no JAX, so they run on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, MeshRasterizer, look_at_view_transform
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc
from pytorch3d_tpu_torch.structures import Meshes
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


@pytest.mark.parametrize("size,blur,K,persp,clip,cull", [
    ((128, 128), 1e-4, 8, True, True, False),
    ((128, 128), 0.0, 1, True, False, False),
    ((128, 128), 1e-4, 8, True, True, True),
    ((96, 128), 1e-4, 3, False, False, False),
    ((128, 128), 4e-3, 40, True, True, False),
])
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


def test_fine_kernel_backward_raises(cuda_device):
    fv, valid = _batch_faces(cuda_device, (32, 32))
    fv = fv.requires_grad_(True)
    _, zbuf, _, _ = trc.rasterize_fragments_cuda(fv, valid, (32, 32), 1e-4, 4)
    with pytest.raises(NotImplementedError):
        zbuf.sum().backward()


def test_fine_kernel_refuses_what_it_does_not_take(cuda_device):
    fv, valid = _batch_faces(cuda_device, (32, 32))
    with pytest.raises(ValueError):
        trc.rasterize_fragments_cuda(fv, valid, (32, 32), 1e-4, trc.MAX_FACES_PER_PIXEL + 1)
    with pytest.raises(TypeError):
        trc.rasterize_fragments_cuda(fv.double(), valid, (32, 32), 1e-4, 4)
    with pytest.raises(ValueError):
        trc.rasterize_fragments_cuda(fv.transpose(2, 3), valid, (32, 32), 1e-4, 4)  # not contiguous
