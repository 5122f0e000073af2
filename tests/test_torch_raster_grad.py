"""The port's rasterizer backward against the JAX package.

- `rasterize_grad_plain` (the plain version of the CUDA backward kernel)
  against `jax.vjp` of JAX `interpolate_fragments` on the same ids and
  cotangents, over K x blur x the perspective/clip corners.
- The same against the VJP of `rasterize_fragments_pallas` run in interpret
  mode, whose backward is the TPU kernel `_grad_kernel` (rasterize_pallas.py:809).
- The CPU wrapper: autograd through the plain forward gives the plain
  backward's gradient, and no kernel launch is counted.
- chip_smoke.py's per-face gate for the CUDA backward fails a result that
  is off on ordinary faces, where a gate relative to the largest gradient
  alone would pass it.

Tolerance rtol 1e-4, atol 1e-6 of the largest gradient capped at 1e-4 of
the median one: the two frameworks add the per-pixel terms of a face in
another order, and where a face's terms cancel its sum keeps their absolute
rounding.  The cap keeps the check per element meaningful where the largest
gradient is an outlier (random cotangents give gradients up to 1e13 at
blurred, perspective-corrected, unclipped slots, against a median of ~5).
Against the TPU kernel rtol is 1e-3, the bound the JAX package holds that
kernel to against its own XLA VJP (tests/test_pallas_crosscheck.py): the
kernel multiplies by reciprocals, takes the segment distance's gradient in
closed form and routes min() ties to one edge.  Inputs are made with numpy
from a seed and handed to both packages; the port runs on the CPU.
"""

import importlib
import importlib.util
import itertools
import pathlib

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
from pytorch3d_tpu_torch.renderer.mesh import rasterize_cuda as trc

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

jrm = importlib.import_module("pytorch3d_tpu.renderer.mesh.rasterize_meshes")
trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")

SIZE = (64, 64)


def _faces(level=2):
    """(F, 3, 3) NDC face verts of an icosphere seen by a JAX camera."""
    R, T = j_look_at(dist=2.7, elev=15.0, azim=20.0)
    m = JRasterizer(JCameras.create(R=R, T=T), JSettings(image_size=SIZE)).transform(j_ico_sphere(level))
    fv = np.asarray(m.verts_padded()[0][m.faces_padded()[0]])
    return fv, np.ones(fv.shape[0], bool)


def _cotangents(K, seed):
    rng = np.random.default_rng(seed)
    H, W = SIZE
    return (
        rng.standard_normal((H, W, K)).astype(np.float32),
        rng.standard_normal((H, W, K, 3)).astype(np.float32),
        rng.standard_normal((H, W, K)).astype(np.float32),
    )


def _batch(a):
    """A (1, ...) torch tensor of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))[None]


def _port_grad(fv, idx, cots, persp, clip):
    return trm.rasterize_grad_plain(
        _batch(fv), _batch(idx), *(_batch(c) for c in cots), SIZE, persp, clip
    )[0].numpy()


def _close(got, want, rtol=1e-4):
    # Per-pixel terms summed per face in another order: rtol, and for sums
    # that cancel atol 1e-6 of the largest gradient, but never more than
    # 1e-4 of the median nonzero one: the largest is heavy-tailed, and an
    # atol set from it alone can exceed ordinary faces' gradients.
    assert np.isfinite(got).all()
    mag = np.abs(want)
    atol = min(1e-6 * mag.max(), 1e-4 * np.median(mag[mag > 0]))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


_GRID = list(itertools.product((1, 4), (0.0, 1e-4), ((False, False), (True, True), (True, False), (False, True))))


@pytest.mark.parametrize("K,blur,flags", _GRID)
def test_plain_backward_matches_jax_interpolate_vjp(K, blur, flags):
    persp, clip = flags
    fv, valid = _faces()
    idx = jrm.rasterize_topk_xla(
        jnp.asarray(fv), jnp.asarray(valid), SIZE, blur, K,
        perspective_correct=persp, clip_barycentric_coords=clip,
    )
    cots = _cotangents(K, seed=K + 7)
    _, vjp = jax.vjp(lambda f: jrm.interpolate_fragments(f, idx, SIZE, persp, clip), jnp.asarray(fv))
    (want,) = vjp(tuple(jnp.asarray(c) for c in cots))
    _close(_port_grad(fv, idx, cots, persp, clip), np.asarray(want))


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
def test_plain_backward_matches_jax_pallas_grad_kernel(interpret_pallas, K, blur, persp, clip):
    fv, valid = _faces()
    fvj, validj = jnp.asarray(fv), jnp.asarray(valid)
    idx = rmp.rasterize_fragments_pallas(fvj, validj, SIZE, blur, K, persp, clip)[0]
    cots = _cotangents(K, seed=K + 11)
    _, vjp = jax.vjp(
        lambda f: rmp.rasterize_fragments_pallas(f, validj, SIZE, blur, K, persp, clip)[1:], fvj
    )
    (want,) = vjp(tuple(jnp.asarray(c) for c in cots))
    # The JAX package's own bound for this kernel against its XLA VJP.
    _close(_port_grad(fv, idx, cots, persp, clip), np.asarray(want), rtol=1e-3)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("rel", [3e-4, 1e-3])
def test_chip_smoke_grad_gate_fails_a_kernel_off_on_ordinary_faces(rel):
    """chip_smoke.py's gate for the backward kernel, fed a stand-in kernel
    result: the float32 plain version off by `rel` on the 99 % of faces with
    the smallest gradients.  The largest gradient is ~1e11 times theirs
    here, so the gate relative to it alone passes; the per-face gate fails."""
    cs = _chip_smoke()
    K, blur, persp, clip = 4, 1e-4, True, False
    fv, valid = _faces(3)
    idx = jrm.rasterize_topk_xla(
        jnp.asarray(fv), jnp.asarray(valid), SIZE, blur, K,
        perspective_correct=persp, clip_barycentric_coords=clip,
    )
    cots = [_batch(c) for c in _cotangents(K, seed=1)]
    fvt, idt = _batch(fv), _batch(idx)
    want = trm.rasterize_grad_plain(fvt, idt, *cots, SIZE, persp, clip)
    exact = trm.rasterize_grad_plain(fvt.double(), idt, *(c.double() for c in cots), SIZE, persp, clip)
    scale = want.abs().reshape(-1, 9).amax(dim=1)
    ordinary = (scale <= torch.quantile(scale[scale > 0], 0.99)).reshape(1, -1, 1, 1)
    got = torch.where(ordinary, want * (1.0 + rel), want)
    assert cs.grad_error(got, want)[1] <= cs.GRAD_GATE  # the global gate alone passes it
    kernel_share, plain_share = cs.face_agreement(got, want, exact)
    assert plain_share >= cs.GRAD_FACE_SHARE
    assert kernel_share < cs.GRAD_FACE_SHARE


@pytest.mark.parametrize("K,blur,persp,clip", [(4, 1e-4, True, True), (1, 0.0, False, False)])
def test_cpu_wrapper_gradient_is_the_plain_backward(K, blur, persp, clip):
    fv, valid = _faces()
    verts = _batch(fv).requires_grad_(True)
    before = (trc.rasterize_fragments_cuda.launches, trc.rasterize_grad_cuda.launches)
    idx, zbuf, bary, dists = trc.rasterize_fragments_cuda(
        verts, _batch(valid), SIZE, blur, K, persp, clip
    )
    cots = [_batch(c) for c in _cotangents(K, seed=3)]
    torch.autograd.backward([zbuf, bary, dists], cots)
    bins = trc.bin_faces(verts.detach(), trm._face_culls(verts.detach(), _batch(valid), False), SIZE, blur)
    want = trc.rasterize_grad_cuda(verts.detach(), idx.int(), *cots, SIZE, bins, persp, clip)
    assert (trc.rasterize_fragments_cuda.launches, trc.rasterize_grad_cuda.launches) == before
    _close(verts.grad.numpy(), want.numpy())
