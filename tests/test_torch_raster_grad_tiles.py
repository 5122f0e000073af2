"""The mesh rasterizer backward's tile decomposition, on the CPU.

The CUDA backward (csrc/rasterize_grad.cu) sums each slot's partials per
(tile, face) pair of the forward's binning into a row of a (pairs, 9)
table, then adds each face's rows in ascending tile order through a
face-major CSR of the rows (`face_pair_rows`).  Here:

- that CSR, built in torch, equals a brute-force transpose of `bin_faces`'
  tile lists;
- every face id of the forward's pix_to_face lies in its tile's list (so
  the kernel's error flag cannot fire on the autograd path), on seeded
  meshes with blur;
- per-tile rows (the plain backward with the cotangents of one tile at a
  time) added per face in the CSR's order give the plain backward;
- `rasterize_grad_cuda` on CPU tensors still equals the plain backward and
  the VJP through the JAX package's `_grad_kernel` in interpret mode, as
  tests/test_torch_raster_grad.py holds it;
- chip_smoke.py's long-list cases bin tile lists that pass 1 sums in at
  least three passes, of the list length the kernel's source cuts at.

Inputs are numpy arrays from the JAX package's camera and a seed, handed
to both packages; the port runs on the CPU.
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

trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")


@functools.lru_cache(maxsize=None)
def _faces_np(size, azims, level):
    out = []
    for azim in azims:
        R, T = j_look_at(dist=2.7, elev=15.0, azim=azim)
        cams = JCameras.create(R=R, T=T, aspect_ratio=size[1] / size[0])
        m = JRasterizer(cams, JSettings(image_size=size)).transform(j_ico_sphere(level))
        out.append(np.asarray(m.verts_padded()[0][m.faces_padded()[0]]))
    return np.stack(out)


def _faces(size, azims=(20.0, 75.0), level=2):
    """(N, F, 3, 3) NDC face verts of an icosphere seen from N azimuths."""
    fv = torch.from_numpy(_faces_np(size, azims, level).copy())
    return fv, torch.ones(fv.shape[:2], dtype=torch.bool)


def _cotangents(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in (shape, (*shape, 3), shape)
    )


def _tile_of_pair(tile_start):
    counts = tile_start.diff().long()
    return torch.repeat_interleave(torch.arange(counts.numel()), counts)


_SETTINGS = [
    # size, blur, K, persp, clip
    ((64, 64), 1e-3, 4, True, True),
    ((48, 80), 1e-4, 3, False, False),
    ((64, 64), 0.0, 1, True, False),
]


@pytest.mark.parametrize("size,blur,K,persp,clip", _SETTINGS)
def test_face_pair_rows_is_the_transpose_of_the_tile_lists(size, blur, K, persp, clip):
    fv, valid = _faces(size)
    N, F = valid.shape
    tile_faces, tile_start, n_ty, n_tx = trc.bin_faces(fv, valid, size, blur)
    pair_rows, face_start = trc.face_pair_rows(tile_faces, tile_start, N, F)
    tile = _tile_of_pair(tile_start)
    faces = (tile // (n_ty * n_tx)) * F + tile_faces.long()
    assert face_start.dtype == torch.int32 and pair_rows.dtype == torch.int32
    assert face_start[0] == 0 and face_start[-1] == tile_faces.numel()
    brute = [[] for _ in range(N * F)]
    for q, face in enumerate(faces.tolist()):  # pairs in tile-major order
        brute[face].append(q)
    starts = face_start.tolist()
    assert [pair_rows[starts[f]:starts[f + 1]].tolist() for f in range(N * F)] == brute


@pytest.mark.parametrize("size,blur,K,persp,clip", _SETTINGS)
def test_forward_ids_lie_in_their_tiles_lists(size, blur, K, persp, clip):
    fv, valid = _faces(size)
    N, F = valid.shape
    H, W = size
    ids = trc.rasterize_fragments_plain(fv, valid, size, blur, K, persp, clip)[0]
    tile_faces, tile_start, n_ty, n_tx = trc.bin_faces(fv, trm._face_culls(fv, valid, False), size, blur)
    binned = _tile_of_pair(tile_start) * F + tile_faces.long()
    rows = torch.arange(H)[:, None] // trc.TILE[0]
    cols = torch.arange(W)[None, :] // trc.TILE[1]
    tile = (torch.arange(N)[:, None, None] * n_ty + rows) * n_tx + cols
    keys = (tile[..., None] * F + ids)[ids >= 0]
    assert keys.numel() > 0 and torch.isin(keys, binned).all()


@pytest.mark.parametrize("size,blur,K,persp,clip", _SETTINGS[:2])
def test_tile_rows_added_per_face_give_the_plain_backward(size, blur, K, persp, clip):
    fv, valid = _faces(size)
    N, F = valid.shape
    H, W = size
    ids = trc.rasterize_fragments_plain(fv, valid, size, blur, K, persp, clip)[0].int()
    cots = _cotangents(ids.shape, seed=K)
    tile_faces, tile_start, n_ty, n_tx = trc.bin_faces(fv, valid, size, blur)
    table = torch.zeros((tile_faces.numel(), 9))
    for t in range(N * n_ty * n_tx):  # pass 1: one tile's cotangents at a time
        n, ty, tx = t // (n_ty * n_tx), (t // n_tx) % n_ty, t % n_tx
        mask = torch.zeros((N, H, W), dtype=torch.bool)
        mask[n, ty * trc.TILE[0]:(ty + 1) * trc.TILE[0], tx * trc.TILE[1]:(tx + 1) * trc.TILE[1]] = True
        part = trm.rasterize_grad_plain(
            fv, ids, *(torch.where(mask.reshape(N, H, W, *[1] * (c.ndim - 3)), c, 0.0) for c in cots),
            size, persp, clip,
        )[n].reshape(F, 9)
        lo, hi = int(tile_start[t]), int(tile_start[t + 1])
        table[lo:hi] = part[tile_faces[lo:hi].long()]
        others = torch.ones(F, dtype=torch.bool)
        others[tile_faces[lo:hi].long()] = False
        assert (part[others] == 0).all()  # nothing outside the tile's list
    pair_rows, face_start = trc.face_pair_rows(tile_faces, tile_start, N, F)
    got = torch.zeros((N * F, 9))
    for face in range(N * F):  # pass 2: the face's rows in ascending tile order
        for q in pair_rows[face_start[face]:face_start[face + 1]].tolist():
            got[face] += table[q]
    want = trm.rasterize_grad_plain(fv, ids, *cots, size, persp, clip).reshape(N * F, 9)
    scale = want.abs().max()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(scale))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rmp.pl, "pallas_call", patched)


def test_cpu_wrapper_matches_plain_and_jax_grad_kernel(interpret_pallas):
    K, blur, persp, clip = 4, 1e-4, True, True
    size = (32, 32)  # interpret mode runs the TPU kernel's grid step by step
    fv, valid = _faces(size, azims=(20.0,))
    fvj, validj = jnp.asarray(fv[0].numpy()), jnp.asarray(valid[0].numpy())

    def fragments(f):
        idx, *rest = rmp.rasterize_fragments_pallas(f, validj, size, blur, K, persp, clip)
        return tuple(rest), idx

    _, vjp, idx = jax.vjp(fragments, fvj, has_aux=True)
    cots = _cotangents((1, *size, K), seed=K + 11)
    ids = torch.from_numpy(np.array(idx))[None].int()
    before = trc.rasterize_grad_cuda.launches
    bins = trc.bin_faces(fv, valid, size, blur)  # ignored on the CPU
    got = trc.rasterize_grad_cuda(fv, ids, *cots, size, bins, persp, clip)
    assert trc.rasterize_grad_cuda.launches == before
    assert torch.equal(got, trm.rasterize_grad_plain(fv, ids, *cots, size, persp, clip))
    (want,) = vjp(tuple(jnp.asarray(c[0].numpy()) for c in cots))
    # The JAX package's own bound for this kernel against its XLA VJP
    # (tests/test_pallas_crosscheck.py), with atol as test_torch_raster_grad.py
    # sets it: the largest gradient is heavy-tailed.
    got, want = got[0].numpy(), np.asarray(want)
    mag = np.abs(want)
    atol = min(1e-6 * mag.max(), 1e-4 * np.median(mag[mag > 0]))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", range(2))
def test_chip_smoke_long_list_cases_take_several_passes(case):
    cs = _chip_smoke()
    source = (pathlib.Path(trc.__file__).resolve().parents[2] / "csrc" / "rasterize_grad.cu").read_text()
    assert int(re.search(r"constexpr int kListChunk = (\d+);", source).group(1)) == cs.GRAD_LIST_CHUNK
    _, level, side, blur, _, _, _ = cs.LONG_LIST_CASES[case]
    from pytorch3d_tpu_torch.utils import ico_sphere

    cpu = torch.device("cpu")
    fv, valid = cs.face_inputs(ico_sphere(level, device=cpu), cs.camera(30.0, cpu), (side, side))
    bins = trc.bin_faces(fv, trm._face_culls(fv, valid, False), (side, side), blur)
    longest, passes = cs.longest_list(bins)
    assert passes >= 3 and longest > 2 * cs.GRAD_LIST_CHUNK, longest
