"""The port's near-plane clipping (`renderer/mesh/clip.py`) and
`rasterize_meshes(z_clip_value=...)` against the JAX package, on the CPU.

- `clip_faces` on tests/test_clip.py's four cases and on random faces
  crossing the plane: sub-face verts, masks and barycentric rows, and
  their gradient; `convert_clipped_rasterization_to_original_faces`.
- `rasterize_meshes` with `z_clip_value` on the plain route (`bin_size=0`)
  from a camera inside an icosphere: ids, zbuf, bary and dists, and the
  gradient with respect to the NDC verts through the clip (one JAX
  render, module-scoped).  Faces come from the JAX camera transform as
  numpy, so both packages clip the same numbers.
- The port alone from tests/test_clip.py's camera at dist 0.5, where
  vertices lie on the camera plane and project to infinity (JAX's
  gradient is NaN there), and the grazing one: every id maps back below F,
  every depth lies beyond the plane, cut faces cover pixels, and the
  gradient stays finite.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.renderer import FoVPerspectiveCameras as JCameras
from pytorch3d_tpu.renderer import MeshRasterizer as JRasterizer
from pytorch3d_tpu.renderer import RasterizationSettings as JSettings
from pytorch3d_tpu.renderer import look_at_view_transform as j_look_at
from pytorch3d_tpu.renderer.mesh import clip as jclip
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch.renderer import FoVPerspectiveCameras, MeshRasterizer, RasterizationSettings
from pytorch3d_tpu_torch.renderer import look_at_view_transform
from pytorch3d_tpu_torch.renderer.mesh import clip as tclip
from pytorch3d_tpu_torch.structures import Meshes
from pytorch3d_tpu_torch.utils import ico_sphere

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

jrm = importlib.import_module("pytorch3d_tpu.renderer.mesh.rasterize_meshes")
trm = importlib.import_module("pytorch3d_tpu_torch.renderer.mesh.rasterize_meshes")

CPU = torch.device("cpu")
Z_CLIP = 0.1

CASES = np.array(
    [
        [[0, 0, 1], [1, 0, 1], [0, 1, 1]],  # case 1: in front
        [[0, 0, -1], [1, 0, -1], [0, 1, -1]],  # case 2: behind
        [[0, 0, 1], [1, 0, -1], [0, 1, -1]],  # case 3: 2 behind
        [[0, 0, -1], [1, 0, 1], [0, 1, 1]],  # case 4: 1 behind
    ],
    np.float32,
)


def _random_faces(seed=0, n=64):
    """Faces with z spread around the plane, some vertices exactly on it."""
    rng = np.random.default_rng(seed)
    fv = rng.uniform(-1.0, 1.0, (n, 3, 3)).astype(np.float32)
    fv[..., 2] = rng.uniform(-0.5, 0.7, (n, 3)).astype(np.float32)
    fv[::7, 1, 2] = Z_CLIP  # on the plane: the guarded division
    return np.concatenate([CASES, fv])


@pytest.mark.parametrize("faces", ["cases", "random"])
def test_clip_faces_matches_jax(faces):
    """Sub-faces, masks and barycentric rows within 1e-6 on the valid
    slots (the port zeroes the invalid ones, which no rasterizer reads)."""
    fv = CASES if faces == "cases" else _random_faces()
    valid = np.ones(fv.shape[0], bool)
    valid[5::11] = False
    want = jclip.clip_faces(jnp.asarray(fv), jnp.asarray(valid), Z_CLIP)
    got = tclip.clip_faces(torch.from_numpy(fv), torch.from_numpy(valid), Z_CLIP)
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    np.testing.assert_allclose(got.face_verts.numpy()[ok], np.asarray(want.face_verts)[ok], atol=1e-6)
    np.testing.assert_allclose(got.barycentric_conversion.numpy()[ok],
                               np.asarray(want.barycentric_conversion)[ok], atol=1e-6)
    np.testing.assert_array_equal(got.faces_clipped_to_unclipped_idx.numpy(),
                                  np.asarray(want.faces_clipped_to_unclipped_idx))
    if faces == "cases":  # tests/test_clip.py's mask, from the port too
        assert got.valid.tolist() == [True, False, True, True, False, False, False, True]


def test_clip_faces_gradient_matches_jax():
    """The gradient of seeded cotangents on the valid sub-faces' verts and
    barycentric rows, with vertices on the plane among them: finite and
    within 1e-5 of JAX's."""
    fv = _random_faces(seed=1)
    valid = np.ones(fv.shape[0], bool)
    rng = np.random.default_rng(2)
    ct_v = rng.standard_normal((2 * fv.shape[0], 3, 3)).astype(np.float32)
    ct_b = rng.standard_normal((2 * fv.shape[0], 3, 3)).astype(np.float32)

    def jloss(x):
        c = jclip.clip_faces(x, jnp.asarray(valid), Z_CLIP)
        m = c.valid[:, None, None]
        return jnp.sum(jnp.where(m, c.face_verts * ct_v, 0.0)) + jnp.sum(jnp.where(m, c.barycentric_conversion * ct_b, 0.0))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(fv)))
    x = torch.from_numpy(fv).requires_grad_(True)
    c = tclip.clip_faces(x, torch.from_numpy(valid), Z_CLIP)
    m = c.valid[:, None, None]
    loss = (torch.where(m, c.face_verts * torch.from_numpy(ct_v), 0.0).sum()
            + torch.where(m, c.barycentric_conversion * torch.from_numpy(ct_b), 0.0).sum())
    loss.backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5)


def test_convert_matches_jax():
    """Ids mapped back exactly, barycentrics within 1e-6, empty slots kept;
    batched tables give each image's own rows."""
    fv = _random_faces(seed=3)
    valid = np.ones(fv.shape[0], bool)
    rng = np.random.default_rng(4)
    F2 = 2 * fv.shape[0]
    pix = rng.integers(-1, F2, (2, 5, 6, 3)).astype(np.int64)
    bary = rng.uniform(-0.2, 1.0, (2, 5, 6, 3, 3)).astype(np.float32)
    want = jclip.clip_faces(jnp.asarray(fv), jnp.asarray(valid), Z_CLIP)
    got = tclip.clip_faces(torch.from_numpy(fv), torch.from_numpy(valid), Z_CLIP)
    wp, wb = jclip.convert_clipped_rasterization_to_original_faces(jnp.asarray(pix), jnp.asarray(bary), want)
    gp, gb = tclip.convert_clipped_rasterization_to_original_faces(torch.from_numpy(pix), torch.from_numpy(bary), got)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-6)
    # a batch of two tables: image 1's ids read table 1
    fv2 = np.stack([fv, fv[::-1].copy()])
    batched = tclip.clip_faces(torch.from_numpy(fv2), torch.ones(2, fv.shape[0], dtype=torch.bool), Z_CLIP)
    one = tclip.clip_faces(torch.from_numpy(fv2[1]), torch.ones(fv.shape[0], dtype=torch.bool), Z_CLIP)
    bp, bb = tclip.convert_clipped_rasterization_to_original_faces(torch.from_numpy(pix), torch.from_numpy(bary), batched)
    op, ob = tclip.convert_clipped_rasterization_to_original_faces(torch.from_numpy(pix[1]), torch.from_numpy(bary[1]), one)
    assert torch.equal(bp[1], op) and torch.equal(bb[1], ob)


SIZE, K, BLUR = 32, 4, 1e-4


# A camera 0.03 inside the wall looking along it, turned so that no vertex
# lies on its camera plane: faces cross the near plane in view.
GRAZE = dict(eye=((0.0, 0.0, 0.97),), at=((0.31, 1.0, 0.955),), up=((0.0, 0.0, 1.0),))


def _inside_ndc(level):
    """(2, V, 3) NDC verts (view z) and faces of an icosphere seen from two
    cameras inside it (at dist 0.7 from its centre, and grazing its wall),
    by the JAX transform."""
    mesh = j_ico_sphere(level).extend(2)
    R0, T0 = j_look_at(dist=0.7)
    R1, T1 = j_look_at(**{k: jnp.asarray(v) for k, v in GRAZE.items()})
    cams = JCameras.create(R=jnp.concatenate([R0, R1]), T=jnp.concatenate([T0, T1]), znear=0.05)
    ndc = JRasterizer(cams, JSettings(image_size=SIZE)).transform(mesh)
    return np.array(ndc.verts_padded()), np.array(ndc.faces_padded())


@pytest.fixture(scope="module")
def inside_render():
    """JAX's clipped render from inside ico_sphere(2) (`_inside_ndc`) and
    the vertex gradient of seeded cotangents on zbuf, bary and dists."""
    from pytorch3d_tpu.structures import Meshes as JMeshes

    verts, faces = _inside_ndc(2)
    jm = JMeshes.create(jnp.asarray(verts), jnp.asarray(faces))
    rng = np.random.default_rng(5)
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((2, SIZE, SIZE, K), (2, SIZE, SIZE, K, 3), (2, SIZE, SIZE, K))]

    def frags(v):
        pix, zbuf, bary, dists = jrm.rasterize_meshes(
            jm.update_padded(v), image_size=SIZE, blur_radius=BLUR, faces_per_pixel=K, bin_size=0,
            perspective_correct=True, clip_barycentric_coords=True, z_clip_value=Z_CLIP,
        )
        return (zbuf, bary, dists), pix

    out, vjp, pix = jax.vjp(jax.jit(frags), jnp.asarray(verts), has_aux=True)
    filled = pix >= 0
    (grad,) = vjp(tuple(jnp.where(filled[..., None] if c.ndim == 5 else filled, c, 0.0) for c in cots))
    return verts, faces, cots, np.asarray(pix), [np.asarray(o) for o in out], np.asarray(grad)


def test_clipped_rasterization_matches_jax(inside_render):
    """ids equal on every slot and all below F; zbuf within 1e-5, bary and
    dists within 1e-4 (bench.py's `_row_ok` for bary: the grazing view's
    sub-faces reach NDC coordinates of ~3e3, and their barycentrics and
    edge distances take a few ulp of those, which XLA's fused
    multiply-adds round otherwise); every depth beyond the plane; the
    grazing view covers pixels with faces the plane cuts."""
    verts, faces, _, want_pix, (wz, wb, wd), _ = inside_render
    mesh = Meshes.create(torch.from_numpy(verts), torch.from_numpy(faces), device=CPU)
    pix, zbuf, bary, dists = trm.rasterize_meshes(
        mesh, image_size=SIZE, blur_radius=BLUR, faces_per_pixel=K, bin_size=0,
        perspective_correct=True, clip_barycentric_coords=True, z_clip_value=Z_CLIP,
    )
    np.testing.assert_array_equal(pix.numpy(), want_pix)
    filled = want_pix >= 0
    F = faces.shape[1]
    assert filled.sum() > 0 and (want_pix[1] - F).max() < F
    fv = verts[np.arange(2)[:, None, None], faces]  # (2, F, 3, 3)
    cut = (fv[..., 2] < Z_CLIP).any(-1).reshape(-1)
    assert (filled & cut[np.maximum(want_pix, 0)])[1].sum() > 0
    np.testing.assert_allclose(zbuf.numpy()[filled], wz[filled], atol=1e-5)
    np.testing.assert_allclose(bary.numpy()[filled], wb[filled], atol=1e-4)
    np.testing.assert_allclose(dists.numpy()[filled], wd[filled], atol=1e-4)
    assert zbuf.numpy()[filled].min() >= Z_CLIP - 1e-4


def test_clipped_gradient_matches_jax(inside_render):
    """The NDC vertex gradient through the plain rasterizer and the clip:
    finite and within 1e-4 of the largest of JAX's."""
    verts, faces, cots, want_pix, _, want = inside_render
    v = torch.from_numpy(verts).requires_grad_(True)
    mesh = Meshes.create(v, torch.from_numpy(faces), device=CPU)
    pix, zbuf, bary, dists = trm.rasterize_meshes(
        mesh, image_size=SIZE, blur_radius=BLUR, faces_per_pixel=K, bin_size=0,
        perspective_correct=True, clip_barycentric_coords=True, z_clip_value=Z_CLIP,
    )
    filled = pix >= 0
    ct = [torch.from_numpy(c) for c in cots]
    loss = (torch.where(filled, zbuf * ct[0], 0.0).sum() + torch.where(filled[..., None], bary * ct[1], 0.0).sum()
            + torch.where(filled, dists * ct[2], 0.0).sum())
    loss.backward()
    got = v.grad.numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_render_from_inside_through_the_camera_plane():
    """tests/test_clip.py::test_render_from_inside through the port (its
    camera plane holds vertices, which project to infinity), with a second
    camera grazing the wall: ids below F, depths beyond the plane, pixels
    covered by faces the plane cuts, and a finite NDC vertex gradient
    through the clip."""
    mesh = ico_sphere(2, device=CPU).extend(2)
    R0, T0 = look_at_view_transform(dist=0.5, device=CPU)
    R1, T1 = look_at_view_transform(**GRAZE, device=CPU)
    cams = FoVPerspectiveCameras.create(R=torch.cat([R0, R1]), T=torch.cat([T0, T1]), znear=0.05, device=CPU)
    ndc = MeshRasterizer(cams, RasterizationSettings(image_size=SIZE)).transform(mesh)
    assert not torch.isfinite(ndc.verts_padded()[0]).all()  # vertices at view z = 0
    v = ndc.verts_padded().clone().requires_grad_(True)
    pix, zbuf, _, _ = trm.rasterize_meshes(
        ndc.update_padded(v), image_size=SIZE, blur_radius=BLUR, faces_per_pixel=2, bin_size=0,
        perspective_correct=True, clip_barycentric_coords=True, z_clip_value=Z_CLIP,
    )
    F = mesh.max_faces
    filled = pix >= 0
    local = torch.where(filled, pix - torch.arange(2)[:, None, None, None] * F, -1)
    assert filled.sum() > 0 and int(local.max()) < F
    assert float(zbuf.detach()[filled].min()) >= Z_CLIP - 1e-4
    fv = ndc.verts_packed()[ndc.faces_packed()].detach()
    cut = (fv[..., 2] < Z_CLIP).any(-1)
    assert int((filled & cut[pix.clamp(min=0)])[1].sum()) > 0
    torch.where(filled, zbuf, 0.0).sum().backward()
    assert torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0
