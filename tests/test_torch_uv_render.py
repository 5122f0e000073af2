"""The slice end to end on the CPU: a UV-textured sphere rendered by the
port and by the JAX package from the same numpy state.

- `MeshRenderer(MeshRasterizer, SoftPhongShader)` renders ico_sphere(2)
  with per-face-corner UVs (a spherical projection, u unwrapped inside
  each face) into a seeded 16^2 map, and with a seeded R=4 atlas, for two
  views at 32^2, K=4, blur 1e-4; the images, and the UV image's gradient
  with respect to the map and the verts, against JAX's (one jitted JAX
  render, module-scoped).
- `sample_points_from_meshes(return_textures=True)` on JAX's draws, and
  on the port's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer as jr
from pytorch3d_tpu.ops import sample_points_from_meshes as j_sample
from pytorch3d_tpu.renderer.mesh.textures import TexturesAtlas as JTexturesAtlas
from pytorch3d_tpu.renderer.mesh.textures import TexturesUV as JTexturesUV
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import convert
from pytorch3d_tpu_torch.ops import sample_points_from_meshes
from pytorch3d_tpu_torch.ops.sample_points_from_meshes import sample_points_with_draws
from pytorch3d_tpu_torch.renderer import MeshRasterizer, MeshRenderer, RasterizationSettings, SoftPhongShader

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
SIZE, K, BLUR, HM, R = 32, 4, 1e-4, 16, 4
a = np.asarray


def sphere_uvs(verts, faces):
    """(F*3, 2) per-corner UVs of a unit sphere and (F, 3) faces_uvs: u the
    longitude, unwrapped inside each face so that none straddles the seam,
    v the latitude."""
    fv = verts[faces]  # (F, 3, 3)
    u = np.arctan2(fv[..., 0], fv[..., 2]) / (2 * np.pi) + 0.5
    u = np.where(u - u[:, :1] > 0.5, u - 1.0, np.where(u - u[:, :1] < -0.5, u + 1.0, u))
    v = np.arcsin(np.clip(fv[..., 1], -1.0, 1.0)) / np.pi + 0.5
    uvs = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    return uvs, np.arange(uvs.shape[0], dtype=np.int32).reshape(-1, 3)


def _state():
    mesh = j_ico_sphere(2)
    verts, faces = np.array(mesh.verts_padded()[0]), np.array(mesh.faces_padded()[0])
    uvs, faces_uvs = sphere_uvs(verts, faces)
    rng = np.random.default_rng(0)
    maps = rng.uniform(0.0, 1.0, (1, HM, HM, 3)).astype(np.float32)
    atlas = rng.uniform(0.0, 1.0, (1, faces.shape[0], R, R, 3)).astype(np.float32)
    return verts, faces, uvs, faces_uvs, maps, atlas


def _jax_mesh(verts, faces, textures):
    return JMeshes.create(jnp.asarray(verts)[None], jnp.asarray(faces)[None]).replace(textures=textures)


def _cameras():
    R_, T_ = jr.look_at_view_transform(dist=2.7, elev=0.0, azim=jnp.asarray([0.0, 90.0]))
    return jr.FoVPerspectiveCameras.create(R=R_, T=T_)


@pytest.fixture(scope="module")
def jax_render():
    """JAX's UV and atlas images and the UV image's vjp with respect to the
    verts and the map, for a seeded cotangent."""
    verts, faces, uvs, faces_uvs, maps, atlas = _state()
    cams = _cameras()
    renderer = jr.MeshRenderer(
        jr.MeshRasterizer(cams, jr.RasterizationSettings(image_size=SIZE, blur_radius=BLUR, faces_per_pixel=K)),
        jr.SoftPhongShader(cameras=cams, lights=jr.PointLights.create(location=((0.0, 0.0, -3.0),))),
    )
    atlas_mesh = _jax_mesh(verts, faces, JTexturesAtlas.create(jnp.asarray(atlas))).extend(2)

    def render(v, m):
        tex = JTexturesUV.create(m, jnp.asarray(faces_uvs)[None], jnp.asarray(uvs)[None])
        return renderer(_jax_mesh(v, faces, tex).extend(2)), renderer(atlas_mesh)

    (img, img_atlas), vjp = jax.vjp(jax.jit(render), jnp.asarray(verts), jnp.asarray(maps))
    ct = np.random.default_rng(1).standard_normal(img.shape).astype(np.float32)
    gv, gm = vjp((jnp.asarray(ct), jnp.zeros_like(img_atlas)))
    return dict(img=a(img), img_atlas=a(img_atlas), ct=ct, gv=a(gv), gm=a(gm), cams=cams)


def _port_renderer(cams):
    tcams = convert.fov_perspective_cameras_from_numpy(
        a(cams.R), a(cams.T), a(cams.znear), a(cams.zfar), a(cams.aspect_ratio), a(cams.fov), device=CPU
    )
    lights = convert.point_lights_from_numpy(
        *(a(getattr(jr.PointLights.create(location=((0.0, 0.0, -3.0),)), f))
          for f in ("ambient_color", "diffuse_color", "specular_color", "location")), device=CPU)
    return MeshRenderer(
        MeshRasterizer(tcams, RasterizationSettings(image_size=SIZE, blur_radius=BLUR, faces_per_pixel=K)),
        SoftPhongShader(cameras=tcams, lights=lights, device=CPU),
    )


def _assert_render_close(got, want, share=0.999):
    """Where both pick the same faces the images agree to float32 rounding;
    a z tie within rounding may flip a pixel: 1e-4 on >= `share` of pixels."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert ((got[..., 3] > 0).sum(axis=(1, 2)) > 100).all()
    assert (np.abs(got - want).max(axis=-1) <= 1e-4).mean() >= share


def test_uv_render_and_gradients_match_jax(jax_render):
    """The UV image as above; its gradients with respect to the map and the
    verts within 1e-4 of the largest of JAX's."""
    verts, faces, uvs, faces_uvs, maps, _ = _state()
    v = torch.from_numpy(verts[None]).requires_grad_(True)
    m = torch.from_numpy(maps).requires_grad_(True)
    mesh = convert.meshes_from_numpy(verts[None], faces[None], device=CPU)
    tex = convert.textures_uv_from_numpy(maps, faces_uvs[None], uvs[None], device=CPU).replace(_maps_padded=m)
    img = _port_renderer(jax_render["cams"])(mesh.update_padded(v).replace(textures=tex).extend(2))
    _assert_render_close(img.detach().numpy(), jax_render["img"])
    img.backward(torch.from_numpy(jax_render["ct"]))
    for got, want in ((m.grad.numpy(), jax_render["gm"]), (v.grad.numpy(), jax_render["gv"])):
        assert np.isfinite(got).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want.reshape(got.shape), atol=1e-4 * np.abs(want).max())


def test_atlas_render_matches_jax(jax_render):
    """1e-4 on >= 99.5 % of pixels.  The atlas picks a texel by truncating
    bary * R; in the blur band outside a face the clipped barycentrics lie
    on the patch's diagonal, where the pick turns on their last bits, which
    the two packages' camera transforms round differently (on JAX's own
    fragments the texels are equal: tests/test_torch_textures.py)."""
    verts, faces, _, _, _, atlas = _state()
    mesh = convert.meshes_from_numpy(verts[None], faces[None], device=CPU)
    mesh = mesh.replace(textures=convert.textures_atlas_from_numpy(atlas, device=CPU)).extend(2)
    with torch.no_grad():
        img = _port_renderer(jax_render["cams"])(mesh)
    _assert_render_close(img.numpy(), jax_render["img_atlas"], share=0.995)


def jax_draws(jmesh, num_samples, key):
    """The face ids and (u, v) that JAX's `sample_points_from_meshes` draws
    from `key` (its sample_points_from_meshes.py:46-65)."""
    key_face, key_w = jax.random.split(key)
    verts, faces = jmesh.verts_padded(), jnp.maximum(jmesh.faces_padded(), 0)
    v0, v1, v2 = (jnp.take_along_axis(verts, faces[..., c : c + 1].repeat(3, -1), axis=1) for c in range(3))
    n = jnp.cross(v1 - v0, v2 - v0)
    fmask = jmesh.faces_padded_mask()
    areas = jnp.where(fmask, 0.5 * jnp.sqrt(jnp.sum(n * n, axis=-1)), 0.0)
    logits = jnp.where(fmask, jnp.log(jnp.clip(areas, 1e-30)), -jnp.inf)
    idx = jax.random.categorical(key_face, logits[:, None, :], axis=-1, shape=(len(jmesh), num_samples))
    u, v = jax.random.uniform(key_w, (2, len(jmesh), num_samples), dtype=verts.dtype)
    return np.array(idx), np.array(u), np.array(v)


def test_sample_points_with_textures_matches_jax():
    """Points, normals and UV texels at JAX's draws within 1e-6."""
    verts, faces, uvs, faces_uvs, maps, _ = _state()
    jmesh = _jax_mesh(verts, faces, JTexturesUV.create(jnp.asarray(maps), jnp.asarray(faces_uvs)[None], jnp.asarray(uvs)[None]))
    key = jax.random.PRNGKey(2)
    want = j_sample(jmesh, num_samples=200, return_normals=True, return_textures=True, key=key)
    idx, u, v = jax_draws(jmesh, 200, key)
    mesh = convert.meshes_from_numpy(verts[None], faces[None], device=CPU).replace(
        textures=convert.textures_uv_from_numpy(maps, faces_uvs[None], uvs[None], device=CPU))
    got = sample_points_with_draws(mesh, *(torch.from_numpy(x) for x in (idx, u, v)),
                                   return_normals=True, return_textures=True)
    assert len(got) == 3 and got[2].shape == (1, 200, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), a(w), atol=1e-6)


def test_sample_points_with_textures_draws_its_own():
    verts, faces, uvs, faces_uvs, maps, _ = _state()
    mesh = convert.meshes_from_numpy(verts[None], faces[None], device=CPU)
    with pytest.raises(ValueError):
        sample_points_from_meshes(mesh, 10, return_textures=True, generator=torch.Generator().manual_seed(0))
    mesh = mesh.replace(textures=convert.textures_uv_from_numpy(maps, faces_uvs[None], uvs[None], device=CPU))
    pts, tex = sample_points_from_meshes(mesh, 50, return_textures=True, generator=torch.Generator().manual_seed(0))
    assert pts.shape == (1, 50, 3) and tex.shape == (1, 50, 3)
    assert float(tex.min()) >= 0.0 and float(tex.max()) <= 1.0
