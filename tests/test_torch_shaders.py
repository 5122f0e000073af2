"""The port's remaining shaders, lights, `flat_shading` and `SplatterBlender`
against the JAX package, on the CPU.

One JAX render (module-scoped) gives the fragments of two views of a
vertex-coloured ico_sphere(2) at 32^2, K=4, blur 1e-4; both packages shade
those same fragments (the port's from numpy), with the same camera,
lights and materials converted through `pytorch3d_tpu_torch.convert`.
Each shader's image and its gradient with respect to the verts (the
fragments held fixed) are compared; the depth shaders' with respect to
zbuf and dists, with a batched camera's zfar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer as jr
from pytorch3d_tpu.renderer.mesh.rasterizer import Fragments as JFragments
from pytorch3d_tpu.renderer.mesh.textures import TexturesVertex as JTexturesVertex
from pytorch3d_tpu.renderer.splatter_blend import SplatterBlender as JSplatterBlender
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu_torch import convert
from pytorch3d_tpu_torch.renderer import (
    BlendParams,
    HardDepthShader,
    HardFlatShader,
    SoftDepthShader,
    SoftGouraudShader,
    SplatterBlender,
    SplatterPhongShader,
    flat_shading,
)
from pytorch3d_tpu_torch.renderer.mesh.rasterizer import Fragments
from pytorch3d_tpu_torch.renderer.mesh.shader import TexturedSoftPhongShader

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
SIZE, K, BLUR = 32, 4, 1e-4
a = np.asarray


@pytest.fixture(scope="module")
def scene():
    jmesh = j_ico_sphere(2)
    v = jmesh.verts_padded()
    jmesh = jmesh.replace(textures=JTexturesVertex.create(v * 0.5 + 0.5)).extend(2)
    R, T = jr.look_at_view_transform(dist=2.7, elev=0.0, azim=jnp.asarray([0.0, 90.0]))
    jcams = jr.FoVPerspectiveCameras.create(R=R, T=T, zfar=jnp.asarray([50.0, 80.0]))
    settings = jr.RasterizationSettings(image_size=SIZE, blur_radius=BLUR, faces_per_pixel=K)
    jfrags = jax.jit(lambda v: jr.MeshRasterizer(jcams, settings)(jmesh.update_padded(v)))(jmesh.verts_padded())
    tmesh = convert.meshes_from_numpy(
        a(jmesh.verts_padded()), a(jmesh.faces_padded()),
        verts_features=a(jmesh.textures.verts_features_padded()), device=CPU,
    )
    tcams = convert.fov_perspective_cameras_from_numpy(
        a(jcams.R), a(jcams.T), a(jcams.znear), a(jcams.zfar), a(jcams.aspect_ratio), a(jcams.fov), device=CPU
    )
    tfrags = Fragments(*(torch.from_numpy(np.array(getattr(jfrags, f)))
                         for f in ("pix_to_face", "zbuf", "bary_coords", "dists")))
    return jmesh, jcams, jfrags, tmesh, tcams, tfrags


def _lights(kind):
    """The same light in both packages."""
    if kind == "directional":
        j = jr.DirectionalLights.create(direction=((0.3, 0.5, -1.0),), diffuse_color=((0.6, 0.5, 0.4),))
        return j, convert.directional_lights_from_numpy(
            a(j.ambient_color), a(j.diffuse_color), a(j.specular_color), a(j.direction), device=CPU)
    if kind == "ambient":
        j = jr.AmbientLights.create(ambient_color=((0.9, 0.7, 0.5),))
        return j, convert.ambient_lights_from_numpy(a(j.ambient_color), device=CPU)
    j = jr.PointLights.create(location=((0.0, 0.0, -3.0),))
    return j, convert.point_lights_from_numpy(
        a(j.ambient_color), a(j.diffuse_color), a(j.specular_color), a(j.location), device=CPU)


@pytest.mark.parametrize("kind", ["directional", "ambient"])
def test_lights_match_jax(kind):
    """diffuse and specular on seeded points and normals within 1e-6; clone
    gives equal, separate tensors."""
    rng = np.random.default_rng(0)
    pts, nrm, cam = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 3), (2, 5, 3), (2, 3)))
    j, t = _lights(kind)
    for name, args in (("diffuse", ()), ("specular", (cam, 10.0))):
        want = getattr(j, name)(jnp.asarray(nrm), jnp.asarray(pts), *[jnp.asarray(x) for x in args])
        got = getattr(t, name)(torch.from_numpy(nrm), torch.from_numpy(pts),
                               *[torch.as_tensor(x) for x in args])
        np.testing.assert_allclose(got.numpy(), a(want), atol=1e-6)
    c = t.clone()
    assert torch.equal(c.ambient_color, t.ambient_color) and c.ambient_color is not t.ambient_color


def _vertex_vjp(jfn, tfn, jmesh, tmesh, seed, jit=True):
    """(port, JAX) outputs and their vertex gradients for seeded cotangents
    (the JAX side jitted where it traces: eager it takes seconds)."""
    f = lambda v: jfn(jmesh.update_padded(v))  # noqa: E731
    want, vjp = jax.vjp(jax.jit(f) if jit else f, jmesh.verts_padded())
    ct = np.random.default_rng(seed).standard_normal(want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    v = tmesh.verts_padded().clone().requires_grad_(True)
    got = tfn(tmesh.update_padded(v))
    if got.requires_grad:
        got.backward(torch.from_numpy(ct))
    g = torch.zeros_like(v) if v.grad is None else v.grad  # ambient light only: no path to the verts
    return got.detach().numpy(), a(want), g.numpy(), a(want_g)


def test_flat_shading_matches_jax(scene):
    """Per-face colours within 1e-5, their vertex gradient within 1e-4 of
    the largest."""
    jmesh, jcams, jfrags, tmesh, tcams, tfrags = scene
    jl, tl = _lights("directional")
    jmat, tmat = jr.Materials.create(), convert.materials_from_numpy(
        *(a(getattr(jr.Materials.create(), f)) for f in ("ambient_color", "diffuse_color", "specular_color", "shininess")),
        device=CPU)
    got, want, g, wg = _vertex_vjp(
        lambda m: jr.flat_shading(m, jfrags, jl, jcams, jmat, m.sample_textures(jfrags)),
        lambda m: flat_shading(m, tfrags, tl, tcams, tmat, m.sample_textures(tfrags)),
        jmesh, tmesh, 1,
    )
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(g, wg, atol=1e-4 * np.abs(wg).max())


SHADERS = {
    "hard_flat_directional": ("HardFlatShader", HardFlatShader, "directional"),
    "soft_gouraud_ambient": ("SoftGouraudShader", SoftGouraudShader, "ambient"),
    "soft_gouraud_directional": ("SoftGouraudShader", SoftGouraudShader, "directional"),
    "splatter_phong_point": ("SplatterPhongShader", SplatterPhongShader, "point"),
}


@pytest.mark.parametrize("case", list(SHADERS))
def test_shader_matches_jax(scene, case):
    """The image within 1e-5 and its vertex gradient within 1e-4 of the
    largest (finite; the ambient-only Gouraud's is 0 in both).  The
    splatter runs at sigma 0.5 pixels: at BlendParams' default 1e-4 its
    gradient is 2 (cx / sigma^2) times a splat's offset from the pixel
    centre, which is the last bits of the projection, whose rounding the
    two packages do not share."""
    jmesh, jcams, jfrags, tmesh, tcams, tfrags = scene
    jname, tcls, light = SHADERS[case]
    jl, tl = _lights(light)
    sigma = dict(blend_params=jr.BlendParams(sigma=0.5)) if light == "point" else {}
    js = getattr(jr, jname)(cameras=jcams, lights=jl, **sigma)
    ts = tcls(cameras=tcams, lights=tl, device=CPU, **{k: BlendParams(sigma=0.5) for k in sigma})
    got, want, g, wg = _vertex_vjp(lambda m: js(jfrags, m), lambda m: ts(tfrags, m), jmesh, tmesh, 2,
                                   jit=light != "point")  # JAX's splatter reads a float on the host
    assert got.shape == (2, SIZE, SIZE, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, wg, atol=1e-4 * max(np.abs(wg).max(), 1e-30))


def test_textured_soft_phong_is_soft_phong(scene):
    """The deprecated alias warns and renders what SoftPhongShader does."""
    jmesh, jcams, jfrags, tmesh, tcams, tfrags = scene
    from pytorch3d_tpu_torch.renderer import SoftPhongShader

    with pytest.warns(PendingDeprecationWarning):
        alias = TexturedSoftPhongShader(cameras=tcams, device=CPU)
    assert torch.equal(alias(tfrags, tmesh), SoftPhongShader(cameras=tcams, device=CPU)(tfrags, tmesh))


@pytest.mark.parametrize("name,cls", [("HardDepthShader", HardDepthShader), ("SoftDepthShader", SoftDepthShader)])
def test_depth_shader_matches_jax(scene, name, cls):
    """(N, H, W, 1) depth with each camera's own zfar as background, within
    1e-5; gradients with respect to zbuf and dists within 1e-5 + 1e-5
    relative (the dists' reach 1 / sigma = 1e4)."""
    jmesh, jcams, jfrags, tmesh, tcams, tfrags = scene
    js, ts = getattr(jr, name)(cameras=jcams), cls(cameras=tcams, device=CPU)

    def jfn(z, d):
        return js(JFragments(pix_to_face=jfrags.pix_to_face, zbuf=z, bary_coords=jfrags.bary_coords, dists=d), jmesh)

    want, vjp = jax.vjp(jax.jit(jfn), jfrags.zbuf, jfrags.dists)
    ct = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)
    wz, wd = vjp(jnp.asarray(ct))
    z, d = tfrags.zbuf.clone().requires_grad_(True), tfrags.dists.clone().requires_grad_(True)
    got = ts(Fragments(pix_to_face=tfrags.pix_to_face, zbuf=z, bary_coords=tfrags.bary_coords, dists=d), tmesh)
    got.backward(torch.from_numpy(ct))
    assert got.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.detach().numpy(), a(want), atol=1e-5)
    empty = tfrags.pix_to_face[..., 0] < 0
    np.testing.assert_allclose(got.detach()[empty & (torch.arange(2)[:, None, None] == 1)][..., 0].numpy(), 80.0,
                               rtol=1e-6 if name == "HardDepthShader" else 1e-2)
    np.testing.assert_allclose(z.grad.numpy(), a(wz), atol=1e-5, rtol=1e-5)
    gd = np.zeros_like(a(wd)) if d.grad is None else d.grad.numpy()
    np.testing.assert_allclose(gd, a(wd), atol=1e-5, rtol=1e-5)


def test_splatter_blender_matches_jax():
    """The blender alone on seeded colours, screen positions around the
    pixel centres, two layers with depth ties and empty slots: the image
    within 1e-6, the gradients with respect to colours and positions
    within 1e-5."""
    rng = np.random.default_rng(4)
    N, H, W, Kb = 2, SIZE, SIZE, K  # the scene's shapes: JAX compiles each eager op once per shape
    colors = rng.uniform(size=(N, H, W, Kb, 4)).astype(np.float32)
    rows, cols = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    centres = -np.stack([cols + 0.5, rows + 0.5], -1)[None, :, :, None].astype(np.float32)
    coords = (centres + rng.uniform(-0.3, 0.3, (N, H, W, Kb, 2))).astype(np.float32)
    pix = np.where(rng.uniform(size=(N, H, W, Kb)) < 0.3, -1, 0)
    zbuf = np.round(rng.uniform(1.0, 3.0, (N, H, W, Kb)), 1).astype(np.float32)  # ties across neighbours
    bp = jr.BlendParams(sigma=0.5, background_color=(0.2, 0.3, 0.4))
    jf = JFragments(pix_to_face=jnp.asarray(pix), zbuf=jnp.asarray(zbuf), bary_coords=None, dists=None)
    want, vjp = jax.vjp(lambda c, p: JSplatterBlender()(c, p, jf, bp), jnp.asarray(colors), jnp.asarray(coords))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    wc, wp = vjp(jnp.asarray(ct))
    c, p = torch.from_numpy(colors).requires_grad_(True), torch.from_numpy(coords).requires_grad_(True)
    tf = Fragments(pix_to_face=torch.from_numpy(pix), zbuf=torch.from_numpy(zbuf), bary_coords=None, dists=None)
    got = SplatterBlender()(c, p, tf, BlendParams(sigma=0.5, background_color=(0.2, 0.3, 0.4)))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), a(want), atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), a(wc), atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), a(wp), atol=1e-5)
