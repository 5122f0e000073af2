"""Whole renders through the port's entry points, on the CPU.

- The four goldens of tests/test_golden_images.py, rendered by the port
  from the same scenes, at that file's tolerance (atol 0.02 on at most
  0.5 % of pixels).
- SoftPhong renders through JAX and the port from the same state, handed
  over with `pytorch3d_tpu_torch.convert`: one mesh at 128^2, K=4, and a
  batch of two meshes with different face counts (the slice's main path
  at a small size).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pytorch3d_tpu.renderer as jr
from pytorch3d_tpu.renderer.mesh.textures import TexturesVertex as JTexturesVertex
from pytorch3d_tpu.structures import Meshes as JMeshes
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch import convert
from pytorch3d_tpu_torch.renderer import (
    FoVPerspectiveCameras,
    HardGouraudShader,
    HardPhongShader,
    MeshRasterizer,
    MeshRenderer,
    PointLights,
    RasterizationSettings,
    SoftPhongShader,
    SoftSilhouetteShader,
    TexturesVertex,
    look_at_view_transform,
)
from pytorch3d_tpu_torch.utils import ico_sphere, torus

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def assert_image_close(img, name, atol=0.02, max_frac_bad=0.005):
    golden = np.asarray(Image.open(os.path.join(DATA_DIR, name)), np.float32) / 255.0
    got = img[0].detach().numpy()
    assert got.shape == golden.shape, (got.shape, golden.shape)
    bad = (np.abs(got - golden) > atol).mean()
    assert bad <= max_frac_bad, f"{name}: {bad:.4f} of pixels differ"


def _scene():
    R, T = look_at_view_transform(dist=2.7, elev=20.0, azim=30.0, device=CPU)
    cams = FoVPerspectiveCameras.create(R=R, T=T, device=CPU)
    mesh = ico_sphere(3, device=CPU)
    mesh = mesh.replace(textures=TexturesVertex.create(mesh.verts_padded() * 0.5 + 0.5, device=CPU))
    lights = PointLights.create(location=[[0, 0, -3]], device=CPU)
    return cams, mesh, lights


def test_golden_hard_phong():
    cams, mesh, lights = _scene()
    renderer = MeshRenderer(
        MeshRasterizer(cams, RasterizationSettings(image_size=128)),
        HardPhongShader(cameras=cams, lights=lights, device=CPU),
    )
    assert_image_close(renderer(mesh)[..., :3], "golden_sphere_hard_phong.png")


def test_golden_soft_phong():
    cams, mesh, lights = _scene()
    renderer = MeshRenderer(
        MeshRasterizer(cams, RasterizationSettings(image_size=128, blur_radius=1e-4, faces_per_pixel=4)),
        SoftPhongShader(cameras=cams, lights=lights, device=CPU),
    )
    assert_image_close(renderer(mesh)[..., :3], "golden_sphere_soft_phong.png")


def test_golden_silhouette():
    cams, mesh, _ = _scene()
    renderer = MeshRenderer(
        MeshRasterizer(cams, RasterizationSettings(image_size=128, blur_radius=2e-4, faces_per_pixel=8)),
        SoftSilhouetteShader(),
    )
    img = renderer(mesh)[..., 3:4]
    assert_image_close(img.repeat(1, 1, 1, 3), "golden_sphere_silhouette.png")


def test_golden_torus_gouraud():
    cams, _, lights = _scene()
    tor = torus(0.4, 1.2, 12, 24, device=CPU)
    colors = torch.ones_like(tor.verts_padded()) * torch.tensor([0.8, 0.6, 0.3])
    tor = tor.replace(textures=TexturesVertex.create(colors, device=CPU))
    renderer = MeshRenderer(
        MeshRasterizer(cams, RasterizationSettings(image_size=128)),
        HardGouraudShader(cameras=cams, lights=lights, device=CPU),
    )
    assert_image_close(renderer(tor)[..., :3], "golden_torus_gouraud.png")


def _jax_state(meshes_j, feats, image_size, K, azim):
    R, T = jr.look_at_view_transform(dist=2.7, elev=20.0, azim=azim)
    cams = jr.FoVPerspectiveCameras.create(R=R, T=T)
    lights = jr.PointLights.create(location=[[0, 0, -3]])
    materials = jr.Materials.create()
    meshes_j = meshes_j.replace(textures=JTexturesVertex.create(feats))
    settings = dict(image_size=image_size, blur_radius=1e-4, faces_per_pixel=K)
    renderer = jr.MeshRenderer(
        jr.MeshRasterizer(cams, jr.RasterizationSettings(**settings)),
        jr.SoftPhongShader(cameras=cams, lights=lights, materials=materials),
    )
    img_j = np.asarray(renderer(meshes_j))

    # The port, built from the JAX objects' arrays only.
    a = np.asarray
    meshes_t = convert.meshes_from_numpy(
        a(meshes_j.verts_padded()), a(meshes_j.faces_padded()),
        num_verts_per_mesh=a(meshes_j.num_verts_per_mesh()),
        num_faces_per_mesh=a(meshes_j.num_faces_per_mesh()),
        verts_features=a(meshes_j.textures.verts_features_padded()), device=CPU,
    )
    cams_t = convert.fov_perspective_cameras_from_numpy(
        a(cams.R), a(cams.T), a(cams.znear), a(cams.zfar), a(cams.aspect_ratio), a(cams.fov),
        degrees=cams.degrees, device=CPU,
    )
    lights_t = convert.point_lights_from_numpy(
        a(lights.ambient_color), a(lights.diffuse_color), a(lights.specular_color), a(lights.location), device=CPU
    )
    materials_t = convert.materials_from_numpy(
        a(materials.ambient_color), a(materials.diffuse_color), a(materials.specular_color),
        a(materials.shininess), device=CPU,
    )
    renderer_t = MeshRenderer(
        MeshRasterizer(cams_t, RasterizationSettings(**settings)),
        SoftPhongShader(cameras=cams_t, lights=lights_t, materials=materials_t, device=CPU),
    )
    img_t = renderer_t(meshes_t).numpy()
    return img_t, img_j


def _assert_render_close(img_t, img_j):
    assert img_t.shape == img_j.shape
    assert np.isfinite(img_t).all()
    # Where both pick the same faces the images agree to float32 rounding;
    # a z tie within rounding may flip a pixel: max abs diff <= 1e-4 on
    # >= 99.9 % of pixels.
    diff = np.abs(img_t - img_j).max(axis=-1)
    assert (diff <= 1e-4).mean() >= 0.999, (diff <= 1e-4).mean()


def test_soft_phong_matches_jax_from_same_state():
    mesh = j_ico_sphere(3)
    img_t, img_j = _jax_state(mesh, mesh.verts_padded() * 0.5 + 0.5, 128, 4, azim=30.0)
    assert (img_t[..., 3] > 0).sum() > 1000
    _assert_render_close(img_t, img_j)


@pytest.mark.parametrize("azim", [0.0, 135.0])
def test_batch_of_two_meshes_matches_jax(azim):
    ico, tor = j_ico_sphere(2), j_torus(0.4, 1.2, 12, 24)
    meshes = JMeshes.create(
        [ico.verts_padded()[0], tor.verts_padded()[0]], [ico.faces_padded()[0], tor.faces_padded()[0]]
    )
    feats = meshes.verts_padded() / 3.2 + 0.5
    img_t, img_j = _jax_state(meshes, feats, 64, 4, azim=azim)
    assert img_t.shape[0] == 2 and ((img_t[..., 3] > 0).sum(axis=(1, 2)) > 100).all()
    _assert_render_close(img_t, img_j)
