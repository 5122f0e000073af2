"""The port's training path against the JAX package: a few optimiser steps
of the repo's two mesh-fitting loops at a small size.

- render-fit, examples/fit_textured_mesh.py:31-95: targets rendered with
  HardPhongShader (K=1), the source with SoftPhongShader (K=4 here, blur
  log(1/1e-4 - 1) * 1e-4), loss = rgb MSE + silhouette MSE + 0.5 edge +
  0.05 laplacian, Adam(5e-3) on the deform and colour parameters.
- chamfer-fit, examples/deform_source_mesh.py:60-93: chamfer to points
  sampled from a torus + 1.0 edge + 0.1 uniform laplacian + 0.01 normal
  consistency, Adam(1e-2); each step's sampling draws are JAX's, fed to the
  port.

Both run on the CPU: the port through its plain versions, JAX through its
XLA path (bin_size=0), `optax.adam` against `torch.optim.Adam` (the same
defaults and the same eps placement).  Tolerances: the loss trajectory
within rtol 1e-4 and the final deform within atol 1e-5, as float32 sums
in another order compound over the steps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pytorch3d_tpu.loss import (
    chamfer_distance as j_chamfer,
    mesh_edge_loss as j_edge,
    mesh_laplacian_smoothing as j_laplacian,
    mesh_normal_consistency as j_normal,
)
from pytorch3d_tpu.ops.sample_points_from_meshes import sample_points_from_meshes as j_sample
from pytorch3d_tpu.renderer import (
    FoVPerspectiveCameras as JCameras,
    HardPhongShader as JHardPhong,
    MeshRasterizer as JRasterizer,
    MeshRenderer as JRenderer,
    PointLights as JLights,
    RasterizationSettings as JSettings,
    SoftPhongShader as JSoftPhong,
    look_at_view_transform as j_look_at,
)
from pytorch3d_tpu.renderer.mesh.textures import TexturesVertex as JTexturesVertex
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch.loss import (
    chamfer_distance,
    mesh_edge_loss,
    mesh_laplacian_smoothing,
    mesh_normal_consistency,
)
from pytorch3d_tpu_torch.ops.sample_points_from_meshes import sample_points_with_draws
from pytorch3d_tpu_torch.renderer import (
    FoVPerspectiveCameras,
    HardPhongShader,
    MeshRasterizer,
    MeshRenderer,
    PointLights,
    RasterizationSettings,
    SoftPhongShader,
    TexturesVertex,
    look_at_view_transform,
)
from pytorch3d_tpu_torch.structures import Meshes
from test_torch_losses import jax_draws

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
STEPS = 5
SIZE = 32
VIEWS = 2
SOFT_K = 4
BLUR = float(np.log(1.0 / 1e-4 - 1.0) * 1e-4)


def _jitter(jmesh, seed):
    """`jmesh` with seeded noise on its verts.  From the symmetric
    icosphere the regularizers' gradients are rounding noise, whose sign
    Adam's first steps turn into a full +-lr move; noise makes them real."""
    rng = np.random.default_rng(seed)
    v = jmesh.verts_padded()
    return jmesh.update_padded(v + jnp.asarray(0.02 * rng.standard_normal(v.shape), jnp.float32))


def _port_meshes(jmesh, textures=None):
    return Meshes.create(np.array(jmesh.verts_padded()), np.array(jmesh.faces_padded()),
                         textures=textures, device=CPU)


def _assert_trajectories(got_losses, want_losses, got_deform, want_deform):
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    np.testing.assert_allclose(got_deform, want_deform, atol=1e-5)


def test_render_fit_matches_jax():
    # Scene: the example's cameras and lights, a small torus and ico_sphere(2).
    target_j = j_torus(0.4, 0.9, 8, 16)
    tv = target_j.verts_padded()
    colors = np.array((tv - tv.min(axis=1)) / (tv.max(axis=1) - tv.min(axis=1)))
    azims = np.linspace(-180.0, 180.0, VIEWS, endpoint=False).astype(np.float32)
    src_j = _jitter(j_ico_sphere(2), seed=5)

    def j_renderer(cameras, soft):
        lights = JLights.create(location=[[0.0, 2.0, -3.0]])
        if soft:
            settings = JSettings(image_size=SIZE, faces_per_pixel=SOFT_K, blur_radius=BLUR, bin_size=0)
            return JRenderer(JRasterizer(cameras, settings), JSoftPhong(cameras=cameras, lights=lights))
        settings = JSettings(image_size=SIZE, faces_per_pixel=1, bin_size=0)
        return JRenderer(JRasterizer(cameras, settings), JHardPhong(cameras=cameras, lights=lights))

    def t_renderer(cameras, soft):
        lights = PointLights.create(location=[[0.0, 2.0, -3.0]], device=CPU)
        if soft:
            settings = RasterizationSettings(image_size=SIZE, faces_per_pixel=SOFT_K, blur_radius=BLUR, bin_size=0)
            return MeshRenderer(MeshRasterizer(cameras, settings), SoftPhongShader(cameras=cameras, lights=lights, device=CPU))
        settings = RasterizationSettings(image_size=SIZE, faces_per_pixel=1, bin_size=0)
        return MeshRenderer(MeshRasterizer(cameras, settings), HardPhongShader(cameras=cameras, lights=lights, device=CPU))

    # JAX, as the example does it.
    R, T = j_look_at(dist=2.8, elev=25.0, azim=jnp.asarray(azims))
    jcams = JCameras.create(R=R, T=T, fov=60.0)
    jtarget = target_j.replace(textures=JTexturesVertex.create(jnp.asarray(colors)))
    jtarget_images = j_renderer(jcams, False)(jtarget.extend(VIEWS), cameras=jcams)[..., :3]
    jsoft = j_renderer(jcams, True)
    params = {"deform": jnp.zeros_like(src_j.verts_padded()), "colors": jnp.full(src_j.verts_padded().shape, 0.5)}
    opt = optax.adam(5e-3)
    state = opt.init(params)

    def j_loss(p):
        mesh = src_j.update_padded(src_j.verts_padded() + p["deform"])
        mesh = mesh.replace(textures=JTexturesVertex.create(jax.nn.sigmoid(4.0 * (p["colors"] - 0.5))))
        preds = jsoft(mesh.extend(VIEWS), cameras=jcams)
        tgt_sil = (jtarget_images.sum(-1) < 2.95).astype(jnp.float32)
        return (
            jnp.mean((preds[..., :3] - jtarget_images) ** 2) + jnp.mean((preds[..., 3] - tgt_sil) ** 2)
            + 0.5 * j_edge(mesh) + 0.05 * j_laplacian(mesh)
        )

    j_step = jax.jit(jax.value_and_grad(j_loss))
    j_losses = []
    for _ in range(STEPS):
        loss, g = j_step(params)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(loss))

    # The port, on the same numbers.
    R, T = look_at_view_transform(dist=2.8, elev=25.0, azim=torch.from_numpy(azims), device=CPU)
    cams = FoVPerspectiveCameras.create(R=R, T=T, fov=60.0, device=CPU)
    target = _port_meshes(target_j, TexturesVertex.create(colors, device=CPU))
    target_images = t_renderer(cams, False)(target.extend(VIEWS), cameras=cams)[..., :3]
    np.testing.assert_allclose(target_images.numpy(), np.asarray(jtarget_images), atol=1e-5)
    soft = t_renderer(cams, True)
    src = _port_meshes(src_j)
    deform = torch.zeros_like(src.verts_padded(), requires_grad=True)
    vcolors = torch.full(src.verts_padded().shape, 0.5, requires_grad=True)
    optimizer = torch.optim.Adam([deform, vcolors], lr=5e-3)
    tgt_sil = (target_images.sum(-1) < 2.95).float()
    t_losses = []
    for _ in range(STEPS):
        optimizer.zero_grad()
        mesh = src.update_padded(src.verts_padded() + deform)
        mesh = mesh.replace(textures=TexturesVertex.create(torch.sigmoid(4.0 * (vcolors - 0.5)), device=CPU))
        preds = soft(mesh.extend(VIEWS), cameras=cams)
        loss = (
            torch.mean((preds[..., :3] - target_images) ** 2) + torch.mean((preds[..., 3] - tgt_sil) ** 2)
            + 0.5 * mesh_edge_loss(mesh) + 0.05 * mesh_laplacian_smoothing(mesh)
        )
        loss.backward()
        optimizer.step()
        t_losses.append(loss.item())

    assert all(math.isfinite(v) for v in t_losses) and t_losses[-1] < t_losses[0]
    _assert_trajectories(t_losses, j_losses, deform.detach().numpy(), np.asarray(params["deform"]))


def test_chamfer_fit_matches_jax():
    src_j, tgt_j = j_ico_sphere(2), j_torus(0.4, 0.9, 8, 16)
    samples = 500
    tgt_pts = j_sample(tgt_j, num_samples=samples, key=jax.random.PRNGKey(0))

    def j_loss(dv, key):
        mesh = src_j.update_padded(src_j.verts_padded() + dv)
        pts = j_sample(mesh, num_samples=samples, key=key)
        cd, _ = j_chamfer(pts, tgt_pts)
        return cd + 1.0 * j_edge(mesh) + 0.1 * j_laplacian(mesh, method="uniform") + 0.01 * j_normal(mesh)

    src = _port_meshes(src_j)
    tgt = torch.from_numpy(np.array(tgt_pts))
    deform_j = jnp.zeros_like(src_j.verts_padded())
    opt = optax.adam(1e-2)
    state = opt.init(deform_j)
    deform = torch.zeros_like(src.verts_padded(), requires_grad=True)
    optimizer = torch.optim.Adam([deform], lr=1e-2)
    key = jax.random.PRNGKey(7)
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        # The draws JAX makes from this step's mesh and key, fed to the port.
        idx, u, v = jax_draws(src_j.update_padded(src_j.verts_padded() + deform_j), samples, sub)
        loss, g = jax.value_and_grad(j_loss)(deform_j, sub)
        updates, state = opt.update(g, state)
        deform_j = optax.apply_updates(deform_j, updates)
        j_losses.append(float(loss))

        optimizer.zero_grad()
        mesh = src.update_padded(src.verts_padded() + deform)
        pts = sample_points_with_draws(mesh, torch.from_numpy(idx), torch.from_numpy(u), torch.from_numpy(v))
        cd, _ = chamfer_distance(pts, tgt)
        loss_t = (
            cd + 1.0 * mesh_edge_loss(mesh) + 0.1 * mesh_laplacian_smoothing(mesh, method="uniform")
            + 0.01 * mesh_normal_consistency(mesh)
        )
        loss_t.backward()
        optimizer.step()
        t_losses.append(loss_t.item())

    assert all(math.isfinite(v) for v in t_losses) and t_losses[-1] < t_losses[0]
    _assert_trajectories(t_losses, j_losses, deform.detach().numpy(), np.asarray(deform_j))
