"""The port's points-fit training loop against the JAX package at a small
size: a few Adam steps that fit a point cloud to the colored-points scene.

- Targets: the scene of examples/render_colored_points.py (points sampled
  from a torus, rgb from position, FoVOrthographicCameras at distance 3,
  znear 0.01), rendered from 2 views with AlphaCompositor, and the target
  cloud itself.
- Source: points sampled from ico_sphere(2), scaled to the torus's extent,
  with rgb features at 0.5; parameters are a (P, 3) offset and a (P, 3)
  colour.
- Loss: mean-squared image error + 0.1 * chamfer_distance(source, target)
  on Pointclouds; optimiser Adam(1e-2).

Here at 500 points, 2 views at 32^2, K=4 (radius 0.05, so that a point
covers a pixel or two).  The two views, face-on and edge-on to the torus,
are poses whose transforms are exact in float32: the example's look-at
poses round differently in the two packages (an ulp in ~30 % of the NDC
coordinates), which flips a few pixels' coverage at disc rims over the
steps, and Adam's normalized updates turn such a flip into ~1e-3 of an
offset.  Both run on the CPU: the port through its plain
versions, JAX through its XLA path (bin_size=0); `optax.adam` against
`torch.optim.Adam`.  The point samples are JAX's, handed to the port as
numpy.  Tolerances: the loss trajectory within rtol 1e-4 and the final
offsets within atol 1e-5, as float32 sums in another order compound over
the steps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pytorch3d_tpu.loss import chamfer_distance as j_chamfer
from pytorch3d_tpu.ops import sample_points_from_meshes as j_sample
from pytorch3d_tpu.renderer import (
    AlphaCompositor as JAlpha,
    FoVOrthographicCameras as JOrtho,
    PointsRasterizationSettings as JSettings,
    PointsRasterizer as JRasterizer,
    PointsRenderer as JRenderer,
)
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu.utils import ico_sphere as j_ico_sphere
from pytorch3d_tpu.utils import torus as j_torus
from pytorch3d_tpu_torch.loss import chamfer_distance
from pytorch3d_tpu_torch.renderer import (
    AlphaCompositor,
    FoVOrthographicCameras,
    PointsRasterizationSettings,
    PointsRasterizer,
    PointsRenderer,
)
from pytorch3d_tpu_torch.structures import Pointclouds

CPU = torch.device("cpu")
STEPS = 5
POINTS = 500
SIZE = 32
VIEWS = 2
K = 4
RADIUS = 0.05


def _clouds():
    """Target points and rgb, and the source points, as numpy."""
    tgt = np.array(j_sample(j_torus(0.35, 1.0, 12, 24), num_samples=POINTS, key=jax.random.PRNGKey(0))[0])
    rgb = (tgt - tgt.min(0)) / (tgt.max(0) - tgt.min(0))
    sphere = np.array(j_sample(j_ico_sphere(2), num_samples=POINTS, key=jax.random.PRNGKey(1))[0])
    lo, hi = tgt.min(0), tgt.max(0)
    src = sphere * (hi - lo) / 2.0 + (hi + lo) / 2.0  # the unit sphere scaled to the torus's box
    return tgt.astype(np.float32), rgb.astype(np.float32), src.astype(np.float32)


# Face-on and edge-on (a quarter turn about x) at distance 3.
_R = np.asarray([np.eye(3), [[1, 0, 0], [0, 0, 1], [0, -1, 0]]], np.float32)
_T = np.asarray([[0.0, 0.0, 3.0]] * VIEWS, np.float32)


def test_points_fit_matches_jax():
    tgt, rgb, src = _clouds()

    # JAX, the loop as a user of the JAX package writes it.
    jcams = JOrtho.create(R=jnp.asarray(_R), T=jnp.asarray(_T), znear=0.01)
    jsettings = JSettings(image_size=SIZE, radius=RADIUS, points_per_pixel=K, bin_size=0)
    jrender = JRenderer(JRasterizer(jcams, jsettings), JAlpha())
    jtarget = JPointclouds.create(jnp.asarray(tgt)[None], features=jnp.asarray(rgb)[None])
    jtarget_images = jrender(jtarget.extend(VIEWS))
    params = {"offset": jnp.zeros_like(jnp.asarray(src)), "colour": jnp.full(src.shape, 0.5, jnp.float32)}
    opt = optax.adam(1e-2)
    state = opt.init(params)

    def j_loss(p):
        cloud = JPointclouds.create((jnp.asarray(src) + p["offset"])[None], features=p["colour"][None])
        images = jrender(cloud.extend(VIEWS))
        return jnp.mean((images - jtarget_images) ** 2) + 0.1 * j_chamfer(cloud, jtarget)[0]

    j_step = jax.jit(jax.value_and_grad(j_loss))
    j_losses = []
    for _ in range(STEPS):
        loss, g = j_step(params)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(loss))

    # The port, on the same numbers.
    cams = FoVOrthographicCameras.create(R=_R, T=_T, znear=0.01, device=CPU)
    settings = PointsRasterizationSettings(image_size=SIZE, radius=RADIUS, points_per_pixel=K)
    render = PointsRenderer(PointsRasterizer(cams, settings), AlphaCompositor())
    target = Pointclouds.create(tgt[None], features=rgb[None], device=CPU)
    with torch.no_grad():
        target_images = render(target.extend(VIEWS))
    np.testing.assert_allclose(target_images.numpy(), np.asarray(jtarget_images), atol=1e-5)
    source = torch.from_numpy(src)
    offset = torch.zeros_like(source, requires_grad=True)
    colour = torch.full(source.shape, 0.5, requires_grad=True)
    optimizer = torch.optim.Adam([offset, colour], lr=1e-2)
    t_losses = []
    for _ in range(STEPS):
        optimizer.zero_grad()
        cloud = Pointclouds.create((source + offset)[None], features=colour[None], device=CPU)
        images = render(cloud.extend(VIEWS))
        loss = torch.mean((images - target_images) ** 2) + 0.1 * chamfer_distance(cloud, target)[0]
        loss.backward()
        optimizer.step()
        t_losses.append(loss.item())

    assert all(math.isfinite(v) for v in t_losses) and t_losses[-1] < t_losses[0]
    assert float((target_images.sum(-1) > 0.05).float().mean()) > 0.05  # the views see the cloud
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(offset.detach().numpy(), np.asarray(params["offset"]), atol=1e-5)
