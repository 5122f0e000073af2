"""The port's pulsar fit against the JAX package at a small size: five
Adam steps that fit spheres to a rendered target, as chip_smoke.py's
pulsar-fit path does at full size.

- Target: 60 seeded spheres rendered by pulsar at 32x40 (camera at the
  origin with an identity rotation, so both packages project bit for bit).
- Source: the target's positions jittered by a seeded normal (sigma 0.05),
  colours 0.5, radii x 0.8, opacity 1; all four are parameters.
- Loss: mean-squared image error; `optax.adam(1e-2, eps=1e-4)` against
  `torch.optim.Adam(lr=1e-2, eps=1e-4)`.  The gradients are 1e-4-sized and
  some entries are rounding noise (a sphere's edge term that cancels):
  with the default eps Adam's normalised step turns such an entry's sign
  into a full +-lr step, differently in each package; eps 1e-4 keeps the
  step proportional to the gradient there.

Both run on the CPU (the port through its plain versions).  Tolerances:
the loss trajectory within rtol 1e-4, the parameters within atol 1e-5
after five steps (float32 sums in another order compound over the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pytorch3d_tpu.renderer.points.pulsar import Renderer as JRenderer
from pytorch3d_tpu_torch.renderer.points.pulsar import Renderer

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

H, W, P, STEPS, LR, EPS = 32, 40, 60, 5, 1e-2, 1e-4
CAM = np.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 2.0], np.float32)
RENDER = dict(gamma=0.1, max_depth=10.0, min_depth=0.5)


def _scene():
    rng = np.random.RandomState(0)
    pos = np.concatenate([rng.uniform(-1, 1, (P, 2)), rng.uniform(2, 6, (P, 1))], 1).astype(np.float32)
    col = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    rad = rng.uniform(0.2, 0.5, (P,)).astype(np.float32)
    start = dict(
        pos=(pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32),
        col=np.full((P, 3), 0.5, np.float32),
        rad=(rad * 0.8).astype(np.float32),
        opa=np.ones((P,), np.float32),
    )
    return (pos, col, rad), start


def test_five_adam_steps_match_jax():
    (pos, col, rad), start = _scene()
    jr, tr = JRenderer(W, H, P), Renderer(W, H, P)
    j_target = jr(jnp.asarray(pos), jnp.asarray(col), jnp.asarray(rad), jnp.asarray(CAM), **RENDER)
    t_target = tr(torch.tensor(pos), torch.tensor(col), torch.tensor(rad), torch.tensor(CAM), **RENDER)
    np.testing.assert_allclose(t_target.numpy(), np.asarray(j_target), atol=1e-5, rtol=0)

    def j_loss(p):
        img = jr(p["pos"], p["col"], p["rad"], jnp.asarray(CAM), opacity=p["opa"], **RENDER)
        return jnp.mean((img - j_target) ** 2)

    params = {k: jnp.asarray(v) for k, v in start.items()}
    opt = optax.adam(LR, eps=EPS)
    state = opt.init(params)
    step = jax.jit(jax.value_and_grad(j_loss))
    j_losses = []
    for _ in range(STEPS):
        loss, grads = step(params)
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(loss))

    t_params = {k: torch.tensor(v, requires_grad=True) for k, v in start.items()}
    optimizer = torch.optim.Adam(list(t_params.values()), lr=LR, eps=EPS)
    t_losses = []
    for _ in range(STEPS):
        optimizer.zero_grad()
        img = tr(t_params["pos"], t_params["col"], t_params["rad"], torch.tensor(CAM), opacity=t_params["opa"], **RENDER)
        loss = ((img - t_target) ** 2).mean()
        loss.backward()
        optimizer.step()
        t_losses.append(loss.item())

    assert t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    for k in start:
        np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(params[k]), atol=1e-5, rtol=0, err_msg=k)
