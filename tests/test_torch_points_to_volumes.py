"""The port's splatting of points into volumes against the JAX package's:
`add_points_features_to_volume_densities_features` in both modes, with a
mask and with and without rescaling, values and gradients to the points,
the features and the initial grids; `add_pointclouds_to_volumes` on clouds
of two sizes through a `Volumes`' world -> local transform.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.ops.points_to_volumes import add_pointclouds_to_volumes as j_add_clouds
from pytorch3d_tpu.ops.points_to_volumes import add_points_features_to_volume_densities_features as j_splat
from pytorch3d_tpu.structures import Pointclouds as JPointclouds
from pytorch3d_tpu.structures import Volumes as JVolumes
from pytorch3d_tpu_torch.convert import pointclouds_from_numpy
from pytorch3d_tpu_torch.ops import add_pointclouds_to_volumes, add_points_features_to_volume_densities_features
from pytorch3d_tpu_torch.structures import Volumes

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

# Voxels sum a few weighted rows in another order: 1e-5 of the largest
# value (rescaled features divide by densities down to min_weight).
TOL = 1e-5
GRID = (6, 7, 8)  # (D, H, W)


def _err(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(seed, B=2, P=60, C=3):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.15, 1.15, (B, P, 3)).astype(np.float32)  # some corners fall off the grid
    feats = rng.uniform(-1, 1, (B, P, C)).astype(np.float32)
    dens0 = rng.uniform(0, 0.5, (B, 1, *GRID)).astype(np.float32)
    feat0 = rng.uniform(-1, 1, (B, C, *GRID)).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, P)) > 0.2).astype(np.float32)
    cot = [rng.randn(B, C, *GRID).astype(np.float32), rng.randn(B, 1, *GRID).astype(np.float32)]
    return pts, feats, dens0, feat0, mask, cot


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
@pytest.mark.parametrize("rescale", [True, False])
def test_splat_values_and_gradients(mode, rescale):
    pts, feats, dens0, feat0, mask, cot = _inputs(0 if mode == "trilinear" else 1)

    def jfn(p, f, d, v):
        return j_splat(p, f, d, v, mode=mode, mask=jnp.asarray(mask), rescale_features=rescale)

    (jf, jd), vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(a) for a in (pts, feats, dens0, feat0)))
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    args = [torch.tensor(a, requires_grad=True) for a in (pts, feats, dens0, feat0)]
    tf, td = add_points_features_to_volume_densities_features(
        *args, mode=mode, mask=torch.tensor(mask), rescale_features=rescale
    )
    assert _err(tf, jf) <= TOL and _err(td, jd) <= TOL
    torch.autograd.backward([tf, td], [torch.tensor(c) for c in cot])
    for name, a, want in zip(("points", "features", "densities", "volume features"), args, jgrads):
        if not np.abs(np.asarray(want)).max():
            assert a.grad is None or not a.grad.abs().max(), name  # nearest: no gradient to the points
            continue
        assert _err(a.grad, want) <= TOL, name


def test_splat_defaults_and_bad_mode():
    """No initial features, no mask: the JAX package's defaults."""
    pts, feats, dens0, _, _, _ = _inputs(2)
    jf, jd = jax.jit(lambda p, f, d: j_splat(p, f, d, None))(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(dens0))
    tf, td = add_points_features_to_volume_densities_features(
        torch.tensor(pts), torch.tensor(feats), torch.tensor(dens0), None
    )
    assert _err(tf, jf) <= TOL and _err(td, jd) <= TOL
    with pytest.raises(ValueError):
        add_points_features_to_volume_densities_features(
            torch.tensor(pts), torch.tensor(feats), torch.tensor(dens0), None, mode="cubic"
        )


def test_add_pointclouds_to_volumes():
    """Clouds of 60 and 37 points (the padding masked out) splatted into
    volumes of their own voxel sizes and translations."""
    pts, feats, dens0, feat0, _, _ = _inputs(3)
    counts = np.array([60, 37], np.int32)
    vs = np.array([[0.3, 0.25, 0.35], [0.2, 0.2, 0.2]], np.float32)
    vt = np.array([[0.1, -0.2, 0.0], [0.0, 0.3, -0.1]], np.float32)
    world = pts * 1.2
    jc = JPointclouds.create(jnp.asarray(world), features=jnp.asarray(feats), num_points_per_cloud=counts)
    jv = JVolumes.create(jnp.asarray(dens0), jnp.asarray(feat0), voxel_size=vs, volume_translation=vt)
    tc = pointclouds_from_numpy(world, features=feats, num_points_per_cloud=counts, device="cpu")
    tv = Volumes.create(torch.tensor(dens0), torch.tensor(feat0), voxel_size=vs, volume_translation=vt, device="cpu")
    both = jax.jit(lambda c, v: [j_add_clouds(c, v, mode=m) for m in ("trilinear", "nearest")])(jc, jv)
    for mode, want in zip(("trilinear", "nearest"), both):
        got = add_pointclouds_to_volumes(tc, tv, mode=mode)
        assert _err(got.densities(), want.densities()) <= TOL
        assert _err(got.features(), want.features()) <= TOL
    with pytest.raises(ValueError):
        add_pointclouds_to_volumes(pointclouds_from_numpy(world, device="cpu"), tv)
