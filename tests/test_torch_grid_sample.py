"""The port's `grid_sample` (`ops/grid_sample.py`) against the JAX package's,
on the CPU: 2D and 3D, `bilinear` and `nearest`, `zeros` / `border` /
`reflection` padding (JAX takes `reflection` as `zeros`), with and without
`align_corners`; the values and the gradients with respect to the input
and the grid, from seeded numpy inputs.  The grids reach past [-1, 1] and
hold points at exact half-texel positions, where `nearest` rounds half to
even.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.ops.grid_sample import grid_sample as j_grid_sample
from pytorch3d_tpu_torch.ops import grid_sample

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CASES = list(itertools.product((2, 3), ("bilinear", "nearest"), ("zeros", "border", "reflection"), (False, True)))


def _inputs(dims, align_corners, seed):
    rng = np.random.default_rng(seed)
    spatial = (5, 6) if dims == 2 else (3, 4, 5)  # (H, W) or (D, H, W)
    x = rng.standard_normal((2, 3, *spatial)).astype(np.float32)
    out = (4, 7) if dims == 2 else (2, 3, 4)
    grid = rng.uniform(-1.3, 1.3, (2, *out, dims)).astype(np.float32)
    # exact half-texel positions along x: unnormalized k + 0.5
    W = spatial[-1]
    halves = np.array([0.5, 1.5, 2.5], np.float32)
    g = 2.0 * halves / (W - 1) - 1.0 if align_corners else (2.0 * halves + 1.0) / W - 1.0
    flat = grid.reshape(2, -1, dims)
    flat[0, :3, 0] = g
    return x, flat.reshape(grid.shape), rng.standard_normal((2, 3, *out)).astype(np.float32)


@pytest.mark.parametrize("dims,mode,padding_mode,align_corners", CASES)
def test_grid_sample_matches_jax(dims, mode, padding_mode, align_corners):
    """Values within 1e-6; gradients (input and grid) within 1e-5."""
    x, grid, ct = _inputs(dims, align_corners, seed=len(CASES) + CASES.index((dims, mode, padding_mode, align_corners)))
    kw = dict(mode=mode, padding_mode=padding_mode, align_corners=align_corners)

    def jfn(a, g):
        return j_grid_sample(a, g, **kw)

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(grid))
    want_gx, want_gg = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(grid).requires_grad_(True)
    got = grid_sample(xt, gt, **kw)
    got.backward(torch.from_numpy(ct))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), atol=1e-5)
    # nearest: the grid reaches the output through integer indices only (JAX: zeros)
    got_gg = np.zeros_like(grid) if gt.grad is None else gt.grad.numpy()
    np.testing.assert_allclose(got_gg, np.asarray(want_gg), atol=1e-5)


def test_grid_sample_rejects_other_ranks():
    with pytest.raises(ValueError):
        grid_sample(torch.zeros(3, 4, 4), torch.zeros(1, 2, 2, 2))
