"""The port's `Volumes` and `VolumeLocator` against the JAX package's: the
local <-> world transforms, the coordinate grids, indexing, `update_padded`,
the per-volume lists and `convert.volumes_from_numpy`.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.structures import Volumes as JVolumes
from pytorch3d_tpu_torch.convert import volumes_from_numpy
from pytorch3d_tpu_torch.structures import VolumeLocator, Volumes

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

# The same float32 formulas; the world -> local transform inverts a 4x4
# matrix in each package's own order: 1e-6 of the coordinates' magnitude.
TOL = 1e-6


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def _inputs(rng, grid=(5, 6, 7), n=2, voxel_size=None, translation=None):
    dens = rng.uniform(0, 1, (n, 1, *grid)).astype(np.float32)
    feats = rng.uniform(0, 1, (n, 3, *grid)).astype(np.float32)
    vs = rng.uniform(0.1, 0.5, (n, 3)).astype(np.float32) if voxel_size is None else voxel_size
    vt = rng.uniform(-1, 1, (n, 3)).astype(np.float32) if translation is None else translation
    tv = Volumes.create(torch.tensor(dens), torch.tensor(feats), voxel_size=vs, volume_translation=vt, device="cpu")
    return (dens, feats, vs, vt), tv


def _jax_volumes(dens, feats, vs, vt):
    return JVolumes.create(dens, feats, voxel_size=vs, volume_translation=vt)


@pytest.mark.parametrize("grid,voxel_size,translation", [
    ((5, 6, 7), None, None),  # per-volume anisotropic voxels
    ((4, 4, 4), 0.25, (0.5, -0.25, 1.0)),  # scalar size, shared translation
    ((1, 6, 7), np.array([0.3, 0.2], np.float32), None),  # one voxel deep, a size per volume
])
def test_transforms_and_coord_grids(grid, voxel_size, translation):
    rng = np.random.RandomState(0)
    (dens, feats, vs, vt), tv = _inputs(rng, grid, voxel_size=voxel_size, translation=translation)
    pts = rng.uniform(-2, 2, (2, 40, 3)).astype(np.float32)

    def jax_side(d, f, p):
        jv = _jax_volumes(d, f, vs, vt)
        return (jv.locator.voxel_size, jv.get_local_to_world_coords_transform().get_matrix(),
                jv.get_world_to_local_coords_transform().get_matrix(), jv.world_to_local_coords(p),
                jv.local_to_world_coords(p), jv.get_coord_grid(True), jv.get_coord_grid(False), jv.get_grid_sizes())

    want = jax.jit(jax_side)(jnp.asarray(dens), jnp.asarray(feats), jnp.asarray(pts))
    local = tv.world_to_local_coords(torch.tensor(pts))
    got = (tv.locator.voxel_size, tv.get_local_to_world_coords_transform().get_matrix(),
           tv.get_world_to_local_coords_transform().get_matrix(), local, tv.local_to_world_coords(torch.tensor(pts)),
           tv.get_coord_grid(True), tv.get_coord_grid(False))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-5 if i == 3 else TOL)
    _close(tv.local_to_world_coords(local), pts, 1e-5)  # the round trip
    assert tv.get_grid_sizes().tolist() == np.asarray(want[-1]).tolist()


def test_indexing_update_and_lists():
    rng = np.random.RandomState(1)
    (dens, feats, vs, vt), tv = _inputs(rng, n=3)
    new = rng.uniform(0, 1, tv.densities().shape).astype(np.float32)
    indices = (1, [0, 2], slice(1, 3), np.array([2, 0]))

    def jax_side(d, f, nd):
        jv = _jax_volumes(d, f, vs, vt)
        picked = [jv[i] for i in indices]
        up = jv.update_padded(nd)
        return ([(j.densities(), j.features(), j.get_coord_grid()) for j in picked],
                (up.densities(), up.features()), jv.densities_list(), jv.features_list())

    picked, (jd, jf), dlist, flist = jax.jit(jax_side)(jnp.asarray(dens), jnp.asarray(feats), jnp.asarray(new))
    for index, want in zip(indices, picked):
        ti = tv[torch.tensor(index) if isinstance(index, np.ndarray) else index]
        assert len(ti) == len(want[0])
        for g, w in zip((ti.densities(), ti.features(), ti.get_coord_grid()), want):
            _close(g, w)
    up = tv.update_padded(torch.tensor(new))
    _close(up.densities(), jd)
    _close(up.features(), jf)  # kept when not given
    assert [tuple(d.shape) for d in tv.densities_list()] == [tuple(d.shape) for d in dlist]
    _close(torch.stack(tv.features_list()), np.stack(flist))
    c = tv.clone()
    assert c.densities() is not tv.densities() and torch.equal(c.densities(), tv.densities())
    assert tv.to("cpu").device.type == "cpu" and tv.get_align_corners()
    assert tv.to(dtype=torch.float64).get_coord_grid().dtype == torch.float64
    assert Volumes.create(torch.zeros(1, 1, 2, 2, 2), device="cpu").features_list() is None
    with pytest.raises(ValueError):
        Volumes.create(torch.zeros(1, 2, 2, 2), device="cpu")
    with pytest.raises(ValueError):
        Volumes.create(torch.zeros(1, 1, 2, 2, 2), torch.zeros(1, 3, 2, 2, 3), device="cpu")


def test_volumes_from_numpy():
    """A JAX Volumes' arrays carried across: the same grids, and the same
    locator (its coordinate grid, computed by the port)."""
    rng = np.random.RandomState(2)
    inputs, direct = _inputs(rng)
    jv = _jax_volumes(*inputs)
    tv = volumes_from_numpy(np.asarray(jv.densities()), np.asarray(jv.features()),
                            np.asarray(jv.locator.voxel_size), np.asarray(jv.locator.volume_translation), device="cpu")
    _close(tv.densities(), jv.densities())
    _close(tv.features(), jv.features())
    assert torch.equal(tv.get_coord_grid(), direct.get_coord_grid())
    with pytest.raises(ValueError):
        volumes_from_numpy(np.asarray(jv.densities()), align_corners=False, device="cpu")


def test_locator_create_shapes():
    loc = VolumeLocator.create(4, (2, 3, 5), voxel_size=0.5, device="cpu")
    assert loc.voxel_size.shape == (4, 3) and loc.volume_translation.shape == (4, 3)
    assert loc.get_coord_grid().shape == (4, 2, 3, 5, 3)
