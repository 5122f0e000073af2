"""The port's `Pointclouds` against the JAX package's, method by method, on
one heterogeneous batch (3 clouds of 50, 120 and 7 points, with normals
and features) made from a seed with numpy.  Both hold the same float32
values and the same padded-first layout, so every result is compared
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.structures import pointclouds as jpc
from pytorch3d_tpu_torch.convert import pointclouds_from_numpy
from pytorch3d_tpu_torch.structures import Pointclouds, join_pointclouds_as_batch, join_pointclouds_as_scene

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

CPU = torch.device("cpu")
COUNTS = (50, 120, 7)


def _lists(seed=0, counts=COUNTS, C=4):
    rng = np.random.default_rng(seed)
    pts = [rng.standard_normal((n, 3)).astype(np.float32) for n in counts]
    nrm = [rng.standard_normal((n, 3)).astype(np.float32) for n in counts]
    feat = [rng.uniform(size=(n, C)).astype(np.float32) for n in counts]
    return pts, nrm, feat


def _both(seed=0, counts=COUNTS):
    pts, nrm, feat = _lists(seed, counts)
    j = jpc.Pointclouds.create([jnp.asarray(p) for p in pts], normals=[jnp.asarray(n) for n in nrm],
                               features=[jnp.asarray(f) for f in feat])
    t = pointclouds_from_numpy(pts, features=feat, normals=nrm, device=CPU)
    return j, t


def _same(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, (bool, int, float)):
        assert got == want
        return
    np.testing.assert_array_equal(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(want))


def _cloud_views(c):
    return (
        c.points_padded(), c.normals_padded(), c.features_padded(), c.num_points_per_cloud(),
        c.points_padded_mask(),
    )


# Each case: a name and a function applied to both packages' batches; the
# results must be equal.  Arguments are numpy, handed to each as its own.
_OFFS = np.random.default_rng(9).standard_normal((3 * 120, 3)).astype(np.float32)
_BOX = np.asarray([[-0.5, -0.4, -1.0], [0.6, 0.5, 0.8]], np.float32)
_BOXES = np.stack([_BOX, _BOX * 2.0, _BOX * 0.5])


def _arg(a, like):
    return jnp.asarray(a) if isinstance(like, jpc.Pointclouds) else torch.from_numpy(np.array(a))


_CASES = {
    "len": lambda c: len(c),
    "max_points": lambda c: c.max_points,
    "isempty": lambda c: c.isempty(),
    "num_points_per_cloud": lambda c: c.num_points_per_cloud(),
    "points_padded": lambda c: c.points_padded(),
    "normals_padded": lambda c: c.normals_padded(),
    "features_padded": lambda c: c.features_padded(),
    "points_padded_mask": lambda c: c.points_padded_mask(),
    "points_packed": lambda c: c.points_packed(),
    "points_packed_mask": lambda c: c.points_packed_mask(),
    "normals_packed": lambda c: c.normals_packed(),
    "features_packed": lambda c: c.features_packed(),
    "packed_to_cloud_idx": lambda c: c.packed_to_cloud_idx(),
    "cloud_to_packed_first_idx": lambda c: c.cloud_to_packed_first_idx(),
    "padded_to_packed_idx": lambda c: c.padded_to_packed_idx(),
    "points_list": lambda c: c.points_list(),
    "normals_list": lambda c: c.normals_list(),
    "features_list": lambda c: c.features_list(),
    "get_cloud": lambda c: c.get_cloud(1),
    "get_bounding_boxes": lambda c: c.get_bounding_boxes(),
    "inside_box": lambda c: c.inside_box(_arg(_BOX, c)),
    "inside_boxes": lambda c: c.inside_box(_arg(_BOXES, c)),
    "update_padded": lambda c: _cloud_views(c.update_padded(c.points_padded() * 2.0)),
    "update_padded_features": lambda c: _cloud_views(
        c.update_padded(c.points_padded() + 1.0, new_features_padded=c.features_padded() * 3.0)
    ),
    "offset_vector": lambda c: _cloud_views(c.offset(_arg(_OFFS[0], c))),
    "offset_packed": lambda c: _cloud_views(c.offset(_arg(_OFFS, c))),
    "offset_": lambda c: _cloud_views(c.offset_(_arg(_OFFS, c))),
    "scale_scalar": lambda c: _cloud_views(c.scale(1.5)),
    "scale_per_cloud": lambda c: _cloud_views(c.scale(_arg(np.float32([0.5, 2.0, -1.0]), c))),
    "scale_": lambda c: _cloud_views(c.scale_(_arg(np.float32([0.5, 2.0, -1.0]), c))),
    "detach": lambda c: _cloud_views(c.detach()),
    "clone": lambda c: _cloud_views(c.clone()),
    "to_cpu": lambda c: _cloud_views(c.cpu() if isinstance(c, jpc.Pointclouds) else c.to("cpu")),
    "getitem_int": lambda c: _cloud_views(c[1]),
    "getitem_list": lambda c: _cloud_views(c[[2, 0]]),
    "getitem_slice": lambda c: _cloud_views(c[1:3]),
    "getitem_index_tensor": lambda c: _cloud_views(c[_arg(np.asarray([0, 2, 2]), c)]),
    "split": lambda c: [_cloud_views(s) for s in c.split([1, 2])],
    "extend": lambda c: _cloud_views(c.extend(3)),
    "join_as_batch": lambda c: _cloud_views(
        (jpc.join_pointclouds_as_batch if isinstance(c, jpc.Pointclouds) else join_pointclouds_as_batch)(
            [c, c[[2]], c[0:2]]
        )
    ),
    "join_as_scene": lambda c: _cloud_views(
        (jpc.join_pointclouds_as_scene if isinstance(c, jpc.Pointclouds) else join_pointclouds_as_scene)(c)
    ),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_pointclouds_matches_jax(case):
    j, t = _both()
    _same(_CASES[case](t), _CASES[case](j))


def test_padded_input_with_counts_matches_jax():
    pts, nrm, feat = _lists(seed=3)
    j, _ = _both(seed=3)
    padded = [np.asarray(x) for x in (j.points_padded(), j.normals_padded(), j.features_padded())]
    t = pointclouds_from_numpy(padded[0], features=padded[2], normals=padded[1],
                               num_points_per_cloud=np.asarray(COUNTS), device=CPU)
    jj = jpc.Pointclouds.create(*map(jnp.asarray, padded[:1]), normals=jnp.asarray(padded[1]),
                                features=jnp.asarray(padded[2]), num_points_per_cloud=jnp.asarray(COUNTS))
    _same(_cloud_views(t), _cloud_views(jj))
    # Without counts every slot of the padded array is a point.
    full = Pointclouds.create(np.array(padded[0]), device=CPU)
    assert full.num_points_per_cloud().tolist() == [120, 120, 120]


def test_offset_in_place_updates_the_same_tensor():
    _, t = _both()
    pts = t.points_padded()
    out = t.offset_(torch.ones(3))
    assert out is t and out.points_padded() is pts


def test_refusals_match_jax():
    j, t = _both()
    for c in (j, t):
        with pytest.raises(ValueError):
            c.extend(0)
        with pytest.raises(ValueError):
            c.split([1, 1])
        with pytest.raises(ValueError):
            c.update_padded(c.points_padded()[:, :5])
        with pytest.raises(ValueError):
            c.offset(_arg(np.zeros((7, 3), np.float32), c))
        with pytest.raises(ValueError):
            c.inside_box(_arg(np.zeros((3, 3), np.float32), c))
    with pytest.raises(ValueError):
        Pointclouds.create(torch.zeros(2, 5), device=CPU)
