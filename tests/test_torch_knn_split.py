"""The KNN kernel's split of the database into ranges, on the CPU.

The CUDA kernel (csrc/knn.cu) cuts the database [0, P2) into the ranges
`knn_ranges` plans, finds each range's K best per query, and merges the
ranges' sorted lists in range order, each entry inserted in front of the
first strictly larger distance kept.  Here:

- the planner's ranges cover [0, P2) exactly, in order, none empty, over a
  grid of (N, P1, P2, K);
- an emulation of split-then-merge, built from the planner's ranges with
  `knn_points_plain` on each range and that merge rule, equals
  `knn_points_plain` on the whole database bit for bit, with points that
  repeat across range boundaries (ties the lower id must win) and lengths2
  ending inside a range;
- `knn_points` still matches the JAX package's `knn_points` on the same
  inputs.

Inputs are made with numpy from a seed.  The port runs on the CPU.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3d_tpu.ops.knn import knn_points as j_knn
from pytorch3d_tpu_torch.ops import knn as tknn

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

SMS = 132  # an H100 SXM's streaming multiprocessors
PER_BLOCK = (128, 256, 512)  # queries a stage-1 block may hold (the build's knn_block_queries)
_GRID = list(itertools.product((1, 2, 7), (1, 300, 5000, 30000), (1, 12, 127, 128, 129, 5000, 30000, 100_000),
                               (1, 2, 4, 8, 16), PER_BLOCK))


@pytest.mark.parametrize("N", [1, 2, 7])
def test_planner_covers_the_database_in_order(N):
    for _, P1, P2, K, per_block in (g for g in _GRID if g[0] == N):
        S, L = tknn.knn_ranges(N, P1, P2, K, per_block, SMS)
        case = (N, P1, P2, K, per_block, S, L)
        bounds = [(s * L, min((s + 1) * L, P2)) for s in range(S)]
        assert 1 <= S <= 65535 and bounds[0][0] == 0 and bounds[-1][1] == P2, case
        assert all(lo < hi for lo, hi in bounds), case  # none empty
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:])), case
        assert S == 1 or L >= tknn.MIN_RANGE, case


@pytest.mark.parametrize("per_block", PER_BLOCK)
def test_planner_fills_the_card_at_the_chamfer_shape(per_block):
    # The chamfer fit's 5000 x 5000 at K=1: at least two waves of blocks on
    # an H100's 132 SMs.
    S, _ = tknn.knn_ranges(1, 5000, 5000, 1, per_block, SMS)
    assert -(-5000 // per_block) * S >= 2 * SMS


def _insert(bd, bi, d, i):
    """The merge rule on a batch: (d, i) goes in front of the first strictly
    larger entry of each ascending list (bd, bi), where it beats the last."""
    larger = bd > d[..., None]
    shifted = torch.cat([torch.zeros_like(larger[..., :1]), larger[..., :-1]], dim=-1)
    prev_d = torch.cat([bd[..., :1], bd[..., :-1]], dim=-1)
    prev_i = torch.cat([bi[..., :1], bi[..., :-1]], dim=-1)
    new_d = torch.where(larger, torch.where(shifted, prev_d, d[..., None]), bd)
    new_i = torch.where(larger, torch.where(shifted, prev_i, i[..., None]), bi)
    enters = (d < bd[..., -1])[..., None]
    return torch.where(enters, new_d, bd), torch.where(enters, new_i, bi)


def _split_then_merge(p1, p2, lengths2, K, norm):
    """The kernel's two stages in torch: `knn_points_plain` on each planned
    range (ids shifted to the whole database, slots the range cannot fill
    at +inf and index 0), then the lists inserted in range order."""
    N, P1, _ = p1.shape
    P2 = p2.shape[1]
    S, L = tknn.knn_ranges(N, P1, P2, K, PER_BLOCK[-1], SMS)
    bd = torch.full((N, P1, K), torch.inf)
    bi = torch.zeros((N, P1, K), dtype=torch.int64)
    for s in range(S):
        lo, hi = s * L, min((s + 1) * L, P2)
        l2 = None if lengths2 is None else (lengths2 - lo).clamp(0, hi - lo)
        d, i = tknn.knn_points_plain(p1, p2[:, lo:hi].contiguous(), l2, min(K, hi - lo), norm)
        pad = K - d.shape[-1]
        d = torch.cat([d, torch.full((N, P1, pad), torch.inf)], dim=-1)
        i = torch.cat([i, torch.zeros((N, P1, pad), dtype=i.dtype)], dim=-1)
        i = torch.where(torch.isinf(d), 0, i + lo)
        for k in range(K):  # a sorted list: once an entry stays out, so do the rest
            bd, bi = _insert(bd, bi, d[..., k], i[..., k])
    return S, bd, bi


def _tie_clouds(seed, N, P1, P2, D, K):
    """Clouds whose database repeats across every range boundary (point
    i + L is point i), with a third of the queries on database points."""
    rng = np.random.default_rng(seed)
    _, L = tknn.knn_ranges(N, P1, P2, K, PER_BLOCK[-1], SMS)
    p2 = rng.random((N, P2, D), dtype=np.float32)
    p2[:, L:] = p2[:, : P2 - L]
    p1 = rng.random((N, P1, D), dtype=np.float32)
    p1[:, : P1 // 3] = p2[:, rng.integers(0, P2, P1 // 3)]
    return p1, p2


_SPLIT_CASES = [
    # seed, N, P1, P2, D, K, norm, lengths2
    (0, 1, 40, 1000, 3, 1, 2, None),
    (1, 2, 30, 900, 3, 4, 2, [900, 200]),  # lengths2 ends inside a range
    (2, 1, 20, 700, 3, 16, 2, [333]),
    (3, 2, 25, 600, 8, 8, 1, None),
    (4, 1, 50, 300, 2, 2, 1, [150]),
    (5, 3, 10, 12, 3, 12, 2, None),  # shorter than a range, K = P2
]


@pytest.mark.parametrize("seed,N,P1,P2,D,K,norm,lengths2", _SPLIT_CASES)
def test_split_then_merge_equals_the_plain_version(seed, N, P1, P2, D, K, norm, lengths2):
    p1, p2 = _tie_clouds(seed, N, P1, P2, D, K)
    l2 = None if lengths2 is None else torch.tensor(lengths2)
    S, got_d, got_i = _split_then_merge(torch.from_numpy(p1), torch.from_numpy(p2), l2, K, norm)
    want_d, want_i = tknn.knn_points_plain(torch.from_numpy(p1), torch.from_numpy(p2), l2, K, norm)
    assert S > 1 or P2 < 2 * tknn.MIN_RANGE
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    # The repeats make exact ties: the lower id (the earlier range) won them.
    if D == 3 and lengths2 is None:
        assert (want_d[:, : P1 // 3, 0] == 0).all()


@pytest.mark.parametrize("seed,N,P1,P2,D,K,norm,lengths2", _SPLIT_CASES[:4])
def test_knn_points_matches_jax_on_split_inputs(seed, N, P1, P2, D, K, norm, lengths2):
    p1, p2 = _tie_clouds(seed, N, P1, P2, D, K)
    l2 = None if lengths2 is None else np.asarray(lengths2)
    want = j_knn(jnp.asarray(p1), jnp.asarray(p2), None, None if l2 is None else jnp.asarray(l2), norm=norm, K=K)
    got = tknn.knn_points(torch.from_numpy(p1), torch.from_numpy(p2), None,
                          None if l2 is None else torch.from_numpy(l2), norm=norm, K=K)
    # JAX's XLA path expands |x|^2 + |y|^2 - 2xy (knn_points.py), whose
    # cancellation can swap two neighbours at nearly equal distances: ids
    # equal wherever the distances of the two rankings are 1e-5 apart.
    want_d, want_i = np.asarray(want.dists), np.asarray(want.idx)
    got_d, got_i = got.dists.numpy(), got.idx.numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
    gaps = np.abs(np.diff(got_d, axis=-1)) > 1e-5
    clear = np.concatenate([gaps, np.ones_like(gaps[..., :1])], axis=-1) & np.concatenate(
        [np.ones_like(gaps[..., :1]), gaps], axis=-1)
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
