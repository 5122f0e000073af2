"""The pulsar blend backward's hit decomposition, on the CPU.

The CUDA backward (csrc/pulsar_grad.cu) walks each pixel's selected hits:
a hit finds its sphere's position q in its 16x16 tile's list (ascending
ids, `bin_points_for_pulsar`) by binary search, computes its partials once
and adds them to the (tile, sphere) slot at q; pass 2 adds each sphere's
slots in ascending tile order.  A hit whose sphere is missing from its
tile's list would make the sphere's gradient NaN.  Here:

- every id the selection picks lies in its tile's list, at the position
  binary search finds: the NaN cannot fire on the path, where the
  selection runs on the same binning;
- a torch model of that decomposition (per-hit partials, summed per
  (tile, sphere) slot in hit order, each slot's per-sphere factors, then
  per sphere in tile order) gives `pulsar_blend_grads_plain`, within 1e-5
  of each field's largest entry, at gamma 0.1 and at 1e-4;
- the CPU wrapper still equals the plain version and matches the JAX
  package's `pulsar_blend_grads` run in interpret mode.

Inputs are seeded numpy arrays handed to both packages; the port runs on
the CPU.
"""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.renderer.points.rasterize_points_pallas as rpp
from pytorch3d_tpu.renderer.mesh.rasterize_pallas import _tile_for_k
from pytorch3d_tpu_torch.renderer.mesh.rasterize_cuda import TILE
from pytorch3d_tpu_torch.renderer.points import rasterize_points_cuda as tpc
from pytorch3d_tpu_torch.renderer.points.pulsar.renderer import _blend_core

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

EXACT = 1e-5  # gradients, relative to each field's largest entry
BG = [0.2, 0.3, 0.4]
DEPTH = (0.5, 3.5)


def _scene(P=60, seed=11, size=(40, 48)):
    """Spheres in NDC on both sides of the depth bounds and of z = 0."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-1.1, 1.1, (P, 2)), rng.uniform(-0.5, 4.0, (P, 1))], 1).astype(np.float32)
    rad = rng.uniform(0.08, 0.35, (P,)).astype(np.float32)
    valid = (pts[:, 2] > DEPTH[0]) & (pts[:, 2] < DEPTH[1])
    return torch.tensor(pts), torch.tensor(rad), torch.tensor(valid), size


def _blend(pts, rad, valid, size, K, gamma, seed=12):
    """(table, idx, bins, ct, denom, logit_max) of one request."""
    rng = np.random.RandomState(seed)
    P = pts.shape[0]
    table = torch.tensor(np.concatenate([
        pts.numpy(), np.maximum(rad.numpy(), 1e-8)[:, None], rng.uniform(0.3, 1, (P, 1)), rng.uniform(0, 1, (P, 3)),
    ], 1).astype(np.float32))
    bins = tpc.bin_points_for_pulsar(pts, rad, valid, size)
    idx = tpc.select_points_cuda(pts, rad, valid, size, K, bins)
    _, denom, lm, _, _ = _blend_core(table, idx, torch.tensor(BG), gamma, *DEPTH, 0.0, *size)
    ct = torch.tensor(rng.randn(*size, 3).astype(np.float32))
    return table, idx, bins, ct, denom, lm


def _hit_slots(idx, bins, P):
    """Per filled hit of idx (row-major): its pixel (row, col), its sphere,
    and the slot row that binary search over its tile's list finds (-1
    where the sphere is missing)."""
    tile_points, tile_start, n_ty, n_tx = bins[:4]
    r, c, k = torch.nonzero(idx >= 0, as_tuple=True)
    j = idx[r, c, k].long()
    tile = (r // TILE[0]) * n_tx + c // TILE[1]
    pair_tile = torch.repeat_interleave(torch.arange(n_ty * n_tx), tile_start.diff().long())
    keys = pair_tile * P + tile_points.long()  # ascending: tile-major, ascending ids
    key = tile * P + j
    slot = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
    found = keys[slot] == key
    return r, c, j, torch.where(found, slot, -1), slot - tile_start[tile].long()


@pytest.mark.parametrize("P,size,K", [(60, (40, 48), 5), (200, (64, 64), 12), (30, (33, 17), 1)])
def test_selected_ids_lie_in_their_tiles_lists(P, size, K):
    pts, rad, valid, size = _scene(P=P, size=size)
    bins = tpc.bin_points_for_pulsar(pts, rad, valid, size)
    idx = tpc.select_points_cuda(pts, rad, valid, size, K, bins)
    _, _, j, slot, q = _hit_slots(idx, bins, P)
    tile_points, tile_start = bins[:2]
    assert j.numel() > 0 and (slot >= 0).all()
    assert torch.equal(tile_points[slot].long(), j)
    # q is the position in the tile's own list, as the kernel's search returns it
    starts = tile_start[:-1].long()
    assert (q >= 0).all() and (q < (tile_start[1:].long() - starts)[(slot[:, None] >= starts).sum(1) - 1]).all()


def _pass1_model(table, idx, bins, ct, denom, lm, size, gamma):
    """The kernel's decomposition in torch (float32): per-hit partials x,
    y, r, S, col[C], their sums per slot in hit order, each slot's
    per-sphere factors, then each sphere's slots in ascending tile order."""
    P, F = table.shape
    C = F - 5
    H, W = size
    inv_gamma = torch.tensor(1.0 / gamma, dtype=torch.float32)
    inv_range = torch.tensor(1.0 / (DEPTH[1] - DEPTH[0]), dtype=torch.float32)
    ys, xs = tpc.pulsar_pixel_grid(H, W, torch.float32, table.device)
    r, c, j, slot, _ = _hit_slots(idx, bins, P)
    assert (slot >= 0).all()
    ids = idx[r, c].long()  # (hits, K): every hit's pixel's ids
    hit = ids >= 0
    rows = table[ids.clamp(min=0)]  # (hits, K, F)
    px, py = xs[c], ys[r]
    inv_denom = 1.0 / denom[r, c]
    lm_h = lm[r, c]
    w_bg = torch.exp(torch.tensor(0.0 / gamma, dtype=torch.float32) - lm_h)

    def weight(t):  # the forward's weight of table rows t at the hits' pixels
        zn = (1.0 - (t[..., 2] - DEPTH[0]) * inv_range).clamp(0.0, 1.0)
        dx, dy = px[..., None] - t[..., 0], py[..., None] - t[..., 1]
        clos = (1.0 - (dx * dx + dy * dy) / (t[..., 3] * t[..., 3])).clamp(0.0, 1.0)
        return t[..., 4] * clos * torch.exp(t[..., 4] * zn * inv_gamma - lm_h[..., None])

    wk = torch.where(hit, weight(rows), 0.0)
    me = table[j]
    cx, cy, cz, cr, co = me[:, :5].unbind(-1)
    zn = (1.0 - (cz - DEPTH[0]) * inv_range).clamp(0.0, 1.0)
    e = torch.exp(co * zn * inv_gamma - lm_h)
    dx, dy = px - cx, py - cy
    d2 = dx * dx + dy * dy
    u = 1.0 - d2 / (cr * cr)
    w0 = u.clamp(0.0, 1.0) * e
    ctp = ct[r, c] * inv_denom[:, None]  # (hits, C)
    A = torch.zeros_like(w0)
    for ch in range(C):
        cj = me[:, 5 + ch]
        num = w_bg * (cj - BG[ch])
        for kk in range(ids.shape[1]):
            num = num + torch.where(hit[:, kk], wk[:, kk] * (cj - rows[:, kk, 5 + ch]), 0.0)
        A = A + ctp[:, ch] * num
    A = A * inv_denom
    g = torch.where((u > 0.0) & (u < 1.0), A * e, 0.0)
    partials = torch.cat([torch.stack([g * dx, g * dy, g * d2, A * w0], -1), w0[:, None] * ctp], -1)
    sums = torch.zeros((bins[0].numel(), 4 + C)).index_add_(0, slot, partials)  # per slot, in hit order

    sp = table[bins[0].long()]  # each slot's sphere
    sz, sr, so = sp[:, 2], sp[:, 3], sp[:, 4]
    inv_r2 = 1.0 / (sr * sr)
    zn_raw = 1.0 - (sz - DEPTH[0]) * inv_range
    gslot = torch.cat([
        torch.stack([
            2.0 * inv_r2 * so * sums[:, 0],
            2.0 * inv_r2 * so * sums[:, 1],
            torch.where((zn_raw > 0.0) & (zn_raw < 1.0), -(so * so * inv_gamma) * inv_range * sums[:, 3], 0.0),
            2.0 * inv_r2 * so / sr * sums[:, 2],
            (1.0 + so * zn_raw.clamp(0.0, 1.0) * inv_gamma) * sums[:, 3],
        ], -1),
        so[:, None] * sums[:, 4:],
    ], -1)
    slot_rows, sphere_start = bins[4].long(), bins[5].long()
    sphere = torch.repeat_interleave(torch.arange(P), sphere_start.diff())
    return torch.zeros((P, F)).index_add_(0, sphere, gslot[slot_rows])  # each sphere's slots in tile order


@pytest.mark.parametrize("gamma", [0.1, 1e-4])
def test_pass1_model_gives_the_plain_gradient(gamma):
    pts, rad, valid, size = _scene(P=200, size=(64, 64))
    table, idx, bins, ct, denom, lm = _blend(pts, rad, valid, size, 5, gamma)
    got = _pass1_model(table, idx, bins, ct, denom, lm, size, gamma)
    want = tpc.pulsar_blend_grads_plain(table, idx, ct, denom, lm, torch.tensor(BG), size, gamma, *DEPTH, 0.0)
    scale = want.abs().amax(dim=0)
    assert (scale > 0).all() and torch.isfinite(got).all()
    assert ((got - want).abs().amax(dim=0) <= EXACT * scale).all(), ((got - want).abs().amax(dim=0) / scale)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as
    tests/test_pallas_crosscheck.py does; nothing in the package changes."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rpp.pl, "pallas_call", patched)


def test_cpu_wrapper_matches_plain_and_jax_pulsar_blend_grads(interpret_pallas):
    pts, rad, valid, size = _scene(P=24, size=(32, 32))
    K, gamma = 5, 0.1
    table, idx, bins, ct, denom, lm = _blend(pts, rad, valid, size, K, gamma)
    before = tpc.pulsar_blend_grads_cuda.launches
    got = tpc.pulsar_blend_grads_cuda(table, idx, ct, denom, lm, torch.tensor(BG), size, gamma, *DEPTH, 0.0, bins)
    assert tpc.pulsar_blend_grads_cuda.launches == before
    assert torch.equal(got, tpc.pulsar_blend_grads_plain(table, idx, ct, denom, lm, torch.tensor(BG), size, gamma,
                                                         *DEPTH, 0.0))
    p, r, v = (jnp.asarray(t.numpy()) for t in (pts, rad, valid))
    need = int(rpp.required_points_per_tile(p, r, v, size))
    t = rpp.required_tiles_per_point(p, r, v, size)
    tile = _tile_for_k(K)
    _, ids, counts, rows, _, n_tx = rpp.bin_points_for_pulsar(
        p, r, v, size, 1 << max(need - 1, 0).bit_length(), (max(int(t[0]), 1), max(int(t[1]), 1)), tile
    )
    img = _blend_core(table, idx, torch.tensor(BG), gamma, *DEPTH, 0.0, *size)[0]
    want = np.asarray(rpp.pulsar_blend_grads(
        jnp.asarray(table.numpy()), ids, counts, rows, jnp.asarray(idx.numpy().astype(np.int32)),
        jnp.asarray(ct.numpy()), jnp.asarray(img.numpy()), jnp.asarray(denom.numpy()), jnp.asarray(lm.numpy()),
        size, gamma, *DEPTH, n_tx, tile,
    ))
    scale = np.abs(want).max(axis=0)
    assert (scale > 0).all()
    assert (np.abs(got.numpy() - want).max(axis=0) <= EXACT * scale).all()
