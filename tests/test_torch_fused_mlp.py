"""The port's fused MLP and NeRF field (ops/fused_mlp_cuda.py) against the
JAX package's Pallas kernels (ops/fused_mlp_pallas.py), run in interpret
mode on the CPU as tests/test_fused_mlp.py runs them.

On CPU tensors the port's wrappers run their plain versions, so these tests
hold the plain forward and the explicit plain reverses against the Pallas
forward and its custom VJP (the Pallas backward kernels), and against torch
autograd of the plain forward.  The CUDA kernels are held against the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch3d_tpu.ops.fused_mlp_pallas as jfm
from pytorch3d_tpu_torch.ops import fused_mlp_cuda as tfm

# Both sides sum 39-73 float32 products per output in different orders over
# two layers: values agree to ~1e-6 of their magnitude, held at 1e-5.
FWD_TOL = 1e-5
# Gradients sum over the N rows as well (N = 700): held at 1e-5 of each
# tensor's largest entry.
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = jfm._INTERPRET
    jfm._INTERPRET = jax.default_backend() != "tpu"
    yield
    jfm._INTERPRET = old


# The tiny NeRF of __graft_entry__._tiny_model: D = 39 (6 harmonics of
# xyz), 2 layers of 32 with the skip at layer 1, Ddir = 27, colour head 16.
N, D, H, L, SKIPS, DDIR, HH = 700, 39, 32, 2, (1,), 27, 16


def _inputs(seed=0):
    rng = np.random.RandomState(seed)

    def dense(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32), (rng.randn(o) * 0.05).astype(np.float32)

    x = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    de = rng.uniform(-1, 1, (N, DDIR)).astype(np.float32)
    ws, bs = zip(*[dense((D if li == 0 else H) + (D if li in SKIPS else 0), H) for li in range(L)])
    wd, bd = dense(H, 1)
    wi, bi = dense(H, H)
    wc1, bc1 = dense(H + DDIR, HH)
    wc2, bc2 = dense(HH, 3)
    head = (wd, bd, wi, bi, wc1[:H], wc1[H:], bc1, wc2, bc2)
    return x, de, list(ws), list(bs), head


def _torch(arrays):
    return [torch.tensor(np.array(a)) for a in arrays]


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def test_fused_mlp_plain_matches_pallas():
    x, _, ws, bs, _ = _inputs()
    want = jfm.fused_mlp(jnp.asarray(x), _jax(ws), _jax(bs), SKIPS)
    got = tfm.fused_mlp_plain(torch.tensor(x), _torch(ws), _torch(bs), SKIPS)
    _close(got, want, FWD_TOL)
    # the CPU wrapper is the plain version, and counts no launch
    before = tfm.fused_mlp_cuda.launches
    assert torch.equal(tfm.fused_mlp_cuda(torch.tensor(x), _torch(ws), _torch(bs), SKIPS), got)
    assert tfm.fused_mlp_cuda.launches == before


def test_fused_nerf_field_plain_matches_pallas():
    x, de, ws, bs, head = _inputs()
    want = jfm.fused_nerf_field(jnp.asarray(x), jnp.asarray(de), _jax(ws), _jax(bs), _jax(head), SKIPS)
    got = tfm.fused_nerf_field_plain(torch.tensor(x), torch.tensor(de), _torch(ws), _torch(bs), _torch(head), SKIPS)
    assert got.shape == (N, 4)
    _close(got, want, FWD_TOL)
    # the head alone against the JAX head oracle
    y = tfm.fused_mlp_plain(torch.tensor(x), _torch(ws), _torch(bs), SKIPS)
    want_head = jfm.fused_head_reference(jnp.asarray(y.numpy()), jnp.asarray(de), _jax(head), jnp.float32)
    _close(tfm.fused_head_plain(y, torch.tensor(de), _torch(head)), want_head, FWD_TOL)
    before = tfm.nerf_field_cuda.launches
    tfm.nerf_field_cuda(torch.tensor(x), torch.tensor(de), _torch(ws), _torch(bs), _torch(head), SKIPS)
    assert tfm.nerf_field_cuda.launches == before


def test_fused_mlp_grad_plain_matches_pallas_vjp_and_autograd():
    x, _, ws, bs, _ = _inputs()
    g = np.random.RandomState(1).randn(N, H).astype(np.float32)
    _, vjp = jax.vjp(lambda x, ws, bs: jfm.fused_mlp(x, ws, bs, SKIPS), jnp.asarray(x), _jax(ws), _jax(bs))
    jdx, jdws, jdbs = vjp(jnp.asarray(g))
    dx, dws, dbs = tfm.fused_mlp_grad_plain(torch.tensor(x), _torch(ws), _torch(bs), SKIPS, torch.tensor(g))
    for got, want in zip([dx, *dws, *dbs], [jdx, *jdws, *jdbs]):
        _close(got, want, GRAD_TOL)
    # against torch autograd of the plain forward, and through the
    # differentiable entry point (its backward is the plain reverse here)
    tx, tws, tbs = torch.tensor(x).requires_grad_(), [t.requires_grad_() for t in _torch(ws)], [
        t.requires_grad_() for t in _torch(bs)]
    auto = torch.autograd.grad(tfm.fused_mlp_plain(tx, tws, tbs, SKIPS), [tx, *tws, *tbs], torch.tensor(g))
    entry = torch.autograd.grad(tfm.fused_mlp(tx, tws, tbs, SKIPS), [tx, *tws, *tbs], torch.tensor(g))
    for got, a, e in zip([dx, *dws, *dbs], auto, entry):
        _close(got, a, GRAD_TOL)
        assert torch.equal(got, e)


def test_fused_nerf_field_grad_plain_matches_pallas_vjp_and_autograd():
    x, de, ws, bs, head = _inputs()
    g = np.random.RandomState(2).randn(N, 4).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x, de, ws, bs, hd: jfm.fused_nerf_field(x, de, ws, bs, hd, SKIPS),
        jnp.asarray(x), jnp.asarray(de), _jax(ws), _jax(bs), _jax(head),
    )
    jdx, jdde, jdws, jdbs, jdhead = vjp(jnp.asarray(g))
    dx, dde, dws, dbs, dhead = tfm.fused_nerf_field_grad_plain(
        torch.tensor(x), torch.tensor(de), _torch(ws), _torch(bs), _torch(head), SKIPS, torch.tensor(g)
    )
    assert len(dhead) == 9
    for got, want in zip([dx, dde, *dws, *dbs, *dhead], [jdx, jdde, *jdws, *jdbs, *jdhead]):
        _close(got, want, GRAD_TOL)
    params = [t.requires_grad_() for t in _torch([x, de, *ws, *bs, *head])]
    tx, tde, rest = params[0], params[1], params[2:]
    tws, tbs, thead = rest[:L], rest[L : 2 * L], rest[2 * L :]
    auto = torch.autograd.grad(
        tfm.fused_nerf_field_plain(tx, tde, tws, tbs, thead, SKIPS), params, torch.tensor(g)
    )
    entry = torch.autograd.grad(tfm.fused_nerf_field(tx, tde, tws, tbs, thead, SKIPS), params, torch.tensor(g))
    for got, a, e in zip([dx, dde, *dws, *dbs, *dhead], auto, entry):
        _close(got, a, GRAD_TOL)
        assert torch.equal(got, e)


@pytest.mark.parametrize("case", ["layers", "skip0", "width", "head", "rows"])
def test_kernel_shape_checks(case):
    """What the CUDA wrappers refuse, checked before any launch."""
    x, de, ws, bs, head = (_torch(a) if isinstance(a, (list, tuple)) else torch.tensor(a) for a in _inputs())
    with pytest.raises(ValueError):
        if case == "layers":
            tfm._trunk_dims("t", x, ws, bs[:1], SKIPS)
        elif case == "skip0":
            tfm._trunk_dims("t", x, ws, bs, (0,))
        elif case == "width":
            wide = [torch.zeros(D, tfm.MAX_WIDTH + 1), torch.zeros(tfm.MAX_WIDTH + 1 + D, tfm.MAX_WIDTH + 1)]
            tfm._trunk_dims("t", x, wide, [torch.zeros(tfm.MAX_WIDTH + 1)] * 2, SKIPS)
        elif case == "head":
            tfm._head_dims("t", de, head[:8], N, H)
        else:
            tfm._head_dims("t", de[:10], head, N, H)
