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

torch.set_num_threads(2)  # the test run's workers share the machine's cores: no oversubscribed thread pools

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


@pytest.mark.parametrize("H,Ddir,limit", [(256, 27, 552), (256, 0, 584), (256, 256, 328), (128, 27, 680)])
def test_input_limit_from_shared_memory(H, Ddir, limit):
    """The input width the kernels take is what the forward's shared memory
    holds beside H and Ddir, a rule that lives in csrc/fused_mlp.cu alone
    (`input_limit` reads it from the library; test_torch_cuda.py holds
    these limits on an H100): the Python shape checks put no cap of their
    own on D, so the trunk's and the head's shapes at the limit pass them,
    and the library's refusal one past it (-2, from the workspace query
    that every launch makes first) becomes a ValueError naming the limit."""
    x = torch.zeros((4, limit))
    ws = [torch.zeros((limit, H)), torch.zeros((H + limit, H))]
    assert tfm._trunk_dims("t", x, ws, [torch.zeros(H)] * 2, SKIPS) == (4, limit, H, 2)
    Hh = 32
    if Ddir:
        head = [torch.zeros(s) for s in [(H, 1), (1,), (H, H), (H,), (H, Hh), (Ddir, Hh), (Hh,), (Hh, 3), (3,)]]
        assert tfm._head_dims("t", torch.zeros((4, Ddir)), head, 4, H) == (Ddir, Hh)

    class Library:  # the C rule's answers at these widths
        @staticmethod
        def fused_mlp_workspace(dims, head, *sizes):
            return 0 if dims[1] <= limit else -2

        @staticmethod
        def fused_mlp_input_limit(h, ddir, head):
            return limit

    assert tfm._workspace("t", Library, tfm._c_dims(4, limit, Ddir, H, Hh, 2, 2), Ddir > 0) == (0, 0, 0)
    with pytest.raises(ValueError, match=f"{limit + 1} features does not fit the forward's shared memory.*"
                                         f"at most {limit}"):
        tfm._workspace("t", Library, tfm._c_dims(4, limit + 1, Ddir, H, Hh, 2, 2), Ddir > 0)


def _load_chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_mlp_bounds_count_the_function_work():
    """#10/#12's bound counts each layer's input width times its output
    width per row (the NeRF field: 581 120 multiply-adds, its trunk alone
    478 720) at the three-pass TF32 rate; the serving launches (262 144 and
    524 288 rows) are bound by operations at 2x and 4x the fine training
    launch's 131 072."""
    cs = _load_chip_smoke()
    nerf = dict(D=39, H=256, L=8, skips=(5,), Ddir=27, Hh=128)
    assert cs.mlp_macs_per_row(**nerf) == 581_120
    assert cs.mlp_macs_per_row(39, 256, 8, (5,)) == 478_720
    train, by, ops = cs.mlp_bound(131_072, **nerf)
    assert by == "operations" and ops == 2 * 131_072 * 581_120
    assert train == pytest.approx(1e3 * ops / cs.PEAK_TF32X3_OPS_PER_S)
    coarse, by_c, _ = cs.mlp_bound(262_144, **nerf)
    fine, by_f, _ = cs.mlp_bound(524_288, **nerf)
    assert by_c == by_f == "operations"
    assert coarse == pytest.approx(2 * train) and fine == pytest.approx(4 * train)


@pytest.mark.parametrize("head", [False, True])
def test_chip_smoke_saved_masks_read_the_saving_forwards_layout(head):
    """chip_smoke.saved_masks reads the ReLU masks from a saving forward's
    flat tensor as the backward kernel does (every trunk layer's output,
    the trunk's last being out itself without a head; with it il, then the
    colour hidden h): on the plain chain's values laid out so, it gives
    relu_masks."""
    cs = _load_chip_smoke()
    rng = np.random.RandomState(3)
    n, d, h, layers, skips, ddir, hh = 37, 6, 16, 3, (2,), 5, 8
    t = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32))
    x, de = t(n, d), t(n, ddir)
    ws = [t((d if li == 0 else h) + (d if li in skips else 0), h) for li in range(layers)]
    bs = [t(h) for _ in range(layers)]
    y, _, outputs = tfm._trunk_chain(x, ws, bs, skips)
    if head:
        params = (t(h, 1), t(1), t(h, h), t(h), t(h, hh), t(ddir, hh), t(hh), t(hh, 3), t(3))
        out, il, hid = tfm._head_chain(y, de, params)
        saved = (out, torch.cat([o.reshape(-1) for o in outputs] + [il.reshape(-1), hid.reshape(-1)]))
        want = tfm.relu_masks(x, ws, bs, skips, de, params)
    else:
        saved = (y, torch.cat([o.reshape(-1) for o in outputs[:-1]]))
        want = tfm.relu_masks(x, ws, bs, skips)
    got = cs.saved_masks(saved, n, h, layers, hh if head else 0)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kernel_flips,ok", [(33, True), (49, True), (50, False)])
def test_chip_smoke_fused_ok_holds_the_forwards_mask_flips(kernel_flips, ok):
    """chip_smoke.fused_ok fails a forward whose ReLU masks disagree with
    float64's more often than FUSED_PLAIN_FACTOR times the float32 plain
    forward's, plus FUSED_FLIP_SLACK (30 plain flips: at most 49), however
    close its backward is on those masks."""
    cs = _load_chip_smoke()
    result = {"fwd": 1e-7, "fwd_diff": 1e-7, "same_bits": True, "worst": 0.0, "rows": {"dx": 1.0},
              "grads": {"W0": (1e-6, 1e-3, 1e-3, 1e-3)},
              "flips": {"kernel vs float64": kernel_flips, "float32 plain vs float64": 30,
                        "kernel vs float32 plain": 40}}
    assert cs.fused_ok(result) is ok


def _tf32_split(a):
    """(hi, lo) of float32 a as the forward kernel splits it (split_tf32 in
    csrc/fused_mlp.cu): hi rounded to TF32's 10 mantissa bits on the bits,
    lo = a - hi, and the tensor cores read only lo's top 19 bits."""
    bits = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def as_float(b):
        return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)

    hi = as_float((bits + 0x1000) & 0xFFFFE000)
    lo = a - hi
    lo_bits = lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return hi, as_float(lo_bits & 0xFFFFE000)


def _emulated_field(x, de, ws, bs, head, skips, passes):
    """The NeRF field with every product of the kernel's chain (trunk, il,
    the colour layer) taken as its TF32 passes, summed in float64 and
    rounded to float32 per layer; the density and rgb dot products, which
    the kernel sums on the CUDA cores, in float64."""
    def product(a, w):
        (ah, al), (wh, wl) = _tf32_split(a), _tf32_split(w)
        terms = [(ah, wh)] if passes == 1 else [(al, wh), (ah, wl), (ah, wh)]
        return sum(p.double() @ q.double() for p, q in terms)

    y = x
    for li, (w, b) in enumerate(zip(ws, bs)):
        a = torch.cat([y, x], dim=-1) if li in skips else y
        y = torch.relu(product(a, w) + b.double()).float()
    wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2 = head
    il = (product(y, wi) + bi.double()).float()
    h = torch.relu(product(torch.cat([il, de], -1), torch.cat([wc1a, wc1b], 0)) + bc1.double())
    return torch.cat([y.double() @ wd.double() + bd.double(), h @ wc2.double() + bc2.double()], dim=-1)


def test_forward_three_tf32_passes_meet_the_forward_gate_and_one_does_not():
    """The forward kernel's arithmetic on the CPU at the NeRF widths (8 x 256,
    skip 5, head 128): three TF32 passes per product stay within the chip
    check's FUSED_FWD_GATE of the float64 field; one pass is off by more."""
    cs = _load_chip_smoke()
    rng = np.random.RandomState(7)
    n, d, h, layers, skips, ddir, hh = 512, 39, 256, 8, (5,), 27, 128

    def dense(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return (torch.tensor(rng.uniform(-lim, lim, (i, o)).astype(np.float32)),
                torch.tensor((rng.randn(o) * 0.05).astype(np.float32)))

    x = torch.tensor(rng.uniform(-1, 1, (n, d)).astype(np.float32))
    de = torch.tensor(rng.uniform(-1, 1, (n, ddir)).astype(np.float32))
    ws, bs = zip(*[dense((d if li == 0 else h) + (d if li in skips else 0), h) for li in range(layers)])
    (wd, bd), (wi, bi), (wc1, bc1), (wc2, bc2) = dense(h, 1), dense(h, h), dense(h + ddir, hh), dense(hh, 3)
    head = (wd, bd, wi, bi, wc1[:h], wc1[h:], bc1, wc2, bc2)
    want = tfm.fused_nerf_field_plain(x.double(), de.double(), [w.double() for w in ws], [b.double() for b in bs],
                                      [t.double() for t in head], skips)
    scale = float(want.abs().max())
    three = float((_emulated_field(x, de, ws, bs, head, skips, 3) - want).abs().max()) / scale
    one = float((_emulated_field(x, de, ws, bs, head, skips, 1) - want).abs().max()) / scale
    assert three <= cs.FUSED_FWD_GATE < one, (three, one)
