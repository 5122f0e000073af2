"""Fused ReLU MLP with input skips and the fused NeRF field (port of
pytorch3d_tpu/ops/fused_mlp_pallas.py).

Four TPU kernels become one CUDA source, `csrc/fused_mlp.cu`, whose header
says what bounds it on an H100 and how its design answers that:

- #10 `_fwd_kernel` (fused_mlp_pallas.py:70) -> `fused_mlp_cuda`, the trunk;
- #11 `_bwd_kernel` (:79) -> `fused_mlp_grad_cuda`, its backward;
- #12 `_nerf_fwd_kernel` (:328) -> `nerf_field_cuda`, the trunk with the
  density head and the view-conditioned colour head, returning
  (N, 4) = [raw density, rgb logits];
- #13 `_nerf_bwd_kernel` (:341) -> `nerf_field_grad_cuda`, its backward.

The forward is warp-specialised `wgmma` on the tensor cores: per call a
prep launch packs the weights into TF32 hi/lo tiles, then a persistent
kernel streams them through a shared-memory ring to two warpgroups of 64
rows each, which keep every layer's activations in the threads that
computed them; each product is three TF32 passes with a fresh accumulator
tile every 16 input features, as accurate as float32.  The backward runs
the same three passes as `mma.sync`.

Each wrapper launches its kernel for CUDA tensors (and counts the launch in
its `launches`) and runs the plain PyTorch version for CPU tensors:
`fused_mlp_plain`, `fused_nerf_field_plain` (mirrors of the JAX
`*_reference` oracles at :274, :603, :623) and the explicit reverses
`fused_mlp_grad_plain`, `fused_nerf_field_grad_plain`, which write out what
the Pallas backward kernels compute.  `fused_mlp` and `fused_nerf_field` are
differentiable: `torch.autograd.Function`s whose backward is the backward
kernel.  Under autograd the CUDA forward stores the activations the backward
reads (`save=True`), so the backward does not recompute them; a backward
wrapper called without them runs that saving forward first, inside its own
launch (counted in `_backward.forwards_run`, not as a forward launch).  One
launch of a forward wrapper runs two CUDA kernels (the weights' packing,
the chain), one of a backward wrapper four (the weights' packing, the row
chain, the weight-gradient products, the sum of their splits); each counts
once.

The kernels take float32, contiguous tensors, hidden, direction and colour
widths up to 256, inputs x as wide as the forward's shared memory allows
(`input_limit`: 552 at the NeRF widths, H 256 and Ddir 27, on an H100) and
up to 12 trunk layers; they raise on anything else.  Layer 0 cannot be a
skip layer (as in the Pallas kernel).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import _build

MAX_WIDTH = 256  # widest H, Hh and Ddir the kernels take (one column tile)
MAX_LAYERS = 12
_ERRORS = {
    -1: "a shape the kernel does not take",
    -2: "more shared memory than the card gives a block (input or hidden width too large)",
}


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #


def _trunk_chain(x, weights, biases, skips):
    """(y, inputs, outputs): the last output and every layer's input and
    (ReLU'd) output."""
    y, inputs, outputs = x, [], []
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li in skips:
            y = torch.cat([y, x], dim=-1)
        inputs.append(y)
        y = torch.relu(y @ w + b)
        outputs.append(y)
    return y, inputs, outputs


def fused_mlp_plain(x, weights, biases, skips) -> torch.Tensor:
    """relu-MLP with the input x concatenated after the hidden features at
    each layer in `skips`: (N, D) -> (N, H)."""
    return _trunk_chain(x, weights, biases, skips)[0]


def _head_chain(y, d_embed, head):
    wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2 = head
    raw_d = y @ wd + bd
    il = y @ wi + bi
    h = torch.relu(il @ wc1a + d_embed @ wc1b + bc1)
    rgb = h @ wc2 + bc2
    return torch.cat([raw_d, rgb], dim=-1), il, h


def fused_head_plain(y, d_embed, head) -> torch.Tensor:
    """The NeRF head on trunk features y (N, H) and embedded directions
    d_embed (N, Ddir): (N, 4) = [y wd + bd, relu([y wi + bi, d_embed] Wc1 +
    bc1) wc2 + bc2]; head = (wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2)."""
    return _head_chain(y, d_embed, head)[0]


def fused_nerf_field_plain(x, d_embed, weights, biases, head, skips) -> torch.Tensor:
    """Trunk then head: (N, 4) [raw density, rgb logits]."""
    return fused_head_plain(fused_mlp_plain(x, weights, biases, skips), d_embed, head)


def _trunk_reverse(x, weights, inputs, masks, skips, g):
    """dx, dW and db of the trunk from the gradient g of its last output."""
    D = x.shape[-1]
    dx = torch.zeros_like(x)
    dws: List[torch.Tensor] = [None] * len(weights)
    dbs: List[torch.Tensor] = [None] * len(weights)
    for li in range(len(weights) - 1, -1, -1):
        g = torch.where(masks[li], g, 0.0)
        dws[li] = inputs[li].T @ g
        dbs[li] = g.sum(dim=0)
        g = g @ weights[li].T
        if li in skips:
            dx = dx + g[:, -D:]
            g = g[:, :-D]
    return dx + g, dws, dbs


def relu_masks(x, weights, biases, skips, d_embed=None, head=None) -> List[torch.Tensor]:
    """Where each ReLU of the plain forward passes its input: one (N, H)
    mask per trunk layer, then (with a head) the colour layer's (N, Hh)."""
    y, _, outputs = _trunk_chain(x, weights, biases, skips)
    masks = [o > 0 for o in outputs]
    if head is not None:
        masks.append(_head_chain(y, d_embed, head)[2] > 0)
    return masks


def fused_mlp_grad_plain(x, weights, biases, skips, g, masks=None):
    """(dx, [dW], [db]) of `fused_mlp_plain` for the output gradient g
    (N, H): the reverse `_bwd_kernel` computes, written out.  `masks`
    (from `relu_masks`) replaces this forward's own ReLU masks, so a float64
    evaluation can take a float32 forward's."""
    _, inputs, outputs = _trunk_chain(x, weights, biases, skips)
    masks = [o > 0 for o in outputs] if masks is None else masks
    return _trunk_reverse(x, weights, inputs, masks, skips, g)


def fused_nerf_field_grad_plain(x, d_embed, weights, biases, head, skips, g, masks=None):
    """(dx, d d_embed, [dW], [db], head gradients in head order) of
    `fused_nerf_field_plain` for the output gradient g (N, 4): the reverse
    `_nerf_bwd_kernel` computes, written out.  `masks` as in
    `fused_mlp_grad_plain`, the colour layer's last."""
    wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2 = head
    y, inputs, outputs = _trunk_chain(x, weights, biases, skips)
    _, il, h = _head_chain(y, d_embed, head)
    if masks is None:
        masks = [o > 0 for o in outputs] + [h > 0]
    g_d, g_rgb = g[:, :1], g[:, 1:]
    gh = torch.where(masks[-1], g_rgb @ wc2.T, 0.0)
    gil = gh @ wc1a.T
    d_head = (
        y.T @ g_d, g_d.sum(dim=0), y.T @ gil, gil.sum(dim=0), il.T @ gh, d_embed.T @ gh,
        gh.sum(dim=0), h.T @ g_rgb, g_rgb.sum(dim=0),
    )
    dde = gh @ wc1b.T
    dx, dws, dbs = _trunk_reverse(x, weights, inputs, masks, skips, gil @ wi.T + g_d @ wd.T)
    return dx, dde, dws, dbs, d_head


# --------------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------------- #


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    if not lib.fused_mlp_forward.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.fused_mlp_forward, lib.fused_mlp_backward):
            fn.argtypes = [p, p, i, ll]
            fn.restype = i
        lib.fused_mlp_workspace.argtypes = [p, i, p, p, p]
        lib.fused_mlp_workspace.restype = i
        lib.fused_mlp_input_limit.argtypes = [i, i, i]
        lib.fused_mlp_input_limit.restype = i
    return lib


def _raise_on(err: int, what: str) -> None:
    if err in _ERRORS:
        raise ValueError(f"{what}: {_ERRORS[err]}")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check(what: str, x: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on a CUDA device, got {x.device}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{what}: every tensor must lie on {x.device}, got one on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")


def _trunk_dims(what, x, weights, biases, skips) -> Tuple[int, int, int, int]:
    """(N, D, H, skip bit mask), after checking every trunk shape."""
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    L = len(weights)
    if not 1 <= L <= MAX_LAYERS or len(biases) != L:
        raise ValueError(f"{what}: 1..{MAX_LAYERS} layers with one bias each, got {L} and {len(biases)}")
    if 0 in skips:
        raise ValueError(f"{what}: layer 0 cannot concatenate the input again")
    H = weights[0].shape[-1]
    if not 1 <= H <= MAX_WIDTH or D < 1:
        raise ValueError(f"{what}: the kernel takes H in 1..{MAX_WIDTH} and D >= 1, got D={D}, H={H}")
    for li, (w, b) in enumerate(zip(weights, biases)):
        kin = (D if li == 0 else H) + (D if li in skips else 0)
        if tuple(w.shape) != (kin, H) or tuple(b.shape) != (H,):
            raise ValueError(f"{what}: layer {li} must be ({kin}, {H}) and ({H},), got {tuple(w.shape)}, {tuple(b.shape)}")
    return N, D, H, sum(1 << li for li in skips if li < L)


def _head_dims(what, d_embed, head, N, H) -> Tuple[int, int]:
    if d_embed.ndim != 2 or d_embed.shape[0] != N:
        raise ValueError(f"{what}: d_embed must be ({N}, Ddir), got {tuple(d_embed.shape)}")
    Ddir = d_embed.shape[1]
    if len(head) != 9:
        raise ValueError(f"{what}: the head is 9 tensors (wd, bd, wi, bi, wc1a, wc1b, bc1, wc2, bc2)")
    Hh = head[4].shape[-1]
    want = [(H, 1), (1,), (H, H), (H,), (H, Hh), (Ddir, Hh), (Hh,), (Hh, 3), (3,)]
    got = [tuple(t.shape) for t in head]
    if got != want:
        raise ValueError(f"{what}: head shapes must be {want}, got {got}")
    if not 1 <= Hh <= MAX_WIDTH or not 1 <= Ddir <= MAX_WIDTH:
        raise ValueError(f"{what}: the kernel takes Ddir and Hh in 1..{MAX_WIDTH}, got Ddir={Ddir}, Hh={Hh}")
    return Ddir, Hh


def input_limit(H: int, Ddir: int = 0) -> int:
    """The widest input x the kernels take on the current card beside hidden
    width H and Ddir direction features (0: no head): what the forward's
    shared memory holds with one consumer warpgroup (`input_limit` in
    csrc/fused_mlp.cu, which refuses wider inputs with -2 before any
    launch).  Builds the library on first use."""
    return _library().fused_mlp_input_limit(H, Ddir, int(Ddir > 0))


def _c_dims(N, D, Ddir, H, Hh, L, skip_bits):
    return (ctypes.c_int * 7)(N, D, Ddir, H, Hh, L, skip_bits)


def _c_ptrs(tensors):
    return (ctypes.c_longlong * len(tensors))(*[0 if t is None else t.data_ptr() for t in tensors])


def _workspace(what, lib, dims, head) -> Tuple[int, int, int]:
    """Floats of (saved activations, backward scratch, the forward's packed
    weight tiles) for these shapes."""
    sizes = [ctypes.c_longlong(0) for _ in range(3)]
    err = lib.fused_mlp_workspace(dims, int(head), *(ctypes.byref(v) for v in sizes))
    if err == -2:
        D, Ddir, H = dims[1], dims[2], dims[3]
        raise ValueError(f"{what}: an input of {D} features does not fit the forward's shared memory beside"
                         f" H={H} and Ddir={Ddir} (at most {lib.fused_mlp_input_limit(H, Ddir, int(head))})")
    _raise_on(err, what)
    return tuple(v.value for v in sizes)


def _forward(what, x, d_embed, weights, biases, head, skips, save=False):
    """out, or (out, saved) with save: the saving forward also stores every
    trunk layer's output (the trunk's last is out itself) and, with the
    head, il and the colour hidden h, in one flat tensor for the backward.
    The launch packs the weights into a scratch first (its own kernel)."""
    N, D, H, skip_bits = _trunk_dims(what, x, weights, biases, skips)
    Ddir = Hh = 0
    if head is not None:
        Ddir, Hh = _head_dims(what, d_embed, head, N, H)
    tensors = [x, *weights, *biases] + ([d_embed, *head] if head is not None else [])
    _check(what, x, tensors)
    lib = _library()
    dims = _c_dims(N, D, Ddir, H, Hh, len(weights), skip_bits)
    saved_n, _, packed_n = _workspace(what, lib, dims, head is not None)
    saved = torch.empty(max(saved_n, 1), dtype=torch.float32, device=x.device) if save else None
    packed = torch.empty(packed_n, dtype=torch.float32, device=x.device)
    out = torch.empty((N, 4 if head is not None else H), dtype=torch.float32, device=x.device)
    ptrs = _c_ptrs([x, d_embed, out, saved, packed, *weights, *biases, *(head or ())])
    with torch.cuda.device(x.device):
        err = lib.fused_mlp_forward(ptrs, dims, int(head is not None), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, what)
    return (out, saved) if save else out


def _grad_shapes(D, H, Ddir, Hh, L, skips, head):
    """Shapes of the kernel's flat gradient: per layer dW then db, then the
    9 head gradients (the layout of `grad_layout` in csrc/fused_mlp.cu)."""
    shapes = []
    for li in range(L):
        shapes += [((D if li == 0 else H) + (D if li in skips else 0), H), (H,)]
    if head:
        shapes += [(H, 1), (1,), (H, H), (H,), (H, Hh), (Ddir, Hh), (Hh,), (Hh, 3), (3,)]
    return shapes


def _split(flat, shapes):
    views, off = [], 0
    for shape in shapes:
        n = int(torch.Size(shape).numel())
        views.append(flat[off : off + n].view(shape))
        off += n
    return views


def _backward(what, x, d_embed, weights, biases, head, skips, g, saved=None):
    """The backward launch on what the saving forward left, (out, saved);
    without it, that forward runs first (as part of this launch)."""
    N, D, H, skip_bits = _trunk_dims(what, x, weights, biases, skips)
    L = len(weights)
    Ddir = Hh = 0
    if head is not None:
        Ddir, Hh = _head_dims(what, d_embed, head, N, H)
    if tuple(g.shape) != (N, 4 if head is not None else H):
        raise ValueError(f"{what}: the output gradient has shape {tuple(g.shape)}")
    tensors = [x, g, *weights, *biases] + ([d_embed, *head] if head is not None else [])
    _check(what, x, tensors)
    if saved is None:
        saved = _forward(what, x, d_embed, weights, biases, head, skips, save=True)
        _backward.forwards_run += 1
    out, acts = saved
    lib = _library()
    dims = _c_dims(N, D, Ddir, H, Hh, L, skip_bits)
    saved_n, scratch_n, _ = _workspace(what, lib, dims, head is not None)
    if acts.numel() < saved_n or tuple(out.shape) != (N, 4 if head is not None else H):
        raise ValueError(f"{what}: the saved tensors are not this forward's")
    dev = x.device
    scratch = torch.empty(scratch_n, dtype=torch.float32, device=dev)
    shapes = _grad_shapes(D, H, Ddir, Hh, L, skips, head is not None)
    flat = torch.empty(sum(torch.Size(s).numel() for s in shapes), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dde = torch.empty_like(d_embed) if head is not None else None
    ptrs = _c_ptrs([x, d_embed, g, dx, dde, flat, out, acts, scratch, *weights, *(head or ())])
    with torch.cuda.device(dev):
        err = lib.fused_mlp_backward(ptrs, dims, int(head is not None), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, what)
    views = _split(flat, shapes)
    dws, dbs = views[0 : 2 * L : 2], views[1 : 2 * L : 2]
    return dx, dde, dws, dbs, tuple(views[2 * L :])


_backward.forwards_run = 0  # saving forwards a backward launch had to run itself (none under autograd)


def fused_mlp_cuda(x, weights, biases, skips, save=False):
    """The trunk (N, H) from kernel #10 for CUDA tensors (counted in
    `fused_mlp_cuda.launches`), from `fused_mlp_plain` for CPU tensors.
    save (CUDA only): return (out, saved), what `fused_mlp_grad_cuda` reads."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights, biases, skips)
    out = _forward("fused_mlp_cuda", x, None, weights, biases, None, tuple(skips), save)
    fused_mlp_cuda.launches += 1
    return out


def fused_mlp_grad_cuda(x, weights, biases, skips, g, saved=None):
    """(dx, [dW], [db]) from kernel #11 for CUDA tensors (counted in
    `fused_mlp_grad_cuda.launches`), from `fused_mlp_grad_plain` for CPU
    tensors.  saved: the (out, saved) of `fused_mlp_cuda(..., save=True)` on
    the same inputs; without it the launch runs that forward first."""
    if x.device.type == "cpu":
        return fused_mlp_grad_plain(x, weights, biases, skips, g)
    dx, _, dws, dbs, _ = _backward("fused_mlp_grad_cuda", x, None, weights, biases, None, tuple(skips), g, saved)
    fused_mlp_grad_cuda.launches += 1
    return dx, dws, dbs


def nerf_field_cuda(x, d_embed, weights, biases, head, skips, save=False):
    """(N, 4) [raw density, rgb logits] from kernel #12 for CUDA tensors
    (counted in `nerf_field_cuda.launches`), from `fused_nerf_field_plain`
    for CPU tensors.  save as in `fused_mlp_cuda`."""
    if x.device.type == "cpu":
        return fused_nerf_field_plain(x, d_embed, weights, biases, head, skips)
    out = _forward("nerf_field_cuda", x, d_embed, weights, biases, tuple(head), tuple(skips), save)
    nerf_field_cuda.launches += 1
    return out


def nerf_field_grad_cuda(x, d_embed, weights, biases, head, skips, g, saved=None):
    """(dx, d d_embed, [dW], [db], head gradients) from kernel #13 for CUDA
    tensors (counted in `nerf_field_grad_cuda.launches`), from
    `fused_nerf_field_grad_plain` for CPU tensors.  saved as in
    `fused_mlp_grad_cuda`."""
    if x.device.type == "cpu":
        return fused_nerf_field_grad_plain(x, d_embed, weights, biases, head, skips, g)
    out = _backward("nerf_field_grad_cuda", x, d_embed, weights, biases, tuple(head), tuple(skips), g, saved)
    nerf_field_grad_cuda.launches += 1
    return out


for _wrapper in (fused_mlp_cuda, fused_mlp_grad_cuda, nerf_field_cuda, nerf_field_grad_cuda):
    _wrapper.launches = 0


# --------------------------------------------------------------------------- #
# Differentiable entry points
# --------------------------------------------------------------------------- #


def _keeps_saved(tensors) -> bool:
    """A CUDA forward whose gradient autograd will ask for stores its
    activations (asked before `apply`: inside it grad mode is off, and
    `needs_input_grad` ignores `torch.no_grad`)."""
    return (tensors[0].device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors))


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skips, n_layers, save, *params):
        ctx.skips, ctx.n_layers = skips, n_layers
        L = n_layers
        if not save:
            ctx.save_for_backward(x, *params)
            ctx.acts = None
            return fused_mlp_cuda(x, params[:L], params[L:], skips)
        out, ctx.acts = fused_mlp_cuda(x, params[:L], params[L:], skips, save=True)
        ctx.save_for_backward(x, out, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        L = ctx.n_layers
        if ctx.acts is None:
            x, *params = ctx.saved_tensors
            saved = None
        else:
            x, out, *params = ctx.saved_tensors
            saved = (out, ctx.acts)
        dx, dws, dbs = fused_mlp_grad_cuda(x, params[:L], params[L:], ctx.skips, g.contiguous(), saved=saved)
        ctx.acts = None
        return (dx, None, None, None, *dws, *dbs)


class _FusedNeRFField(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d_embed, skips, n_layers, save, *params):
        ctx.skips, ctx.n_layers = skips, n_layers
        L = n_layers
        args = (x, d_embed, params[:L], params[L : 2 * L], params[2 * L :], skips)
        if not save:
            ctx.save_for_backward(x, d_embed, *params)
            ctx.acts = None
            return nerf_field_cuda(*args)
        out, ctx.acts = nerf_field_cuda(*args, save=True)
        ctx.save_for_backward(x, d_embed, out, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        L = ctx.n_layers
        if ctx.acts is None:
            x, d_embed, *params = ctx.saved_tensors
            saved = None
        else:
            x, d_embed, out, *params = ctx.saved_tensors
            saved = (out, ctx.acts)
        dx, dde, dws, dbs, d_head = nerf_field_grad_cuda(
            x, d_embed, params[:L], params[L : 2 * L], params[2 * L :], ctx.skips, g.contiguous(), saved=saved
        )
        ctx.acts = None
        return (dx, dde, None, None, None, *dws, *dbs, *d_head)


def fused_mlp(x: torch.Tensor, weights, biases, skips) -> torch.Tensor:
    """Differentiable trunk: kernels #10/#11 on the card, the plain versions
    on the CPU.  x (N, D); weights[l] (in_l, H) with in_0 = D and in_l = H
    (+ D at the layers in `skips`); biases[l] (H,).  Returns (N, H)."""
    params = (*weights, *biases)
    return _FusedMLP.apply(x.contiguous(), tuple(skips), len(weights), _keeps_saved((x, *params)), *params)


def fused_nerf_field(x: torch.Tensor, d_embed: torch.Tensor, weights, biases, head, skips) -> torch.Tensor:
    """Differentiable NeRF field: kernels #12/#13 on the card, the plain
    versions on the CPU.  x (N, D) embedded points, d_embed (N, Ddir)
    embedded directions, the trunk as `fused_mlp`, head = (wd (H, 1), bd (1,),
    wi (H, H), bi (H,), wc1a (H, Hh), wc1b (Ddir, Hh), bc1 (Hh,), wc2 (Hh, 3),
    bc2 (3,)).  Returns (N, 4) [raw density, rgb logits]."""
    params = (*weights, *biases, *head)
    return _FusedNeRFField.apply(
        x.contiguous(), d_embed.contiguous(), tuple(skips), len(weights), _keeps_saved((x, d_embed, *params)), *params
    )
