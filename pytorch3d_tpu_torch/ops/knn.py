"""Batched exact K nearest neighbours (port of pytorch3d_tpu/ops/knn.py and
ops/knn_pallas.py).

`knn_points_cuda` replaces the TPU kernel `_knn_kernel`
(knn_pallas.py:36, its pallas_call at :135 in `knn_points_pallas_single`):
on CUDA tensors it launches the hand-written kernel `csrc/knn.cu`, whose
header says what bounds it on an H100; on CPU tensors it runs
`knn_points_plain`, the plain PyTorch version of the same function, which
the kernel is held against on the card.  Both sum distances directly over
the coordinates, sum((q - p)^2), as the Pallas kernel does, and break ties
to the lower database index.  The kernel cuts the database into the
ranges `knn_ranges` plans, walks each range in its own blocks and merges
the ranges' lists in range order, a tie to the earlier range.

`knn_points` dispatches as the JAX package does (knn.py:96-101): through
`knn_points_cuda` wherever the kernel takes the shape (D <= 8, K <= 16),
the plain version otherwise; the TPU's P1*P2 size gate is not carried over.
Its distances are differentiable through `_KNNDists`, whose backward is
plain torch: the JAX package has no backward kernel for KNN.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build

MAX_D = 8  # largest point dimension the kernel takes
MAX_K = 16  # largest K the kernel takes
_PLAIN_CHUNK_PAIRS = 1 << 24  # (query, point) pairs the plain version holds at once
MIN_RANGE = 128  # database points a range holds at least: two staged chunks
# Blocks the planner aims for per SM, by K bucket.  Each range restarts its
# K-deep list, and a warp runs the insertion whenever one lane's candidate
# enters, which happens ~32 K / j times a point j points into a range: deep
# lists want few long ranges, K = 1 as many blocks as fill the card.
WAVES = {1: 16, 2: 16, 4: 4, 8: 2, 16: 2}


class _KNN(NamedTuple):
    dists: torch.Tensor  # (N, P1, K)
    idx: torch.Tensor  # (N, P1, K) int64
    knn: Optional[torch.Tensor] = None  # (N, P1, K, D)


def _pair_dists(q: torch.Tensor, p: torch.Tensor, norm: int) -> torch.Tensor:
    """(N, Q, D) x (N, P, D) -> (N, Q, P), summed over D in order as the
    kernel sums."""
    dist = torch.zeros((q.shape[0], q.shape[1], p.shape[1]), dtype=q.dtype, device=q.device)
    for d in range(q.shape[2]):
        diff = q[:, :, None, d] - p[:, None, :, d]
        dist = dist + (diff.abs() if norm == 1 else diff * diff)
    return dist


def knn_points_plain(
    p1: torch.Tensor,  # (N, P1, D)
    p2: torch.Tensor,  # (N, P2, D)
    lengths2: Optional[torch.Tensor],  # (N,) or None
    K: int,
    norm: int = 2,
):
    """The plain PyTorch version of the kernel: (dists, idx) (N, P1, K),
    ascending, ties to the lower index (stable sort); slots no database
    point fills hold +inf and index 0, as the kernel's.  Queries go in
    chunks, so memory stays bounded at any size."""
    N, P1, _ = p1.shape
    P2 = p2.shape[1]
    live2 = None
    if lengths2 is not None:
        live2 = torch.arange(P2, device=p2.device)[None, None, :] < lengths2.to(p2.device)[:, None, None]
    step = max(1, _PLAIN_CHUNK_PAIRS // max(1, P2))
    dists, idx = [], []
    for s in range(0, P1, step):
        d = _pair_dists(p1[:, s : s + step], p2, norm)
        if live2 is not None:
            d = torch.where(live2, d, torch.inf)
        d, order = torch.sort(d, dim=-1, stable=True)
        d, order = d[..., :K], order[..., :K]
        dists.append(d)
        idx.append(torch.where(torch.isinf(d), 0, order))
    return torch.cat(dists, dim=1), torch.cat(idx, dim=1)


def k_bucket(K: int) -> int:
    """The kernel's template bucket for K (1, 2, 4, 8 or 16)."""
    return next(b for b in (1, 2, 4, 8, 16) if K <= b)


def knn_ranges(N: int, P1: int, P2: int, K: int, per_block: int, sms: int) -> Tuple[int, int]:
    """(S, L): the database [0, P2) cut into S contiguous ranges, range s
    [s * L, min((s + 1) * L, P2)) (the last one shorter, none empty), one
    grid row of blocks each, for a stage 1 whose blocks hold `per_block`
    queries on a card of `sms` SMs.

    S grows until the (N x query blocks x S) grid holds WAVES[bucket of K]
    blocks per SM, while every range keeps at least MIN_RANGE points (all of
    P2 where it is shorter); S = 1 walks the whole database in one pass,
    with no merge.
    """
    query_blocks = N * -(-P1 // per_block)
    S = max(1, min(-(-WAVES[k_bucket(K)] * sms // query_blocks), P2 // MIN_RANGE, 65535))
    L = -(-P2 // S)
    return -(-P2 // L), L


def _library() -> ctypes.CDLL:
    lib = _build.load("knn")
    if not lib.knn_points.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.knn_points.argtypes = [p, p, p] + [i] * 8 + [p] * 5
        lib.knn_points.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    """The card's streaming multiprocessors, for the range planner."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_ranges(N: int, P1: int, P2: int, K: int, device: torch.device) -> Tuple[int, int]:
    """The (S, L) cut the kernel runs on `device`: `knn_ranges` with the
    build's queries a block at K (`knn_block_queries`) and the card's SMs."""
    return knn_ranges(N, P1, P2, K, _library().knn_block_queries(K), _sms(device))


def knn_points_cuda(
    p1: torch.Tensor,  # (N, P1, D) float32, contiguous
    p2: torch.Tensor,  # (N, P2, D) float32, contiguous
    lengths2: Optional[torch.Tensor],  # (N,) or None
    K: int,
    norm: int = 2,
):
    """(dists, idx) (N, P1, K) from the kernel for CUDA tensors (one call,
    whether it runs one stage or two, counts one in
    `knn_points_cuda.launches`), from the plain version for CPU tensors.
    The kernel takes float32 contiguous clouds with D <= 8 and K <= 16;
    anything else raises."""
    if p1.device.type == "cpu":
        return knn_points_plain(p1, p2, lengths2, K, norm)
    if p1.device.type != "cuda" or p2.device != p1.device:
        raise ValueError(f"knn_points_cuda: clouds must lie on one CUDA device, got {p1.device}, {p2.device}")
    if p1.dtype != torch.float32 or p2.dtype != torch.float32:
        raise TypeError(f"knn_points_cuda: clouds must be float32, got {p1.dtype}, {p2.dtype}")
    if p1.ndim != 3 or p2.ndim != 3 or p1.shape[0] != p2.shape[0] or p1.shape[2] != p2.shape[2]:
        raise ValueError(f"knn_points_cuda: clouds must be (N, P, D), got {tuple(p1.shape)}, {tuple(p2.shape)}")
    if not (p1.is_contiguous() and p2.is_contiguous()):
        raise ValueError("knn_points_cuda: clouds must be contiguous")
    N, P1, D = p1.shape
    P2 = p2.shape[1]
    if not 1 <= D <= MAX_D:
        raise ValueError(f"knn_points_cuda: D={D} is outside the kernel's 1..{MAX_D}")
    if not 1 <= K <= min(MAX_K, P2):
        raise ValueError(f"knn_points_cuda: K={K} is outside the kernel's 1..min({MAX_K}, P2={P2})")
    if norm not in (1, 2):
        raise ValueError("knn_points_cuda: norm must be 1 or 2")
    dists = torch.empty((N, P1, K), dtype=torch.float32, device=p1.device)
    idx = torch.empty((N, P1, K), dtype=torch.int32, device=p1.device)
    if N == 0 or P1 == 0:
        return dists, idx.long()
    l2 = None if lengths2 is None else lengths2.to(device=p1.device, dtype=torch.int32).contiguous()
    lib = _library()
    S, L = kernel_ranges(N, P1, P2, K, p1.device)
    part_d = part_i = None
    if S > 1:  # stage 1's per-range lists, merged by stage 2
        part_d = torch.empty((N, S, P1, K), dtype=torch.float32, device=p1.device)
        part_i = torch.empty((N, S, P1, K), dtype=torch.int32, device=p1.device)
    with torch.cuda.device(p1.device):
        err = lib.knn_points(
            p1.data_ptr(), p2.data_ptr(), None if l2 is None else l2.data_ptr(),
            N, P1, P2, D, K, norm, S, L,
            None if part_d is None else part_d.data_ptr(), None if part_i is None else part_i.data_ptr(),
            dists.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(p1.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"knn launch failed: CUDA error {err}")
    knn_points_cuda.launches += 1
    return dists, idx.long()


knn_points_cuda.launches = 0


class _KNNDists(torch.autograd.Function):
    """Selection (kernel or plain version) with the zero-fill of
    knn.py:127-139; the backward sends each live distance's cotangent to
    both points: 2 (p1 - p2[idx]) for norm 2, sign(p1 - p2[idx]) for norm 1,
    the VJP of the JAX XLA path's distances."""

    @staticmethod
    def forward(ctx, p1, p2, lengths1, lengths2, K, norm):
        N, P1, D = p1.shape
        # knn_points_cuda itself takes the plain version for CPU tensors.
        select = knn_points_cuda if D <= MAX_D and 1 <= K <= MAX_K else knn_points_plain
        dists, idx = select(p1.detach().contiguous(), p2.detach().contiguous(), lengths2, K, norm)
        live = torch.isfinite(dists)
        if lengths1 is not None:
            live = live & (torch.arange(P1, device=p1.device)[None, :, None] < lengths1.to(p1.device)[:, None, None])
        if lengths2 is not None:
            live = live & (torch.arange(K, device=p1.device)[None, None, :] < lengths2.to(p1.device)[:, None, None])
        dists = torch.where(live, dists, 0.0)
        idx = torch.where(live, idx, 0)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(p1, p2, idx, live)
        ctx.norm = norm
        return dists, idx

    @staticmethod
    def backward(ctx, gdists, _gidx):
        p1, p2, idx, live = ctx.saved_tensors
        N, P2, D = p2.shape
        nn = knn_gather(p2.detach(), idx)  # (N, P1, K, D)
        diff = p1.detach()[:, :, None, :] - nn
        g = torch.where(live, gdists, 0.0)[..., None]
        g = g * (2.0 * diff if ctx.norm == 2 else torch.sign(diff))
        grad_p1 = g.sum(dim=2) if ctx.needs_input_grad[0] else None
        grad_p2 = None
        if ctx.needs_input_grad[1]:
            flat = (idx + (torch.arange(N, device=idx.device) * P2)[:, None, None]).reshape(-1)
            grad_p2 = torch.zeros((N * P2, D), dtype=g.dtype, device=g.device)
            grad_p2.index_add_(0, flat, -g.reshape(-1, D))
            grad_p2 = grad_p2.reshape(N, P2, D)
        return grad_p1, grad_p2, None, None, None, None


def knn_points(
    p1: torch.Tensor,
    p2: torch.Tensor,
    lengths1: Optional[torch.Tensor] = None,
    lengths2: Optional[torch.Tensor] = None,
    norm: int = 2,
    K: int = 1,
    version: int = -1,
    return_nn: bool = False,
    return_sorted: bool = True,
) -> _KNN:
    """K nearest neighbours of p1 in p2 (JAX knn.py:56).

    Args:
        p1: (N, P1, D) query points.
        p2: (N, P2, D) database points.
        lengths1/lengths2: (N,) valid counts (None = full).
        norm: 1 or 2; distances are squared L2 for norm 2.
        K: neighbours per query point (at most P2).
        version, return_sorted: accepted for API parity (always sorted).
        return_nn: also gather the neighbours' coordinates.

    CUDA tensors with D <= 8 and K <= 16 go through the kernel; other
    shapes, and CPU tensors, take the plain version.  Queries beyond
    lengths1, and slots k >= lengths2, report dist 0 and idx 0.
    Returns _KNN(dists (N, P1, K), idx (N, P1, K) int64, knn or None).
    """
    if p1.ndim != 3 or p2.ndim != 3:
        raise ValueError("p1 and p2 must be (N, P, D) tensors")
    if p1.shape[0] != p2.shape[0] or p1.shape[2] != p2.shape[2]:
        raise ValueError("p1 and p2 must agree on batch and feature dims")
    if norm not in (1, 2):
        raise ValueError("Only norm 1 or 2 is supported.")
    K = int(min(K, p2.shape[1]))
    dists, idx = _KNNDists.apply(p1, p2, lengths1, lengths2, K, norm)
    nn = knn_gather(p2, idx, lengths2) if return_nn else None
    return _KNN(dists=dists, idx=idx, knn=nn)


def knn_gather(
    x: torch.Tensor, idx: torch.Tensor, lengths: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Gather neighbour features: x (N, M, U), idx (N, L, K) -> (N, L, K, U)
    (JAX knn.py:185).  With `lengths`, slots k >= lengths[n] are zero."""
    N = x.shape[0]
    gathered = x[torch.arange(N, device=x.device)[:, None, None], idx]
    if lengths is not None:
        K = idx.shape[-1]
        mask = torch.arange(K, device=x.device)[None, None, :] < lengths.to(x.device)[:, None, None]
        gathered = torch.where(mask[..., None], gathered, 0.0)
    return gathered
