"""EPnP: camera pose from 2D-3D correspondences (port of
pytorch3d_tpu/ops/perspective_n_points.py, after Lepetit et al. 2009).

Batched `torch.linalg` (eigh, svd, solve); the three null-space-coordinate
candidates of the reference are computed and the one with the least
reprojection error is kept per batch element.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import torch

from .points_alignment import corresponding_points_alignment
from .utils import wmean


class EpnpSolution(NamedTuple):
    x_cam: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    err_2d: torch.Tensor
    err_3d: torch.Tensor


def _define_control_points(x, weight):
    """4 control points: the weighted centroid plus its principal directions."""
    x_mean = wmean(x, weight)  # (B, 1, 3)
    x_centered = x - x_mean
    xc = x_centered * weight[..., None] if weight is not None else x_centered
    cov = torch.einsum("bni,bnj->bij", xc, x_centered)
    _, e_vec = torch.linalg.eigh(cov)  # ascending
    return torch.cat([e_vec.transpose(-1, -2) + x_mean, x_mean], dim=-2)  # (B, 4, 3)


def _compute_alphas(x, c_world):
    """Barycentric coordinates of x with respect to the 4 control points:
    alphas [c; 1] = [x; 1]."""
    B, N, _ = x.shape
    x_h = torch.cat([x, torch.ones((B, N, 1), dtype=x.dtype, device=x.device)], dim=-1)  # (B, N, 4)
    c_h = torch.cat([c_world, torch.ones((B, 4, 1), dtype=x.dtype, device=x.device)], dim=-1)  # (B, 4, 4)
    return x_h @ torch.linalg.inv(c_h)  # (B, N, 4)


def _build_M(y, alphas, weight):
    """(B, 2N, 12) system matrix of the projection constraints."""
    B, N, _ = y.shape
    u, v = y[..., 0], y[..., 1]
    if weight is not None:
        alphas = alphas * weight[..., None]
    zeros = torch.zeros_like(alphas)
    row_u = torch.stack([alphas, zeros, -alphas * u[..., None]], dim=-1)  # (B, N, 4, 3)
    row_v = torch.stack([zeros, alphas, -alphas * v[..., None]], dim=-1)
    return torch.stack([row_u, row_v], dim=2).reshape(B, 2 * N, 12)


def _null_space(M, kernel_dim):
    """The smallest right singular vectors of M, ascending in singular
    value: (B, kernel_dim, 4, 3)."""
    _, _, Vt = torch.linalg.svd(M, full_matrices=True)
    null = Vt[:, -kernel_dim:].flip(1)
    return null.reshape(null.shape[0], kernel_dim, 4, 3)


_PAIRS = list(itertools.combinations(range(4), 2))


def _gen_pairs(t, reducer):
    """`reducer` over the 6 unordered pairs of dim -2."""
    return reducer(t[..., [i for i, _ in _PAIRS], :], t[..., [j for _, j in _PAIRS], :])


def _pair_dists(t):
    return _gen_pairs(t, lambda a, b: ((a - b) ** 2).sum(dim=-1))


def _kernel_vec_distances(v):
    """(B, 6, 10) pairwise-distance features of the kernel's control points
    v (B, 4, 4, 3): for each of the 6 control-point pairs, the dot products
    of the difference vectors across kernel dims, the off-diagonal doubled."""
    dv = _gen_pairs(v, lambda a, b: a - b).transpose(1, 2)  # (B, 6, k, 3)
    dots = torch.einsum("bpki,bpli->bpkl", dv, dv)  # (B, 6, k, k)
    k = dv.shape[-2]
    feats = [dots[..., i, j] if i == j else 2.0 * dots[..., i, j] for i in range(k) for j in range(i, k)]
    return torch.stack(feats, dim=-1)


def _solve_lstsq_subcols(rhs, lhs, cols):
    """Batched least squares on columns `cols` of lhs (normal equations)."""
    A = lhs[..., cols]  # (B, 6, k)
    AtA = torch.einsum("bnk,bnl->bkl", A, A)
    Atb = torch.einsum("bnk,bn->bk", A, rhs)
    AtA = AtA + 1e-9 * torch.eye(AtA.shape[-1], dtype=AtA.dtype, device=AtA.device)
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]


def _binary_sign(t):
    return torch.where(t >= 0, 1.0, -1.0).to(t.dtype)


# the columns of the 10 features for k = 4 (upper triangle, row-major)
_COL = {pair: c for c, pair in enumerate((i, j) for i in range(4) for j in range(i, 4))}


def _find_null_space_coords_1(kernel_dsts, cw_dst, eps=1e-9):
    """beta from {b00, b01, b02, b03}."""
    beta = _solve_lstsq_subcols(cw_dst, kernel_dsts, [_COL[(0, 0)], _COL[(0, 1)], _COL[(0, 2)], _COL[(0, 3)]])
    coord_0 = torch.sqrt(beta[:, :1].abs() + eps)
    return torch.cat([coord_0, beta[:, 1:] / torch.clamp(coord_0, min=eps)], dim=-1) * _binary_sign(beta[:, :1])


def _find_null_space_coords_2(kernel_dsts, cw_dst):
    """beta from {b00, b01, b11}."""
    beta = _solve_lstsq_subcols(cw_dst, kernel_dsts, [_COL[(0, 0)], _COL[(0, 1)], _COL[(1, 1)]])
    coord_0 = torch.sqrt(beta[:, :1].abs())
    coord_1 = torch.sqrt(beta[:, 2:3].abs()) * _binary_sign(beta[:, 1:2]) * _binary_sign(beta[:, :1])
    zeros = torch.zeros_like(coord_0)
    return torch.cat([coord_0, coord_1, zeros, zeros], dim=-1) * _binary_sign(beta[:, :1])


def _find_null_space_coords_3(kernel_dsts, cw_dst, eps=1e-9):
    """beta from {b00, b01, b11, b02, b12}."""
    beta = _solve_lstsq_subcols(
        cw_dst, kernel_dsts, [_COL[(0, 0)], _COL[(0, 1)], _COL[(1, 1)], _COL[(0, 2)], _COL[(1, 2)]]
    )
    coord_0 = torch.sqrt(beta[:, :1].abs() + eps)
    coord_1 = torch.sqrt(beta[:, 2:3].abs() + eps) * _binary_sign(beta[:, 1:2]) * _binary_sign(beta[:, :1])
    coord_2 = beta[:, 3:4] / torch.clamp(coord_0, min=eps)
    zeros = torch.zeros_like(coord_0)
    return torch.cat([coord_0, coord_1, coord_2, zeros], dim=-1) * _binary_sign(beta[:, :1])


def _reproj_error(y_hat, y, weight, eps=1e-9):
    ratio = y_hat[..., :2] / torch.where(y_hat[..., 2:].abs() > eps, y_hat[..., 2:], eps)
    err = torch.sqrt(((ratio - y) ** 2).sum(dim=-1) + eps)
    return wmean(err[..., None], weight)[..., 0, 0]


def _algebraic_error(x_w_rotated, x_cam, weight):
    err = torch.sqrt(((x_w_rotated - x_cam) ** 2).sum(dim=-1) + 1e-9)
    return wmean(err[..., None], weight)[..., 0, 0]


def _compute_norm_sign_scaling_factor(c_cam, alphas, x_world, weight, eps=1e-9):
    """Scale and sign the camera points: the world's scale, in front of the
    camera (+z)."""
    x_cam = alphas @ c_cam  # (B, N, 3)
    d_cam = torch.sqrt(((x_cam - wmean(x_cam, weight)) ** 2).sum(dim=-1) + eps)
    d_world = torch.sqrt(((x_world - wmean(x_world, weight)) ** 2).sum(dim=-1) + eps)
    scale = wmean((d_world / torch.clamp(d_cam, min=eps))[..., None], weight)[..., 0, 0]
    x_cam = x_cam * scale[:, None, None]
    behind = (x_cam[..., 2] < 0).to(x_cam.dtype)
    w = weight if weight is not None else torch.ones_like(behind)
    sign = torch.where((behind * w).sum(dim=-1) > 0.5 * w.sum(dim=-1), -1.0, 1.0).to(x_cam.dtype)
    return x_cam * sign[:, None, None]


def efficient_pnp(
    x: torch.Tensor,  # (B, N, 3) world points
    y: torch.Tensor,  # (B, N, 2) image points
    weights: Optional[torch.Tensor] = None,
    skip_quadratic_eq: bool = False,
) -> EpnpSolution:
    """EPnP pose estimation (JAX perspective_n_points.py:223).

    Camera convention: x_cam = x @ R + T, projection y = x_cam[:2] / x_cam[2].
    """
    c_world = _define_control_points(x, weights)
    alphas = _compute_alphas(x, c_world)
    M = _build_M(y, alphas, weights)
    kernel = _null_space(M, 4)  # (B, 4, 4, 3)
    kernel_dsts = _kernel_vec_distances(kernel)  # (B, 6, 10)
    cw_dst = _pair_dists(c_world)  # (B, 6)

    solvers = [_find_null_space_coords_1]
    if not skip_quadratic_eq:
        solvers += [_find_null_space_coords_2, _find_null_space_coords_3]

    solutions = []
    for solver in solvers:
        betas = solver(kernel_dsts, cw_dst)  # (B, 4)
        c_cam = torch.einsum("bk,bkij->bij", betas, kernel)  # (B, 4, 3)
        x_cam = _compute_norm_sign_scaling_factor(c_cam, alphas, x, weights)
        sim = corresponding_points_alignment(x, x_cam, weights=weights, estimate_scale=False)
        x_w_rotated = torch.einsum("bni,bij->bnj", x, sim.R) + sim.T[:, None]
        solutions.append(EpnpSolution(
            x_cam, sim.R, sim.T, _reproj_error(x_w_rotated, y, weights), _algebraic_error(x_w_rotated, x_cam, weights)
        ))
    if len(solutions) == 1:
        return solutions[0]
    best = torch.stack([s.err_2d for s in solutions]).argmin(dim=0)  # (B,)
    batch = torch.arange(best.shape[0], device=best.device)
    return EpnpSolution(*(torch.stack([s[i] for s in solutions])[best, batch] for i in range(5)))
