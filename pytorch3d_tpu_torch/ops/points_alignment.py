"""Point cloud similarity alignment: Umeyama and ICP (port of
pytorch3d_tpu/ops/points_alignment.py).

`iterative_closest_point` finds each point's nearest neighbour with
`knn_points` at K=1, which on the card runs the KNN kernel (#9,
`csrc/knn.cu`), and solves each step's alignment with
`corresponding_points_alignment` (an SVD of the 3x3 cross-covariance).  The
loop stops early when every cloud's relative RMSE change falls below the
threshold, as the JAX package's eager loop does; its traced `lax.scan`
branch has no counterpart here, where every call runs eagerly.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from .knn import knn_points
from .utils import convert_pointclouds_to_tensor, wmean


class SimilarityTransform(NamedTuple):
    R: torch.Tensor  # (N, 3, 3)
    T: torch.Tensor  # (N, 3)
    s: torch.Tensor  # (N,)


class ICPSolution(NamedTuple):
    converged: bool
    rmse: Optional[torch.Tensor]
    Xt: torch.Tensor
    RTs: SimilarityTransform
    t_history: List[SimilarityTransform]


def corresponding_points_alignment(
    X,
    Y,
    weights: Optional[torch.Tensor] = None,
    estimate_scale: bool = False,
    allow_reflection: bool = False,
    eps: float = 1e-9,
) -> SimilarityTransform:
    """Umeyama: argmin over (s, R, T) of ||s X R + T - Y|| (JAX
    points_alignment.py:34).

    X, Y: (N, P, D) tensors or Pointclouds.  Row-vector convention:
    aligned = s * X @ R + T.
    """
    Xt, num_points_X = convert_pointclouds_to_tensor(X)
    Yt, _ = convert_pointclouds_to_tensor(Y)
    if Xt.shape != Yt.shape:
        raise ValueError("Point sets X and Y have to have the same shape.")
    N, P, dim = Xt.shape
    if weights is not None and weights.shape != (N, P):
        raise ValueError("weights must be (N, P)")

    mask = (torch.arange(P, device=Xt.device)[None, :] < num_points_X.to(Xt.device)[:, None]).to(Xt.dtype)
    w = mask if weights is None else weights * mask

    Xmu = wmean(Xt, w, eps=eps)  # (N, 1, D)
    Ymu = wmean(Yt, w, eps=eps)
    Xc = Xt - Xmu
    Yc = Yt - Ymu

    total_weight = torch.clamp(w.sum(dim=1), min=eps)  # (N,)
    XYcov = torch.einsum("npi,npj->nij", Xc * w[..., None], Yc) / total_weight[:, None, None]

    U, S, Vt = torch.linalg.svd(XYcov)
    V = Vt.transpose(-1, -2)

    E = torch.ones((N, dim), dtype=Xt.dtype, device=Xt.device)
    if not allow_reflection:
        # det(U) det(V) < 0: flip the last singular vector
        E[:, -1] = torch.sign(torch.linalg.det(U) * torch.linalg.det(V))
    R = torch.einsum("nik,nk,njk->nij", U, E, V)  # U diag(E) V^T

    if estimate_scale:
        Xcov = (Xc * Xc * w[..., None]).sum(dim=(1, 2)) / total_weight
        s = (S * E).sum(dim=1) / torch.clamp(Xcov, min=eps)
    else:
        s = torch.ones((N,), dtype=Xt.dtype, device=Xt.device)

    T = Ymu[:, 0, :] - s[:, None] * torch.einsum("ni,nij->nj", Xmu[:, 0, :], R)
    return SimilarityTransform(R=R, T=T, s=s)


def _apply_similarity_transform(X, R, T, s):
    return s[:, None, None] * torch.einsum("npi,nij->npj", X, R) + T[:, None, :]


def iterative_closest_point(
    X,
    Y,
    init_transform: Optional[SimilarityTransform] = None,
    max_iterations: int = 100,
    relative_rmse_thr: float = 1e-6,
    estimate_scale: bool = False,
    allow_reflection: bool = False,
    verbose: bool = False,
) -> ICPSolution:
    """ICP aligning X to Y (JAX points_alignment.py:97).  Each iteration
    matches every point of the current X to its nearest point of Y, solves
    the similarity of those pairs and composes it into the total; the loop
    stops once no cloud's RMSE fell by more than `relative_rmse_thr` of its
    last value, or after `max_iterations`."""
    Xt, num_points_X = convert_pointclouds_to_tensor(X)
    Yt, num_points_Y = convert_pointclouds_to_tensor(Y)
    N, P, dim = Xt.shape
    mask_X = (torch.arange(P, device=Xt.device)[None, :] < num_points_X.to(Xt.device)[:, None]).to(Xt.dtype)

    if init_transform is not None:
        R, T, s = init_transform
        Xt_cur = _apply_similarity_transform(Xt, R, T, s)
    else:
        R = torch.eye(dim, dtype=Xt.dtype, device=Xt.device).expand(N, dim, dim)
        T = torch.zeros((N, dim), dtype=Xt.dtype, device=Xt.device)
        s = torch.ones((N,), dtype=Xt.dtype, device=Xt.device)
        Xt_cur = Xt

    prev_rmse = None
    rmse = None
    t_history = []
    converged = False
    for it in range(max_iterations):
        knn = knn_points(Xt_cur, Yt, lengths1=num_points_X, lengths2=num_points_Y, K=1, return_nn=True)
        Xt_nn = knn.knn[:, :, 0]  # (N, P, D)
        sim = corresponding_points_alignment(
            Xt_cur, Xt_nn, weights=mask_X, estimate_scale=estimate_scale, allow_reflection=allow_reflection,
        )
        # compose: the total transform of the original X
        Xt_cur = _apply_similarity_transform(Xt_cur, sim.R, sim.T, sim.s)
        R = torch.einsum("nij,njk->nik", R, sim.R)
        T = torch.einsum("ni,nij->nj", T, sim.R) * sim.s[:, None] + sim.T
        s = s * sim.s
        t_history.append(SimilarityTransform(R, T, s))

        rmse = torch.sqrt((knn.dists[..., 0] * mask_X).sum(dim=1) / torch.clamp(mask_X.sum(dim=1), min=1.0))
        if verbose:
            print(f"ICP iteration {it}: mean/max rmse = {float(rmse.mean()):1.2e}/{float(rmse.max()):1.2e}")
        if prev_rmse is not None:
            rel = (prev_rmse - rmse) / torch.clamp(prev_rmse, min=1e-12)
            if bool((rel <= relative_rmse_thr).all()):
                converged = True
                break
        prev_rmse = rmse

    return ICPSolution(converged, rmse, Xt_cur, SimilarityTransform(R, T, s), t_history)
