"""Align two camera batches by a similarity transform (port of
pytorch3d_tpu/ops/cameras_alignment.py; modes "centers" and
"extrinsics")."""

from __future__ import annotations

import torch

from .points_alignment import corresponding_points_alignment


def _align_camera_centers(cameras_src, cameras_tgt, estimate_scale=True, eps=1e-9):
    align_t = corresponding_points_alignment(
        cameras_src.get_camera_center()[None], cameras_tgt.get_camera_center()[None],
        estimate_scale=estimate_scale, allow_reflection=False, eps=eps,
    )
    # the cameras' transform is the inverse of the centres' one
    align_t_R = align_t.R.transpose(-1, -2)[0]
    align_t_T = -(align_t.T[0] @ align_t_R)
    return align_t_R, align_t_T, align_t.s[0]


def _align_camera_extrinsics(cameras_src, cameras_tgt, estimate_scale=True, eps=1e-9):
    # R_A solves R_A R_i = R_i' in the least-squares sense
    RRcov = torch.einsum("nij,nkj->nik", cameras_src.R, cameras_tgt.R).mean(dim=0)
    U, _, Vt = torch.linalg.svd(RRcov)
    align_t_R = Vt.T @ U.T

    A = torch.einsum("nij,nj->ni", cameras_src.R, cameras_src.T)
    B = torch.einsum("nij,nj->ni", cameras_src.R, cameras_tgt.T)
    Amu, Bmu = A.mean(dim=0), B.mean(dim=0)
    if estimate_scale:
        Ac, Bc = A - Amu, B - Bmu
        align_t_s = (Ac * Bc).sum() / torch.clamp((Ac * Ac).sum(), min=eps)
    else:
        align_t_s = torch.ones((), dtype=A.dtype, device=A.device)
    return align_t_R, Bmu - Amu * align_t_s, align_t_s


def corresponding_cameras_alignment(
    cameras_src,
    cameras_tgt,
    estimate_scale: bool = True,
    mode: str = "extrinsics",
    eps: float = 1e-9,
):
    """Estimate the similarity that aligns cameras_src to cameras_tgt (JAX
    cameras_alignment.py:54); returns the aligned copy of cameras_src."""
    if cameras_src.R.shape[0] != cameras_tgt.R.shape[0]:
        raise ValueError("cameras_src and cameras_tgt have to contain the same number of cameras!")
    if mode == "centers":
        align_fun = _align_camera_centers
    elif mode == "extrinsics":
        align_fun = _align_camera_extrinsics
    else:
        raise ValueError("mode has to be one of (centers, extrinsics)")
    align_t_R, align_t_T, align_t_s = align_fun(cameras_src, cameras_tgt, estimate_scale=estimate_scale, eps=eps)
    new_R = torch.einsum("ij,njk->nik", align_t_R, cameras_src.R)
    new_T = torch.einsum("i,nij->nj", align_t_T, cameras_src.R) + cameras_src.T * align_t_s
    return cameras_src.replace(R=new_R, T=new_T)
