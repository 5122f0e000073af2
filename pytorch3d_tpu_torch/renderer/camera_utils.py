"""Camera manipulation helpers (port of pytorch3d_tpu/renderer/camera_utils.py)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from ..transforms import Transform3d


def camera_to_eye_at_up(world_to_view_transform: Transform3d) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(eye, at, up), each (N, 3), of world-to-view transforms: the inverse
    of `look_at_view_transform` (at is the point one unit in front of eye)."""
    cam_trans = world_to_view_transform.inverse()
    pts = torch.tensor(
        [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
        dtype=cam_trans.dtype, device=cam_trans.device,
    )[None]
    eye_at_up_world = cam_trans.transform_points(pts)  # (N, 3, 3)
    eye = eye_at_up_world[:, 0]
    return eye, eye_at_up_world[:, 1], eye_at_up_world[:, 2] - eye


def rotate_on_spot(R: torch.Tensor, T: torch.Tensor, rotation: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, T) of cameras turned in place by `rotation`: R (N, 3, 3), T (N,
    3), rotation (N, 3, 3) or (3, 3)."""
    if R.ndim == 2:
        R = R[None]
    if T.ndim == 1:
        T = T[None]
    if rotation.ndim == 2:
        rotation = rotation[None]
    new_R = R @ rotation.transpose(1, 2)
    old_RT = torch.sum(R * T[:, None, :], dim=-1)  # R T
    new_T = torch.sum(new_R * old_RT[:, :, None], dim=1)  # new_R^T (R T)
    return new_R, new_T


def join_cameras_as_batch(cameras_list: Sequence):
    """One camera batch from several of the same type: every tensor field
    concatenated along dim 0.  Cameras of different types, with different
    flags, or with a field set in some and not in others raise."""
    cam0 = cameras_list[0]
    if any(type(cam) is not type(cam0) for cam in cameras_list[1:]):
        raise ValueError("Cameras objects must be of the same type.")
    joined = {}
    for f in dataclasses.fields(cam0):
        values = [getattr(cam, f.name) for cam in cameras_list]
        tensors = [torch.is_tensor(v) for v in values]
        if all(tensors):
            joined[f.name] = torch.cat(values, dim=0)
        elif any(tensors):
            raise ValueError(f"Field {f.name} is set in some cameras and not in others.")
        elif any(v != values[0] for v in values[1:]):
            raise ValueError(f"Cameras differ in {f.name}: {values}.")
    return dataclasses.replace(cam0, **joined)
