"""Camera trajectories for evaluation videos (port of
pytorch3d_tpu/implicitron/tools/eval_video_trajectory.py): a circle fitted
to the training cameras' centres."""

from __future__ import annotations

from typing import Optional

import torch

from ...renderer import FoVPerspectiveCameras, look_at_view_transform
from .circle_fitting import angles_around, fit_circle_in_3d


def generate_eval_video_cameras(
    train_cameras,
    n_eval_cams: int = 100,
    trajectory_type: str = "circular_lsq_fit",
    trajectory_scale: float = 1.1,
    scene_center=(0.0, 0.0, 0.0),
    up=(0.0, 1.0, 0.0),
    focal_length: Optional[torch.Tensor] = None,
):
    """`n_eval_cams` FoV cameras on the circle fitted to the training
    cameras' centres, scaled about its centre by `trajectory_scale`, each
    looking at `scene_center`, on the training cameras' device."""
    centers = train_cameras.get_camera_center()  # (N, 3)
    device = centers.device
    if trajectory_type not in ("circular_lsq_fit", "simple_360"):
        raise ValueError(f"Unknown trajectory_type {trajectory_type}")
    up_t = torch.tensor(up, dtype=torch.float32, device=device)
    circle = fit_circle_in_3d(centers, angles=angles_around(n_eval_cams, centers), up=up_t)
    traj = circle.center + (circle.generated_points - circle.center) * trajectory_scale
    center = torch.tensor(scene_center, dtype=torch.float32, device=device)
    R, T = look_at_view_transform(eye=traj, at=center[None], up=up_t[None], device=device)
    return FoVPerspectiveCameras.create(R=R, T=T, device=device)
