"""Project 3D points into source views and sample their features (port of
pytorch3d_tpu/implicitron/models/view_pooler/view_sampler.py).

Sampling is the port's `ndc_grid_sample` (the JAX package's grid-sample
arithmetic); the cameras are the port's, indexed like PyTorch3D's.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ....common import DEFAULT_DEVICE
from ....renderer.utils import ndc_grid_sample
from ...tools.config import Configurable

Device = Union[str, torch.device]


def handle_seq_id(seq_id, device: Device = DEFAULT_DEVICE) -> torch.Tensor:
    """Sequence ids (strings, ints, an array or a tensor) as an int64
    tensor; strings hash stably through crc32."""
    if isinstance(seq_id, torch.Tensor):
        return seq_id.to(device=device, dtype=torch.int64)
    if isinstance(seq_id, np.ndarray):
        return torch.as_tensor(seq_id, dtype=torch.int64, device=device)
    if len(seq_id) > 0 and isinstance(seq_id[0], str):
        seq_id = [zlib.crc32(s.encode("utf8")) for s in seq_id]
    return torch.tensor(list(seq_id), dtype=torch.int64, device=device)


def cameras_points_cartesian_product(camera, pts: torch.Tensor):
    """Every (camera, point batch) pair: each camera repeated once per point
    batch, the points tiled once per camera."""
    n_cameras = camera.R.shape[0]
    pts_batch = pts.shape[0]
    idx = torch.arange(n_cameras, device=pts.device).repeat_interleave(pts_batch)
    return camera[idx], pts.repeat((n_cameras,) + (1,) * (pts.ndim - 1))


def project_points_and_sample(
    pts: torch.Tensor,  # (pts_batch, n_pts, 3)
    feats: Dict[str, torch.Tensor],  # name -> (n_cameras, C, H, W)
    camera,
    masks: Optional[torch.Tensor],  # (n_cameras, 1, H, W) | None
    eps: float = 1e-2,
    sampling_mode: str = "bilinear",
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every point batch projected into every camera and the features
    sampled there: ({name: (pts_batch, n_cameras, n_pts, C)},
    (pts_batch, n_cameras, n_pts, 1))."""
    n_cameras = camera.R.shape[0]
    pts_batch = pts.shape[0]
    n_pts = tuple(pts.shape[1:-1])
    camera_rep, pts_rep = cameras_points_cartesian_product(camera, pts)
    proj_rep = camera_rep.transform_points(pts_rep.reshape(n_cameras * pts_batch, -1, 3), eps=eps)[..., :2]
    grid = proj_rep.reshape(n_cameras, pts_batch, -1, 2)

    def sample(f):
        s = ndc_grid_sample(f, grid, mode=sampling_mode)  # (V, C, B, P)
        return s.movedim(1, -1).transpose(0, 1).reshape((pts_batch, n_cameras) + n_pts + (-1,))

    feats_sampled = {k: sample(f) for k, f in feats.items()}
    if masks is not None:
        masks_sampled = sample(masks)
    else:
        masks_sampled = pts.new_ones((pts_batch, n_cameras) + n_pts + (1,))
    return feats_sampled, masks_sampled


@dataclasses.dataclass
class ViewSampler(Configurable):
    """Samples every source view's features at the projections of the
    points."""

    masked_sampling: bool = False
    sampling_mode: str = "bilinear"

    def __call__(
        self,
        pts: torch.Tensor,  # (B, P, 3) world points
        seq_id_pts,
        camera,  # the V source-view cameras
        seq_id_camera,
        feats: Dict[str, torch.Tensor],  # name -> (V, C, H, W)
        masks: Optional[torch.Tensor],  # (V, 1, H, W) | None
        **kwargs,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(sampled features name -> (V, P, C), sample masks (V, P, 1)),
        P every point of the batch."""
        V = camera.R.shape[0]
        flat = pts.reshape(1, -1, 3)
        proj = camera.transform_points(flat.expand(V, flat.shape[1], 3), eps=1e-4)[..., :2]
        sampled = {name: ndc_grid_sample(f, proj, mode=self.sampling_mode).movedim(1, -1)
                   for name, f in feats.items()}
        if masks is not None:
            sample_masks = ndc_grid_sample(masks, proj, mode=self.sampling_mode).movedim(1, -1)
        else:
            sample_masks = pts.new_ones(proj.shape[:-1] + (1,))
        return sampled, sample_masks
