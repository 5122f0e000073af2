"""Render a trained model along a circular fly-around trajectory (port of
pytorch3d_tpu/implicitron/models/visualization/render_flyaround.py): the
evaluation cameras fitted to the sequence's cameras, a frame per camera in
EVALUATION mode, the frames written through `VideoWriter`.

A view-pooled model (`view_pooler_enabled`) pools from source views: the
frames of the sequence at `n_source_views` evenly spaced indices, handed
to the model as `source_views` for every pose (the JAX function renders
without images, which a view-pooled model cannot).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ....renderer.camera_utils import join_cameras_as_batch
from ...tools.eval_video_trajectory import generate_eval_video_cameras
from ...tools.video_writer import VideoWriter
from ..renderer.base import EvaluationMode


def render_flyaround(
    dataset,
    sequence_name: Optional[str],
    model,
    output_video_path: str,
    n_flyaround_poses: int = 40,
    trajectory_type: str = "circular_lsq_fit",
    trajectory_scale: float = 1.1,
    fps: int = 20,
    visualize_preds_keys: Sequence[str] = ("images_render",),
    n_source_views: int = 9,
    **kwargs,
) -> str:
    """Render `n_flyaround_poses` views of `model` (a GenericModel) and
    write them as a video; returns the path written.  `dataset` indexes
    FrameData (image_rgb, camera, fg_probability, each with a batch of
    one); with `sequence_name`, its `sequence_indices_in_order(name)` picks
    the frames and the model renders that sequence (its global code)."""
    indices = list(dataset.sequence_indices_in_order(sequence_name) if sequence_name is not None
                   else range(len(dataset)))
    frames = [dataset[i] for i in indices]
    traj = generate_eval_video_cameras(
        join_cameras_as_batch([f.camera for f in frames]),
        n_eval_cams=n_flyaround_poses,
        trajectory_type=trajectory_type,
        trajectory_scale=trajectory_scale,
    )
    source_views = None
    if getattr(model, "view_pooler_enabled", False):
        picks = np.unique(np.linspace(0, len(frames) - 1, min(n_source_views, len(frames))).round().astype(int))
        src = [frames[i] for i in picks]
        source_views = {"image_rgb": torch.cat([f.image_rgb for f in src]),
                        "camera": join_cameras_as_batch([f.camera for f in src])}
        if all(f.fg_probability is not None for f in src):
            source_views["fg_probability"] = torch.cat([f.fg_probability for f in src])

    named = {} if sequence_name is None else {"sequence_name": [sequence_name]}
    os.makedirs(os.path.dirname(output_video_path) or ".", exist_ok=True)
    writer = VideoWriter(fps=fps, out_path=output_video_path)
    for i in range(n_flyaround_poses):
        with torch.no_grad():
            preds = model(camera=traj[i], evaluation_mode=EvaluationMode.EVALUATION, source_views=source_views,
                          **named)
        writer.write_frame(torch.cat([preds[k][0] for k in visualize_preds_keys], dim=1))
    return writer.get_video()
