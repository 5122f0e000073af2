"""Evaluate a trained NeRF or export a video of it (port of projects/nerf/test_nerf.py).

Two modes, as the JAX script's:
- evaluation: full-image renders of the test split (`training=False`,
  deterministic), reported as the Stats mse_coarse, mse_fine, psnr_coarse
  and psnr_fine;
- export_video: render a circle of cameras fitted to the training cameras
  (`generate_eval_video_cameras`) and write the frames as a video.
The model's weights come from the last checkpoint of `--exp_dir`.  The
card runs it unless `--device cpu`.

    python -m pytorch3d_tpu_torch.projects.nerf.test_nerf --mode evaluation
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from ...implicitron.tools import model_io
from ...implicitron.tools.eval_video_trajectory import generate_eval_video_cameras
from ...implicitron.tools.stats import Stats
from ...implicitron.tools.video_writer import VideoWriter
from ...renderer.camera_utils import join_cameras_as_batch
from .dataset import get_nerf_datasets
from .train_nerf import build_model

EVAL_VARS = ["mse_coarse", "mse_fine", "psnr_coarse", "psnr_fine"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp_dir", default=os.path.join(tempfile.gettempdir(), "nerf_exp"))
    ap.add_argument("--mode", choices=["evaluation", "export_video"], default="evaluation")
    ap.add_argument("--dataset", default="rendered_sphere")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--n_rays", type=int, default=512)
    ap.add_argument("--n_pts", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--bg_white", action="store_true")
    ap.add_argument("--max_frames", type=int, default=0)
    # export_video options
    ap.add_argument("--trajectory_type", default="circular_lsq_fit")
    ap.add_argument("--trajectory_scale", type=float, default=1.1)
    ap.add_argument("--n_frames", type=int, default=40)
    ap.add_argument("--fps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="torch device (the card unless 'cpu')")
    return ap


@torch.no_grad()
def render_full(model, camera, image=None):
    """(rgb_fine (1, H*W, 3), metrics) of one full-image render at
    evaluation (`training=False`: the NDC grid, no jitter)."""
    out, metrics = model(camera, image=image, training=False)
    return out["rgb_fine"], metrics


def evaluate(model, frames) -> Stats:
    """Stats of the EVAL_VARS over `frames` (stat set "test"): each
    frame's value in the epoch-0 history, their mean in `avg`."""
    stats = Stats(log_vars=EVAL_VARS + ["sec/it"])
    stats.new_epoch()
    for frame in frames:
        _, metrics = render_full(model, frame.camera, frame.image)
        stats.update({k: float(v) for k, v in metrics.items()}, stat_set="test")
    return stats


def trajectory_frames(model, train, args) -> List[torch.Tensor]:
    """The export's (H, W, 3) frames: `args.n_frames` cameras on the circle
    fitted to the training cameras."""
    traj = generate_eval_video_cameras(
        join_cameras_as_batch([f.camera for f in train]),
        n_eval_cams=args.n_frames, trajectory_type=args.trajectory_type, trajectory_scale=args.trajectory_scale,
    )
    return [render_full(model, traj[i])[0].reshape(args.image_size, args.image_size, 3) for i in range(args.n_frames)]


def main(argv: Optional[List[str]] = None):
    """evaluation: {var: mean over the test frames}; export_video: the
    video's path."""
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    train, val, test = get_nerf_datasets(args.dataset, (args.image_size, args.image_size), args.data_root,
                                         device=device)
    model = build_model(args, device)
    last = model_io.find_last_checkpoint(args.exp_dir)
    if last is None:
        raise ValueError(f"No checkpoint found in {args.exp_dir}!")
    print(f"Loading checkpoint {last}.")
    model.load_state_dict(model_io.load_model(last, map_location=device)[0])

    if args.mode == "evaluation":
        stats = evaluate(model, test[: args.max_frames] if args.max_frames else test)
        stats.print(stat_set="test")
        return {k: m.avg for k, m in stats.stats["test"].items()}

    export_dir = os.path.join(args.exp_dir, "video")
    os.makedirs(export_dir, exist_ok=True)
    writer = VideoWriter(fps=args.fps, out_path=os.path.join(export_dir, "video.gif"))
    for frame in trajectory_frames(model, train, args):
        writer.write_frame(frame)
    path = writer.get_video()
    print(f"Wrote {path}")
    return path


if __name__ == "__main__":
    main()
