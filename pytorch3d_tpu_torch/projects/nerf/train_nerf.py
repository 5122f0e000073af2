"""Train a coarse + fine NeRF (port of projects/nerf/train_nerf.py).

The same arguments and defaults as the JAX script, plus `--device` (the
card unless `--device cpu`): an epoch loop over the training views in a
`np.random.RandomState(epoch)` order, one `make_nerf_train_step` Adam step
per view, the validation PSNR on up to 4 held-out views after each epoch,
and a checkpoint per epoch (the previous one purged).  A run resumes from
the last checkpoint of `--exp_dir`: its weights, Adam state and Stats.  The
step's random draws come from one `torch.Generator` seeded 0 (the JAX
script splits `PRNGKey(0)`), the initial weights from one seeded 1.

    python -m pytorch3d_tpu_torch.projects.nerf.train_nerf --epochs 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ...implicitron.tools import model_io
from ...implicitron.tools.stats import Stats
from ...models import RadianceFieldRenderer
from ...parallel import get_device_mesh, make_nerf_train_step
from .dataset import get_nerf_datasets

INIT_SEED = 1
STEP_SEED = 0
VAL_SEED = 123


def build_model(args, device) -> RadianceFieldRenderer:
    """The script's RadianceFieldRenderer, its weights drawn from INIT_SEED."""
    return RadianceFieldRenderer(
        image_width=args.image_size,
        image_height=args.image_size,
        n_pts_per_ray=args.n_pts,
        n_pts_per_ray_fine=args.n_pts,
        n_rays_per_image=args.n_rays,
        min_depth=0.5,
        max_depth=6.0,
        n_hidden_neurons_xyz=args.hidden,
        n_hidden_neurons_dir=args.hidden // 2,
        n_layers_xyz=args.layers,
        append_xyz=(args.layers // 2,),
        bg_color=(1.0, 1.0, 1.0) if args.bg_white else (0.0, 0.0, 0.0),
        device=device,
        generator=torch.Generator(device=device).manual_seed(INIT_SEED),
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="rendered_sphere")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--n_rays", type=int, default=512)
    ap.add_argument("--n_pts", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--exp_dir", default=os.path.join(tempfile.gettempdir(), "nerf_exp"))
    ap.add_argument("--use_mesh", action="store_true", help="shard rays over the process group's ranks")
    ap.add_argument("--bg_white", action="store_true", help="composite empty rays onto white (blender-style)")
    ap.add_argument("--device", default="cuda", help="torch device (the card unless 'cpu')")
    return ap


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the model and optimizer after its last epoch,
    its Stats, the epoch it started at (after a resume, the checkpoint's
    epoch + 1) and the validation PSNR of each epoch it ran."""

    model: RadianceFieldRenderer
    optimizer: torch.optim.Optimizer
    stats: Stats
    start_epoch: int
    val_psnr: List[float]


def main(argv: Optional[List[str]] = None) -> TrainRun:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    train, val, test = get_nerf_datasets(
        args.dataset, (args.image_size, args.image_size), args.data_root, device=device
    )
    print(f"dataset: {len(train)} train / {len(val)} val / {len(test)} test")

    model = build_model(args, device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    mesh = get_device_mesh() if args.use_mesh else None
    step = make_nerf_train_step(model, optimizer, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(STEP_SEED)

    stats = Stats(log_vars=["loss", "psnr_fine", "sec/it"])
    start_epoch = 0
    last = model_io.find_last_checkpoint(args.exp_dir)
    if last is not None:
        model_state, optimizer_state, loaded = model_io.load_model(last, map_location=device)
        model.load_state_dict(model_state)
        optimizer.load_state_dict(optimizer_state)
        if loaded is not None:
            stats = loaded
        start_epoch = model_io.parse_epoch_from_model_path(last) + 1
        print(f"resumed from {last}")

    val_psnr = []
    for epoch in range(start_epoch, args.epochs):
        stats.new_epoch()
        for i in np.random.RandomState(epoch).permutation(len(train)):
            frame = train[int(i)]
            metrics = step(frame.camera, frame.image, generator=generator)
            stats.update({"loss": float(metrics["loss"]), "psnr_fine": float(metrics["psnr_fine"])}, stat_set="train")
        stats.print(stat_set="train")

        # Validation PSNR on held-out views (Monte Carlo rays, for speed).
        psnrs = []
        with torch.no_grad():
            for frame in val[: min(len(val), 4)]:
                _, m = model(frame.camera, image=frame.image, training=True,
                             generator=torch.Generator(device=device).manual_seed(VAL_SEED))
                psnrs.append(float(m["psnr_fine"]))
        val_psnr.append(float(np.mean(psnrs)))
        print(f"[val] epoch {epoch} psnr_fine {val_psnr[-1]:.2f}")

        model_io.safe_save_model(model.state_dict(), optimizer.state_dict(), stats, args.exp_dir, epoch)
        model_io.purge_epoch(args.exp_dir, epoch - 1)
    return TrainRun(model, optimizer, stats, start_epoch, val_psnr)


if __name__ == "__main__":
    main()
