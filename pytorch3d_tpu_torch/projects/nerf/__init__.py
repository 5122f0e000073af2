"""Train and evaluate a coarse + fine NeRF (port of projects/nerf):

    python -m pytorch3d_tpu_torch.projects.nerf.train_nerf --epochs 2
    python -m pytorch3d_tpu_torch.projects.nerf.test_nerf --mode evaluation

Both run on the card unless `--device cpu` is passed."""
