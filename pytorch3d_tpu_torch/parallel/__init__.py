"""Training steps (port of pytorch3d_tpu/parallel; the single-device NeRF
step so far)."""
from .train import make_nerf_train_step

__all__ = [k for k in dir() if not k.startswith("_")]
