"""Implicitron tools (port of pytorch3d_tpu/implicitron/tools): the config
system, stats, checkpoints, circle fitting, evaluation trajectories,
video writing and image masking so far."""
from . import config, model_io, stats

__all__ = ["config", "model_io", "stats"]
