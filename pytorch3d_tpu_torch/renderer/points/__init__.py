"""Point rendering (port of pytorch3d_tpu/renderer/points; pulsar not yet)."""
from .compositing import alpha_composite, norm_weighted_sum, weighted_sum
from .compositor import AlphaCompositor, NormWeightedCompositor
from .rasterize_points import rasterize_points
from .rasterizer import PointFragments, PointsRasterizationSettings, PointsRasterizer
from .renderer import PointsRenderer

__all__ = [k for k in dir() if not k.startswith("_")]
