"""Models (port of pytorch3d_tpu/models; the NeRF project's model)."""
from .nerf import MLPWithInputSkips, NeuralRadianceField, RadianceFieldRenderer

__all__ = [k for k in dir() if not k.startswith("_")]
