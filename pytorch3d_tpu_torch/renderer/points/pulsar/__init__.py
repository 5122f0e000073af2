"""Pulsar sphere renderer and its unified camera interface (port of
pytorch3d_tpu/renderer/points/pulsar)."""
from .renderer import Renderer
from .unified import PulsarPointsRenderer

__all__ = ["Renderer", "PulsarPointsRenderer"]
