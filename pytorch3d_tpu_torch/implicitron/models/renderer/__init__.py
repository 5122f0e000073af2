"""Implicitron renderers (port of
pytorch3d_tpu/implicitron/models/renderer): the multi-pass EA renderer,
its raymarchers, refiner and ray samplers."""
from .base import BaseRenderer, EvaluationMode, ImplicitronRayBundle, RendererOutput, RenderSamplingMode
from .multipass_ea import MultiPassEmissionAbsorptionRenderer
from .ray_point_refiner import RayPointRefiner
from .ray_sampler import AdaptiveRaySampler, NearFarRaySampler, RaySamplerBase
from .raymarcher import CumsumRaymarcher, EmissionAbsorptionRaymarcher

__all__ = [k for k in dir() if not k.startswith("_")]
