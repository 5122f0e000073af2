"""Implicitron renderers (port of
pytorch3d_tpu/implicitron/models/renderer): the multi-pass EA renderer,
its raymarchers, refiner and ray samplers, and the SDF renderer with its
ray tracer."""
from .base import BaseRenderer, EvaluationMode, ImplicitronRayBundle, RendererOutput, RenderSamplingMode
from .multipass_ea import MultiPassEmissionAbsorptionRenderer
from .ray_point_refiner import RayPointRefiner
from .ray_sampler import AdaptiveRaySampler, NearFarRaySampler, RaySamplerBase
from .ray_tracing import RayTracing
from .raymarcher import CumsumRaymarcher, EmissionAbsorptionRaymarcher
from .sdf_renderer import SignedDistanceFunctionRenderer

__all__ = [k for k in dir() if not k.startswith("_")]
