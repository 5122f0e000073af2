"""Implicit and volume rendering (port of pytorch3d_tpu/renderer/implicit):
ray sampling, raymarching, the harmonic embedding, `sample_pdf`, and the
implicit and volume renderers."""
from .harmonic_embedding import HarmonicEmbedding
from .raymarching import AbsorptionOnlyRaymarcher, EmissionAbsorptionRaymarcher
from .raysampling import (
    GridRaysampler,
    MonteCarloRaysampler,
    MultinomialRaysampler,
    NDCGridRaysampler,
    NDCMultinomialRaysampler,
)
from .renderer import ImplicitRenderer, VolumeRenderer, VolumeSampler
from .sample_pdf import sample_pdf, sample_pdf_python, sample_pdf_with_draws
from .utils import HeterogeneousRayBundle, RayBundle, ray_bundle_to_ray_points, ray_bundle_variables_to_ray_points

__all__ = [k for k in dir() if not k.startswith("_")]
