"""Implicit rendering (port of pytorch3d_tpu/renderer/implicit; the pieces
the NeRF model runs so far)."""
from .harmonic_embedding import HarmonicEmbedding
from .raysampling import MonteCarloRaysampler, MultinomialRaysampler, NDCMultinomialRaysampler
from .sample_pdf import sample_pdf, sample_pdf_with_draws
from .utils import RayBundle, ray_bundle_to_ray_points, ray_bundle_variables_to_ray_points

__all__ = [k for k in dir() if not k.startswith("_")]
